"""ELL copy-sum A/B: S3 as one launch over all buckets against the
per-bucket S3 it replaced, and against variant builds of itself.

    python -m custom_op_benchmark_tpu_torch.experiments.ab_gather \
        --old OLD.cu [--variant NEW.cu ...]

``OLD.cu`` is the per-bucket ``csrc/gather_sum.cu``, copied out of git
under ``build/`` beforehand, so the run needs no ``.git``: ``git show
bad821e:custom_op_benchmark_tpu_torch/csrc/gather_sum.cu``. Its
``gather_sum_f32(cols, x, y, R, D, d, n_x, vec, device, stream)`` sums one
bucket. The old copy-sum is that kernel once per bucket and then the row
combine (``torch.cat`` of the bucket outputs and a gather through
``row_pos``), as ops/ell.py ran it; the new one is one launch of the
committed S3 over the packing's cached table.

On the power-law graph of the power-law suite (n = 131,072, 2M edges;
both ladders, both directions) and the arxiv configuration's training
ladder (both directions), at d = 128, the two are checked bit for bit and
timed by CUDA events over back-to-back calls (so host time between
launches counts), in turns (old, new, new, old; each a median of
repeats). Each ``--variant NEW.cu`` (an edited copy of the one-launch
``csrc/gather_sum.cu`` under ``build/``, with the same entry point) is
checked bit for bit against the committed S3 on the same packings, and on
the arxiv ones at d = 40 too, and timed against it in turns (committed,
variant, variant, committed). Then the arxiv GCN and GraphSAGE train
steps on the ELL path (``make_train_step``, AdamW), old against new in
the same turns: the old steps run the per-bucket copy-sum and, for the
mean, the degree as a width-1 per-bucket sweep on every call, as
ops/ell.py did; each step's S3 launches are counted. Prints one JSON line
``{"ab_gather": {...}}`` with the card's name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from custom_op_benchmark_tpu_torch import models
from custom_op_benchmark_tpu_torch.data import planted_partition
from custom_op_benchmark_tpu_torch.models import sage
from custom_op_benchmark_tpu_torch.ops import ell as ell_ops
from custom_op_benchmark_tpu_torch.ops import ell_dual
from custom_op_benchmark_tpu_torch.ops.ell import (
    _copy_agg_raw,
    _EllCopySum,
    ell_combine_rows,
)
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import gather_sum
from custom_op_benchmark_tpu_torch.ops.kernels import tiled_kernels as kt
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.bench_suite import powerlaw_case
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

D = 128
ARXIV = dict(num_classes=40, nodes_per_class=4000, feat_dim=128,
             avg_degree=13)
STEP_MODELS = {"GCN": dict(hidden_dim=128, num_layers=2),
               "GraphSAGE": dict(hidden_dim=128, num_layers=2)}
_P, _I = ctypes.c_void_p, ctypes.c_int


def load(source: Path, argtypes) -> ctypes.CDLL:
    """``source`` built on its own, its ``gather_sum_f32`` taking
    ``argtypes``."""
    so = _build.BUILD_DIR / f"ab_gather_{source.stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-shared", "-o", str(so), str(source)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.gather_sum_f32.argtypes = argtypes
    lib.gather_sum_f32.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def on_library(lib):
    """S3's wrapper launches ``lib``'s kernel: a variant build of the
    one-launch csrc/gather_sum.cu, with the same entry point."""
    real = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = real


def old_copy_sum(lib, eg, x, launches=None):
    """The per-bucket copy-sum: one old S3 launch per bucket, then the
    row combine. ``launches`` (a list) gets one entry a launch."""
    dev, stream = kt._stream(x)
    x = x.contiguous()
    outs = []
    for b in eg.buckets:
        y = torch.empty((b.num_rows, x.shape[1]), device=x.device)
        _build.check(lib.gather_sum_f32(
            kt._p(b.cols), kt._p(x), kt._p(y), b.num_rows, b.width,
            x.shape[1], x.shape[0], kt._vec(x.shape[1], x, y), dev, stream),
            "old gather_sum")
        outs.append(y)
        if launches is not None:
            launches.append(1)
    return ell_combine_rows(eg, outs)


@contextlib.contextmanager
def old_path(lib, launches):
    """Run the ELL copy-SpMM as before: the per-bucket copy-sum, and the
    mean's degree swept at width 1 on every call."""
    def copy_sum(eg, x):
        return old_copy_sum(lib, eg, x, launches)

    def copy_spmm(ell, ell_t, x, *, reduce="sum"):
        y = _EllCopySum.apply(ell, ell_t, x)
        if reduce == "sum":
            return y
        deg = copy_sum(ell, x.new_ones((ell.n_nodes, 1)))
        return y / deg.clamp(min=1)

    real = ell_ops._copy_agg_raw, sage.ell_copy_spmm
    ell_ops._copy_agg_raw, sage.ell_copy_spmm = copy_sum, copy_spmm
    try:
        yield
    finally:
        ell_ops._copy_agg_raw, sage.ell_copy_spmm = real


def step_ab(lib, ds, g, timing):
    """The arxiv GCN and GraphSAGE train steps on the ELL path, old copy-sum
    against new, with their S3 launches a step."""
    dev = g.device
    ell = ell_dual(g, profile="train")
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    out = {}
    for name, cfg in STEP_MODELS.items():
        model = getattr(models, name)(
            out_dim=ds.num_classes, in_dim=x.shape[1], **cfg,
            generator=torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, learning_rate=2e-3)
        step = make_train_step(apply_kwargs={"ell": ell})
        old_launches = []

        def run_old():
            with old_path(lib, old_launches):
                step(state, g, x, labels, mask)

        def run_new():
            step(state, g, x, labels, mask)

        def ms(fn):
            return statistics.median(time_cuda(fn, **timing)) * 1e3

        run_old()
        torch.cuda.synchronize()
        n_old, old_launches[:] = len(old_launches), []
        gather_sum.launches = 0
        run_new()
        torch.cuda.synchronize()
        n_new = gather_sum.launches
        o1 = ms(run_old)
        n1, n2 = ms(run_new), ms(run_new)
        o2 = ms(run_old)
        out[name] = dict(old_step_ms=(o1 + o2) / 2, new_step_ms=(n1 + n2) / 2,
                         old_ms_each=[o1, o2], new_ms_each=[n1, n2],
                         old_s3_launches=n_old, new_s3_launches=n_new)
        print(f"  arxiv {name} train step: {out[name]}", flush=True)
        del state, step, model
    return out


def compare(lib, eg, x, timing):
    old, new = old_copy_sum(lib, eg, x), _copy_agg_raw(eg, x)
    torch.cuda.synchronize()
    res = {"buckets": len(eg.buckets),
           "same_bits": bool(torch.equal(old, new)),
           "old_launches": len(eg.buckets) + 2, "new_launches": 1}
    del old, new

    def ms(fn):
        return statistics.median(time_cuda(fn, **timing)) * 1e3

    o1 = ms(lambda: old_copy_sum(lib, eg, x))
    n1, n2 = (ms(lambda: _copy_agg_raw(eg, x)) for _ in range(2))
    o2 = ms(lambda: old_copy_sum(lib, eg, x))
    res.update(old_ms=(o1 + o2) / 2, new_ms=(n1 + n2) / 2,
               old_ms_each=[o1, o2], new_ms_each=[n1, n2])
    print(f"  {eg.direction}: {res}", flush=True)
    return res


def compare_variants(variants, eg, x, timing):
    """The committed one-launch S3 against each variant build on one
    packing: same bits, and times in turns (committed, variant, variant,
    committed)."""
    new = _copy_agg_raw(eg, x)
    res = {}

    def ms(fn):
        return statistics.median(time_cuda(fn, **timing)) * 1e3

    def run(lib):
        with on_library(lib):
            return _copy_agg_raw(eg, x)

    for name, lib in variants.items():
        same = bool(torch.equal(run(lib), new))
        n1 = ms(lambda: _copy_agg_raw(eg, x))
        v1, v2 = (ms(lambda: run(lib)) for _ in range(2))
        n2 = ms(lambda: _copy_agg_raw(eg, x))
        res[name] = dict(same_bits=same, new_ms=(n1 + n2) / 2,
                         variant_ms=(v1 + v2) / 2)
        print(f"  {eg.direction} d={x.shape[1]} {name}: {res[name]}",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="the per-bucket gather_sum.cu")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="a variant build of the one-launch gather_sum.cu "
                    "(same entry point), timed against the committed one")
    args = ap.parse_args(argv)
    dev = cuda_device()
    lib = load(args.old, [_P] * 3 + [_I] * 6 + [_P])
    variants = {v.stem: load(v, _build._SIGNATURES["gather_sum_f32"])
                for v in args.variant}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi}
    timing = dict(warmup=3, iters=10, repeats=5)
    rng = np.random.default_rng(0)
    case = powerlaw_case(131072, 2_000_000, D, device=dev)
    packings = {"powerlaw pow2": (case.se, case.de),
                "powerlaw train": ell_dual(case.g, profile="train")}
    x = torch.from_numpy(rng.standard_normal((case.n, D),
                                             dtype=np.float32)).to(dev)
    for label, pair in packings.items():
        for eg in pair:
            out[f"{label} {eg.direction}"] = compare(lib, eg, x, timing)
            out[f"{label} {eg.direction} variants"] = compare_variants(
                variants, eg, x, timing)
    del case, packings, x
    ds = planted_partition(**ARXIV)
    g = ds.graph.to(dev)
    x = torch.from_numpy(rng.standard_normal((g.n_nodes, D),
                                             dtype=np.float32)).to(dev)
    x40 = x[:, :40].contiguous()
    for eg in ell_dual(g, profile="train"):
        out[f"arxiv train {eg.direction}"] = compare(lib, eg, x, timing)
        for xv in (x, x40):
            out[f"arxiv train {eg.direction} d={xv.shape[1]} variants"] = (
                compare_variants(variants, eg, xv, timing))
    out["arxiv steps"] = step_ab(lib, ds, g, timing)
    print(json.dumps({"ab_gather": out}), flush=True)
    checks = [r["same_bits"] for r in out.values()
              if isinstance(r, dict) and "same_bits" in r]
    checks += [v["same_bits"] for k, r in out.items()
               if k.endswith("variants") for v in r.values()]
    return 0 if all(checks) else 1


if __name__ == "__main__":
    sys.exit(main())
