"""S3 A/B: the committed S3 (csrc/gather_sum.cu) against its parent
build and against variant builds of itself.

    python -m custom_op_benchmark_tpu_torch.experiments.ab_gather \
        [--parent PARENT.cu] [--variant NEW.cu ...]

Each source is copied out of git under ``build/`` beforehand, so the run
needs no ``.git``.

``--parent``: a parent's ``csrc/gather_sum.cu`` (any commit from
``0babd0f`` on, whose ``gather_sum_*`` and ``csr_sum_*`` take the committed
arguments), with the ``csrc/ell_table.cuh`` of the same commit beside it
where it includes one: a quoted include resolves beside the source first,
then in the committed ``csrc/``. For the parent commit, say ``P``::

    mkdir -p build/ab/P
    for f in gather_sum.cu ell_table.cuh; do
      git show P:custom_op_benchmark_tpu_torch/csrc/$f > build/ab/P/$f
    done

Each build's entry points are bound with the committed signatures and
launched by the committed wrappers (S3's from the build, every other
entry point from the committed library; ``common.on_library``). At every
S3 row shape of PERF.md's kernel table, and at the hub shapes (the
power-law graph's ELL src table, whose widest bucket pads the 27,565-slot
hub to 32,768, and its src CSR rows, the sum of ``pl_spmm/xla_segment``'s
forward) and narrow widths, the two are timed in turns (parent, new,
new, parent; each a median of repeats of back-to-back calls by CUDA
events) and compared: rows that are neither split (more than PIECE
slots) nor padded (a slot outside x) bit for bit, the others within 1e-4
(bf16: 2⁻⁷·|parent| + 1e-4), the new results equal on a repeat, and each
hub row within 1e-4 relative of its f64 sum. The sampled shape and the
halo shape are synthetic stand-ins of the same sizes (the real ones take
minutes of host set-up; ``chip_smoke.py`` runs them): in_cols 70,656 x 32
with 127,457 real slots at the front of their rows, and 244,408 rows of
Poisson(40.9) identity slots at d = 64 beside ``torch.segment_reduce``.
Then the whole ``pl_spmm/xla_segment`` forward and the arxiv GCN and
GraphSAGE train steps on the ELL and on the segment path, parent against
new in the same turns.

``--variant NEW.cu`` (repeatable): an edited copy of the committed
``csrc/gather_sum.cu`` with the same entry points, timed against it in
turns (committed, variant, variant, committed) at the same shapes and
checked bit for bit against it.

Prints one JSON line ``{"ab_gather": {...}}`` with the card's name and
power limit; exits 1 if a check failed. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from custom_op_benchmark_tpu_torch import models
from custom_op_benchmark_tpu_torch.data import planted_partition
from custom_op_benchmark_tpu_torch.experiments import exp_pallas_gather
from custom_op_benchmark_tpu_torch.experiments.common import (
    load_builds,
    on_library,
)
from custom_op_benchmark_tpu_torch.graph.ell import PIECE, one_bucket_table
from custom_op_benchmark_tpu_torch.ops import ell_dual, vector_spmm, xla
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
    csr_sum,
    gather_sum,
)
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
S3_ENTRIES = ("gather_sum", "csr_sum")


class Library:
    """S3's entry points from ``lib``, every other entry point from the
    committed library."""

    def __init__(self, lib):
        self.lib, self.real = lib, _build.library()

    def __getattr__(self, name):
        s3 = name.rsplit("_", 1)[0] in S3_ENTRIES
        return getattr(self.lib if s3 else self.real, name)


def ms(fn, timing):
    return statistics.median(time_cuda(fn, **timing)) * 1e3


def within(got, want):
    """Within 1e-4 (bf16: one rounding, 2⁻⁷·|want| + 1e-4) elementwise."""
    g, w = got.float(), want.float()
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-4
    return bool(((g - w).abs() <= rtol * w.abs() + 1e-4).all())


def plain_rows(entry, args):
    """(rows neither split nor padded, the row with the most valid slots
    and those slots' rows of x) of S3's output on these arguments."""
    if entry is gather_sum:
        table, x = args
        n_x = x.shape[0]
        strict = torch.zeros(table.n_out, dtype=torch.bool, device=x.device)
        strict[table.zero_nodes.long()] = True
        hub, hub_rows, best = None, None, -1
        for off, w, first, rows in table.layout:
            c = table.cols[off: off + rows * w].reshape(rows, w)
            valid = (c >= 0) & (c < n_x)
            nodes = table.nodes[first: first + rows].long()
            if w <= PIECE:
                strict[nodes[valid.all(1)]] = True
            count = valid.sum(1)
            i = int(count.argmax()) if rows else 0
            if rows and int(count[i]) > best:
                best, hub = int(count[i]), int(nodes[i])
                hub_rows = c[i][valid[i]].long()
        return strict, hub, hub_rows
    ptr, x = args[:2]
    idx = args[2] if len(args) > 2 else None
    n_slots = x.shape[0] if idx is None else idx.numel()
    n_x = x.shape[0]
    p = ptr.long().clamp(max=n_slots)
    slots = torch.arange(n_slots, device=x.device)
    rows = slots if idx is None else idx.long()
    bad = torch.cat([torch.zeros(1, device=x.device, dtype=torch.long),
                     ((rows < 0) | (rows >= n_x)).long().cumsum(0)])
    length = p[1:] - p[:-1]
    strict = (length <= PIECE) & (bad[p[1:]] == bad[p[:-1]])
    hub = int(length.argmax())
    sel = rows[int(p[hub]): int(p[hub + 1])]
    return strict, hub, sel[(sel >= 0) & (sel < n_x)]


def hub_error(out, x, hub, hub_rows):
    """max |out[hub] − f64 sum| over max |f64 sum| for the hub row."""
    exact = x[hub_rows].double().sum(0).reshape(-1)
    got = out[hub].double().reshape(-1)
    return float((got - exact).abs().max() / exact.abs().max().clamp(
        min=1e-30))


def sampled_cols(rng, dev, rows=70_656, width=32, real=127_457):
    """in_cols of a sampled batch's size: ``real`` slots spread over the
    rows at random (at most ``width`` a row), each row's real slots first
    and naming random nodes, the rest the pad slot ``rows``."""
    counts = np.minimum(rng.multinomial(real, np.full(rows, 1 / rows)),
                        width)
    cols = np.full((rows, width), rows, dtype=np.int32)
    k = np.arange(width)[None, :] < counts[:, None]
    cols[k] = rng.integers(0, rows, size=int(k.sum()), dtype=np.int32)
    return torch.from_numpy(cols).to(dev)


def halo_like(rng, dev, rows=244_408, d=64):
    """Identity slots over ``rows`` rows of Poisson(40.9) slots (the halo
    plan's dst_loc segments at the products configuration: 244,408 rows,
    9,994,432 slots), x (slots, d)."""
    lengths = rng.poisson(9_994_432 / rows, size=rows)
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]).astype(
        np.int32)).to(dev)
    x = torch.from_numpy(rng.standard_normal(
        (int(lengths.sum()), d), dtype=np.float32)).to(dev)
    return ptr, x


def s3_shapes(dev, case, arxiv_g):
    """{label: (entry, args)}: S3's rows in PERF.md's kernel table, the two
    hub shapes and narrow widths."""
    rng = np.random.default_rng(1)
    cols, x = exp_pallas_gather.inputs(dev)
    exp = one_bucket_table(cols)
    g = arxiv_g
    n = g.n_nodes
    xa = torch.from_numpy(rng.standard_normal(
        (n, D), dtype=np.float32)).to(dev)
    edges = torch.from_numpy(rng.standard_normal(
        (g.num_edges_padded, 8), dtype=np.float32)).to(dev)
    ptr_c, ptr_r = g.indptr_c[: n + 1], g.indptr_r[: n + 1]
    _, ptr_pl, _ = xla._side(case.g, "src")
    x300 = torch.from_numpy(rng.standard_normal(
        (70_656, 300), dtype=np.float32)).to(dev)
    shapes = {
        "ELL experiment 125000x16 d=128": (gather_sum, (exp, x)),
        "ELL experiment 125000x16 d=128 bf16": (gather_sum,
                                                (exp, x.bfloat16())),
        "ELL sampled 70656x32 d=300 (synthetic)": (
            gather_sum, (one_bucket_table(sampled_cols(rng, dev)), x300)),
        "ELL power-law src table d=128 (hub)": (
            gather_sum, (case.se.gather_table, case.q)),
        "ELL power-law dst table d=128": (gather_sum,
                                          (case.de.gather_table, case.q)),
        "ELL power-law src table d=128 bf16 (hub)": (
            gather_sum, (case.se.gather_table, case.q.bfloat16())),
        "CSR power-law src rows d=128 (pl_spmm forward, hub)": (
            csr_sum, (ptr_pl, case.be)),
        "CSR arxiv copy d=128": (csr_sum, (ptr_c, xa, g.src_csc)),
        "CSR arxiv copy d=128 bf16": (csr_sum,
                                      (ptr_c, xa.bfloat16(), g.src_csc)),
        "CSR arxiv copy d=64": (csr_sum, (ptr_c, xa[:, :64].contiguous(),
                                          g.src_csc)),
        "CSR arxiv edges src d=4": (csr_sum,
                                    (ptr_r, edges[:, :4].contiguous())),
    }
    for h in (1, 4, 8):
        shapes[f"CSR arxiv edges dst d={h}"] = (
            csr_sum, (ptr_c, edges[:, :h].contiguous(), g.csc_perm))
    shapes["CSR halo-like identity d=64 (synthetic)"] = (
        csr_sum, halo_like(rng, dev))
    return shapes


def parent_ab(parent, variants, shapes, timing):
    """Each shape: parent, new, new, parent (and committed against each
    variant) timed in turns; bits and tolerances checked."""
    out, ok = {}, True
    for label, (entry, args) in shapes.items():
        new = entry(*args)
        again = entry(*args)
        with on_library(parent):
            old = entry(*args)
        torch.cuda.synchronize()
        strict, hub, hub_rows = plain_rows(entry, args)
        x = args[1]
        res = {"repeat_equal": bool(torch.equal(new, again)),
               "plain_rows": int(strict.sum()), "rows": int(strict.numel()),
               "plain_rows_same_bits": bool(torch.equal(old[strict],
                                                        new[strict])),
               "within_tolerance": within(new, old),
               "max_abs_diff": float((new.float() - old.float()).abs().max()),
               "hub_slots": int(hub_rows.numel()),
               "hub_rel_err_f64": hub_error(new, x, hub, hub_rows),
               "parent_hub_rel_err_f64": hub_error(old, x, hub, hub_rows)}

        def run_old():
            with on_library(parent):
                entry(*args)

        o1 = ms(run_old, timing)
        n1, n2 = ms(lambda: entry(*args), timing), ms(lambda: entry(*args),
                                                       timing)
        o2 = ms(run_old, timing)
        res.update(parent_ms=(o1 + o2) / 2, new_ms=(n1 + n2) / 2,
                   parent_ms_each=[o1, o2], new_ms_each=[n1, n2])
        if label.startswith("CSR halo"):
            ptr, vals = args
            res["segment_reduce_ms"] = ms(lambda: torch.segment_reduce(
                vals, "sum", offsets=ptr.long()), timing)
        for name, lib in variants.items():
            with on_library(lib):
                var = entry(*args)
            n1 = ms(lambda: entry(*args), timing)

            def run_var():
                with on_library(lib):
                    entry(*args)

            v1, v2 = ms(run_var, timing), ms(run_var, timing)
            n2 = ms(lambda: entry(*args), timing)
            res[name] = dict(same_bits=bool(torch.equal(var, new)),
                             committed_ms=(n1 + n2) / 2,
                             variant_ms=(v1 + v2) / 2)
        # The hub against f64 in f32 (a bf16 result carries its rounding).
        ok &= (res["repeat_equal"] and res["plain_rows_same_bits"]
               and res["within_tolerance"]
               and (new.dtype == torch.bfloat16
                    or res["hub_rel_err_f64"] < 1e-4))
        ok &= all(res[name]["same_bits"] for name in variants)
        out[label] = res
        print(f"  {label}: {res}", flush=True)
        del new, again, old
    return out, ok


def steps_ab(parent, pl_case, ds, g, timing):
    """The pl_spmm/xla_segment forward and the arxiv GCN and GraphSAGE
    train steps on the ELL and the segment path, parent against new in
    turns, with each step's S3 and CSR-entry launches."""
    dev = g.device
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    ell = ell_dual(g, profile="train")
    runs = {"pl_spmm/xla_segment forward": lambda: vector_spmm(
        pl_case.g, pl_case.ed, pl_case.q, impl="xla")}
    keep = []
    for name, cfg in STEP_MODELS.items():
        for path, kw in (("ELL", {"ell": ell}), ("segment", {})):
            model = getattr(models, name)(
                out_dim=ds.num_classes, in_dim=x.shape[1], **cfg,
                generator=torch.Generator().manual_seed(0)).to(dev)
            state = create_train_state(model, learning_rate=2e-3)
            step = make_train_step(apply_kwargs=kw)
            keep.append((state, step))
            runs[f"arxiv {name} {path} step"] = (
                lambda state=state, step=step: step(state, g, x, labels,
                                                    mask))
    out = {}
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        gather_sum.launches = csr_sum.launches = 0
        fn()
        torch.cuda.synchronize()
        launches = dict(s3=gather_sum.launches, csr=csr_sum.launches)

        def run_old():
            with on_library(parent):
                fn()

        o1 = ms(run_old, timing)
        n1, n2 = ms(fn, timing), ms(fn, timing)
        o2 = ms(run_old, timing)
        out[label] = dict(parent_ms=(o1 + o2) / 2, new_ms=(n1 + n2) / 2,
                          parent_ms_each=[o1, o2], new_ms_each=[n1, n2],
                          launches=launches)
        print(f"  {label}: {out[label]}", flush=True)
    del keep
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a parent's gather_sum.cu (its ell_table.cuh "
                    "beside it)")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="an edited copy of the committed gather_sum.cu "
                    "(same entry points), timed against it")
    args = ap.parse_args(argv)
    dev = cuda_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
           "piece": PIECE}
    print(smi, flush=True)
    timing = dict(warmup=3, iters=10, repeats=5)
    ok = True
    case = powerlaw_case(131072, 2_000_000, D, device=dev)
    ds = planted_partition(**ARXIV)
    g = ds.graph.to(dev)
    sources = ([args.parent] if args.parent else []) + args.variant
    built = dict(zip(sources, load_builds(sources, "ab_gather")))
    if args.parent or args.variant:
        parent = Library(built[args.parent] if args.parent
                         else _build.library())
        variants = {v.stem: Library(built[v]) for v in args.variant}
        out["shapes"], good = parent_ab(parent, variants,
                                        s3_shapes(dev, case, g), timing)
        ok &= good
        if args.parent:
            out["steps"] = steps_ab(parent, case, ds, g, timing)
    print(json.dumps({"ab_gather": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
