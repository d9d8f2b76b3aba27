"""Tile-kernel A/B: the committed K1–K3 against older builds of them.

    python -m custom_op_benchmark_tpu_torch.experiments.ab_tiled \\
        [--k1k2 OLD.cu] [--k3 OLD_K3.cu]

Each option names an older ``csrc/tiled_kernels.cu``, copied out of git
under ``build/`` (the chip machine's copy of the repository has no
``.git``):

- ``--k1k2``: a file whose ``sddmm_tiles_f32`` and ``spmm_row_sweep_f32``
  have the committed signatures; its K1 and K2 are timed against the
  committed ones. The CUDA-core K1 and K2 are
  ``git show 6fd63b9:custom_op_benchmark_tpu_torch/csrc/tiled_kernels.cu``.
- ``--k3``: a file whose ``spmm_col_sweep_f32`` takes no ``vec``
  argument, as the CUDA-core K3 of
  ``git show 11ccb10:custom_op_benchmark_tpu_torch/csrc/tiled_kernels.cu``
  does; its K3 is timed against the committed one.

Each file is built with the port's nvcc flags (and ``csrc/`` on the
include path) into ``build/``. At the slice's shapes (the 512×30 clique
batch's transposed tile view, h = 8, d = 64, and h = 1, d = 1024) and on
the 1024×1024 grid at d = 128, both builds of each kernel are checked
against its plain version (rtol = atol = 1e-4) and timed by CUDA events in
turns (old, new, new, old; each time a median of repeats). Prints one JSON
line ``{"ab_tiled": {...}}`` with the card's name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph import clique_batch, tile_graph
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels import tiled_kernels as kt
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.bench_suite import grid_case
from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

RTOL = ATOL = 1e-4
_P, _I = ctypes.c_void_p, ctypes.c_int
# The older entry points' argument types (K3 without ``vec``).
OLD_SIGNATURES = {
    "k1k2": {"sddmm_tiles_f32": [_P] * 6 + [_I] * 6 + [_P],
             "spmm_row_sweep_f32": [_P] * 5 + [_I] * 7 + [_P]},
    "k3": {"spmm_col_sweep_f32": [_P] * 6 + [_I] * 7 + [_P]},
}


def load_old(source: Path, role: str) -> ctypes.CDLL:
    so = _build.BUILD_DIR / f"ab_{role}_{source.stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-shared", "-o", str(so), str(source)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in OLD_SIGNATURES[role].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def old_sddmm(lib, rows, cols, mask, A, B):
    a, b = kt._heads(A), kt._heads(B)
    t, h, d = mask.shape[0], a.shape[1], a.shape[2]
    out = torch.empty((h, t, kt.TILE, kt.TILE), device=A.device)
    dev, stream = kt._stream(A)
    _build.check(lib.sddmm_tiles_f32(
        kt._p(rows), kt._p(cols), kt._p(mask), kt._p(a), kt._p(b),
        kt._p(out), t, h, d, a.shape[0], b.shape[0], dev, stream),
        "old sddmm_tiles")
    return out[0] if A.dim() == 2 else out


def old_row_sweep(lib, ptr, cols, vals, x, n_out):
    v, xh = kt._tiles4(vals), kt._heads(x)
    h, t, d = v.shape[0], v.shape[1], xh.shape[2]
    out = torch.empty((n_out, h, d), device=x.device)
    dev, stream = kt._stream(x)
    _build.check(lib.spmm_row_sweep_f32(
        kt._p(ptr), kt._p(cols), kt._p(v), kt._p(xh), kt._p(out),
        ptr.numel() - 1, t, h, d, xh.shape[0], n_out, dev, stream),
        "old spmm_row_sweep")
    return out[:, 0] if x.dim() == 2 else out


def old_col_sweep(lib, ptr_c, perm, rows, vals, y, n_out):
    v, yh = kt._tiles4(vals), kt._heads(y)
    h, t, d = v.shape[0], v.shape[1], yh.shape[2]
    out = torch.empty((n_out, h, d), device=y.device)
    dev, stream = kt._stream(y)
    _build.check(lib.spmm_col_sweep_f32(
        kt._p(ptr_c), kt._p(perm), kt._p(rows), kt._p(v), kt._p(yh),
        kt._p(out), ptr_c.numel() - 1, t, h, d, yh.shape[0], n_out, dev,
        stream), "old spmm_col_sweep")
    return out[:, 0] if y.dim() == 2 else out


def compare(old, new, plain, args, timing):
    """Both builds against the plain version, then timed in turns."""
    want = plain(*args)
    res = {}
    for name, fn in (("old", old), ("new", new)):
        got = fn(*args)
        res[f"{name}_max_abs_err"] = float((got - want).abs().max())
        res[f"{name}_ok"] = bool(torch.allclose(got, want, rtol=RTOL,
                                                atol=ATOL))
        del got
    del want

    def ms(fn):
        return statistics.median(time_cuda(lambda: fn(*args), **timing)) * 1e3

    o1, n1, n2, o2 = ms(old), ms(new), ms(new), ms(old)
    res.update(old_ms=(o1 + o2) / 2, new_ms=(n1 + n2) / 2,
               old_ms_each=[o1, o2], new_ms_each=[n1, n2])
    torch.cuda.empty_cache()
    return res


def kernel_args(tg, a, b, vals):
    """K1-K3's arguments as the attention backward gives them."""
    return {
        "sddmm_tiles": (tg.tile_rows, tg.tile_cols, tg.mask, a, b),
        "spmm_row_sweep": (tg.tile_ptr, tg.tile_cols, vals, b, a.shape[0]),
        "spmm_col_sweep": (tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows, vals,
                           a, b.shape[0]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1k2", type=Path, help="older file for K1 and K2")
    ap.add_argument("--k3", type=Path, help="older file for K3 (no vec)")
    args = ap.parse_args(argv)
    if args.k1k2 is None and args.k3 is None:
        ap.error("name at least one older file: --k1k2 or --k3")
    dev = cuda_device()
    kernels = {}
    if args.k1k2 is not None:
        lib = load_old(args.k1k2, "k1k2")
        kernels["sddmm_tiles"] = (
            lambda *a: old_sddmm(lib, *a), kt.sddmm_tiles,
            kt.sddmm_tiles_plain)
        kernels["spmm_row_sweep"] = (
            lambda *a: old_row_sweep(lib, *a), kt.spmm_row_sweep,
            kt.spmm_row_sweep_plain)
    if args.k3 is not None:
        lib3 = load_old(args.k3, "k3")
        kernels["spmm_col_sweep"] = (
            lambda *a: old_col_sweep(lib3, *a), kt.spmm_col_sweep,
            kt.spmm_col_sweep_plain)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi}
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    tgt = tile_graph(clique_batch(512, 30), 128, 128, device=dev).transpose()
    n = tgt.n_nodes
    vals = torch.where(tgt.mask, normal(8, tgt.num_tiles, 128, 128), 0.0)
    x, y = normal(n, 1024), normal(n, 1024)
    cases = [("slice h=8 d=64", tgt, normal(n, 8, 64), normal(n, 8, 64),
              vals, {}),
             ("slice h=1 d=1024", tgt, x, y, vals[0].contiguous(), {})]
    for label, tg, a, b, v, timing in cases:
        for name, call in kernel_args(tg, a, b, v).items():
            if name in kernels:
                out[f"{name} {label}"] = compare(*kernels[name], call, timing)
    del cases, vals, x, y
    torch.cuda.empty_cache()
    case = grid_case(1024, 1024, 128, device=dev)
    grid = kernel_args(case.tg, case.q_al, case.q_al, case.vals)
    for name, call in grid.items():
        if name in kernels:
            out[f"{name} grid d=128"] = compare(
                *kernels[name], call, dict(warmup=1, iters=3, repeats=3))
    print(json.dumps({"ab_tiled": out}), flush=True)
    return 0 if all(r["old_ok"] and r["new_ok"] for k, r in out.items()
                    if isinstance(r, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
