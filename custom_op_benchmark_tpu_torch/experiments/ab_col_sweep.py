"""K3 A/B: the committed column sweep against the CUDA-core one it replaced.

    python -m custom_op_benchmark_tpu_torch.experiments.ab_col_sweep OLD.cu

OLD.cu is the CUDA-core version of csrc/tiled_kernels.cu (the file as it
was before the column sweep moved to the tensor cores; with git,
``git show 11ccb10:custom_op_benchmark_tpu_torch/csrc/tiled_kernels.cu``).
Its C entry point ``spmm_col_sweep_f32`` takes no ``vec`` argument. The
script builds it with the same nvcc flags into ``build/``, then at the
slice's shapes (the 512×30 clique batch's transposed tile view, h = 8,
d = 64, and h = 1, d = 1024) and on the 1024×1024 grid at d = 128 checks
both against the plain version (rtol = atol = 1e-4) and times them by CUDA
events in turns (old, new, new, old; each time the mean of two medians).
Prints one JSON line ``{"ab_col_sweep": {...}}``. Needs a CUDA device.
"""

from __future__ import annotations

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
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    _heads,
    _p,
    _stream,
    _tiles4,
    spmm_col_sweep,
    spmm_col_sweep_plain,
)
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.bench_suite import grid_case
from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

RTOL = ATOL = 1e-4


def load_old(source: Path) -> ctypes.CDLL:
    so = _build.BUILD_DIR / f"ab_old_{source.stem}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(source)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.spmm_col_sweep_f32.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.spmm_col_sweep_f32.restype = ctypes.c_int
    return lib


def old_col_sweep(lib, ptr_c, perm, rows, vals, y, n_out):
    v, yh = _tiles4(vals), _heads(y)
    h, t, d = v.shape[0], v.shape[1], yh.shape[2]
    out = torch.empty((n_out, h, d), device=y.device)
    dev, stream = _stream(y)
    _build.check(lib.spmm_col_sweep_f32(
        _p(ptr_c), _p(perm), _p(rows), _p(v), _p(yh), _p(out),
        ptr_c.numel() - 1, t, h, d, yh.shape[0], n_out, dev, stream),
        "old spmm_col_sweep")
    return out[:, 0] if y.dim() == 2 else out


def compare(lib, tg, vals, y, timing):
    args = (tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows, vals, y,
            y.shape[0])
    want = spmm_col_sweep_plain(*args)
    res = {}
    for name, fn in (("old", lambda: old_col_sweep(lib, *args)),
                     ("new", lambda: spmm_col_sweep(*args))):
        got = fn()
        res[f"{name}_max_abs_err"] = float((got - want).abs().max())
        res[f"{name}_ok"] = bool(torch.allclose(got, want, rtol=RTOL,
                                                atol=ATOL))
    del want

    def ms(fn):
        return statistics.median(time_cuda(fn, **timing)) * 1e3

    o1 = ms(lambda: old_col_sweep(lib, *args))
    n1 = ms(lambda: spmm_col_sweep(*args))
    n2 = ms(lambda: spmm_col_sweep(*args))
    o2 = ms(lambda: old_col_sweep(lib, *args))
    res.update(old_ms=(o1 + o2) / 2, new_ms=(n1 + n2) / 2,
               old_ms_each=[o1, o2], new_ms_each=[n1, n2])
    return res


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    dev = cuda_device()
    lib = load_old(Path(argv[0]))
    rng = np.random.default_rng(0)
    tgt = tile_graph(clique_batch(512, 30), 128, 128, device=dev).transpose()
    n = tgt.n_nodes

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    vals = torch.where(tgt.mask, normal(8, tgt.num_tiles, 128, 128), 0.0)
    out = {"device": torch.cuda.get_device_name(dev)}
    out["slice h=8 d=64"] = compare(lib, tgt, vals, normal(n, 8, 64), {})
    out["slice h=1 d=1024"] = compare(lib, tgt, vals[0].contiguous(),
                                      normal(n, 1024), {})
    del vals
    case = grid_case(1024, 1024, 128, device=dev)
    out["grid d=128"] = compare(lib, case.tg, case.vals, case.q_al,
                                dict(warmup=1, iters=3, repeats=3))
    print(json.dumps({"ab_col_sweep": out}), flush=True)
    return 0 if all(r["old_ok"] and r["new_ok"] for k, r in out.items()
                    if k != "device") else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
