"""Row-block-owned SpMM sweeps with prefetch (S1, S2) against K2 on the grid.

Counterpart of scripts/exp_grid_dma.py: on the tile-aligned 1024×1024 grid
at d = 128, checks S1 (over the dense-padded layout of :func:`pad_layout`)
and S2 (over K2's tile list) against the tiled SpMM with ``allclose`` at
2e-3, then times

    spmm_shipped      tiled_spmm (K2)
    spmm_dma_f32      S1, spmm_row_sweep_dma
    spmm_dma_v2       S2, spmm_row_sweep_dma_v2
    spmm_dma_bf16     S1 on bf16 vals and x (the script's bf16 row)
    spmm_dma_v2_bf16  S2 on bf16 vals and x

by CUDA events, and prints one JSON line ``{"grid_dma": {...}}``. Needs a
CUDA device.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_grid_dma
"""

from __future__ import annotations

import json
import sys

import torch

from custom_op_benchmark_tpu_torch.ops.kernels.grid_dma import (
    pad_layout,
    spmm_row_sweep_dma,
    spmm_row_sweep_dma_v2,
)
from custom_op_benchmark_tpu_torch.ops.tiled import tiled_spmm
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.bench_suite import grid_case
from custom_op_benchmark_tpu_torch.utils.benchlib import bench_ms

RTOL = ATOL = 2e-3


def run(case, *, warmup=1, iters=5, repeats=3) -> dict:
    tg, x = case.tg, case.q_al
    cols_pad, vals_pad = pad_layout(tg, case.vals)
    print(f"grid n={case.n} e={case.e} nrb={tg.num_row_blocks} "
          f"max_tpr={tg.max_tiles_per_row} "
          f"vals_pad_gb={vals_pad.numel() * 4 / 1e9:.3f}", flush=True)

    def shipped(v, x):
        return tiled_spmm(tg, v, x)

    y_ref = shipped(case.vals, x)
    y_dma = spmm_row_sweep_dma(cols_pad, vals_pad, x, y_ref.shape[0])
    y_v2 = spmm_row_sweep_dma_v2(tg.tile_ptr, tg.tile_cols, case.vals, x,
                                 y_ref.shape[0])
    okd = bool(torch.allclose(y_dma, y_ref, rtol=RTOL, atol=ATOL))
    okd2 = bool(torch.allclose(y_v2, y_ref, rtol=RTOL, atol=ATOL))
    print(f"allclose dma vs shipped: {okd}  v2: {okd2}", flush=True)
    out = {"allclose": okd, "allclose_v2": okd2}
    timing = dict(warmup=warmup, iters=iters, repeats=repeats, edges=case.e)
    bench_ms(out, "spmm_shipped", shipped, case.vals, x, **timing)
    bench_ms(out, "spmm_dma_f32", spmm_row_sweep_dma, cols_pad, vals_pad, x,
             **timing)
    bench_ms(out, "spmm_dma_v2", spmm_row_sweep_dma_v2, tg.tile_ptr,
             tg.tile_cols, case.vals, x, **timing)
    x16 = x.bfloat16()
    bench_ms(out, "spmm_dma_bf16", spmm_row_sweep_dma, cols_pad,
             vals_pad.bfloat16(), x16, **timing)
    bench_ms(out, "spmm_dma_v2_bf16", spmm_row_sweep_dma_v2, tg.tile_ptr,
             tg.tile_cols, case.vals.bfloat16(), x16, **timing)
    out["device"] = torch.cuda.get_device_name(x.device)
    return out


def main() -> int:
    case = grid_case(1024, 1024, 128, device=cuda_device())
    out = run(case)
    print(json.dumps({"grid_dma": out}))
    return 0 if out["allclose"] and out["allclose_v2"] else 1


if __name__ == "__main__":
    sys.exit(main())
