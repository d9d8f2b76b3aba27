"""Bisect the grid regime's SpMM and attention time into their parts.

Counterpart of scripts/exp_grid_bisect.py, on the tile-aligned 1024×1024
grid at d = 128, each timed by CUDA events:

SpMM (vals tile-dense (T, 128, 128)):
  vals_stream       a pure read of the vals array (the layout's stream floor)
  spmm_f32          tiled_spmm (K2)
  spmm_dotonly_f32  S4: K2 with the vals load replaced by a constant
  spmm_bf16         K2 on bf16 vals and x
Attention forward (dst-normalised):
  attn_fwd_f32      tiled_attention (K4)
  attn_fwd_noexp    S5 with exp() replaced by the identity
  attn_fwd_nomask   S5 with the mask dropped
  attn_fwd_bf16     S5 at its default switches on bf16 q, k and v (K4's
                    bf16 kernel)
Attention backward and its parts:
  attn_bwd_f32      the gradient of Σ out² with respect to q
  sddmm_alone, softmax_scan_alone, row_sweep_alone, col_sweep_alone

Prints one JSON line ``{"grid_bisect": {...}}``. Needs a CUDA device.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_grid_bisect
"""

from __future__ import annotations

import json
import sys

import torch

from custom_op_benchmark_tpu_torch.ops.kernels.attention import attn_variant
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    sddmm_tiles,
    spmm_col_sweep,
    spmm_dotonly,
    spmm_row_sweep,
)
from custom_op_benchmark_tpu_torch.ops.tiled import _softmax_fwd, tiled_spmm
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.bench_suite import (
    grid_case,
    tiled_grid_attention,
)
from custom_op_benchmark_tpu_torch.utils.benchlib import bench_ms


def run(case, *, warmup=1, iters=5, repeats=3) -> dict:
    tg, x, vals = case.tg, case.q_al, case.vals
    tgT = tg.transpose()
    scale = case.d ** -0.5
    out = {"static": dict(
        n=case.n, e=case.e, T=tg.num_tiles, nrb=tg.num_row_blocks,
        max_tpr=tg.max_tiles_per_row, density=tg.density,
        vals_gb=vals.numel() * 4 / 1e9, mask_gb=tg.mask.numel() / 1e9)}
    print(f"grid n={case.n} e={case.e} T={tg.num_tiles} "
          f"nrb={tg.num_row_blocks} max_tpr={tg.max_tiles_per_row} "
          f"density={tg.density:.4f}", flush=True)

    timing = dict(warmup=warmup, iters=iters, repeats=repeats, edges=case.e)

    def attn_grad(q):
        q = q.detach().requires_grad_()
        (tiled_grid_attention(case, q) ** 2).sum().backward()
        return q.grad

    # ---- SpMM ----
    bench_ms(out, "vals_stream", lambda v: (v * 2.0).sum(dim=(1, 2)), vals,
             **timing)
    bench_ms(out, "spmm_f32", lambda v, x: tiled_spmm(tg, v, x), vals, x,
             **timing)
    bench_ms(out, "spmm_dotonly_f32",
             lambda x: spmm_dotonly(tg.tile_ptr, tg.tile_cols, x), x, **timing)
    x16 = x.bfloat16()
    bench_ms(out, "spmm_bf16", lambda v, x: spmm_row_sweep(
        tg.tile_ptr, tg.tile_cols, v, x), vals.bfloat16(), x16, **timing)
    # ---- attention forward ----
    bench_ms(out, "attn_fwd_f32", lambda x: tiled_grid_attention(case, x), x,
             **timing)
    bench_ms(out, "attn_fwd_noexp",
             lambda x: attn_variant(tgT.tile_ptr, tgT.tile_cols, tgT.mask, x,
                                    x, x, scale, use_exp=False), x, **timing)
    bench_ms(out, "attn_fwd_nomask",
             lambda x: attn_variant(tgT.tile_ptr, tgT.tile_cols, tgT.mask, x,
                                    x, x, scale, use_mask=False), x, **timing)
    bench_ms(out, "attn_fwd_bf16",
             lambda x: attn_variant(tgT.tile_ptr, tgT.tile_cols, tgT.mask, x,
                                    x, x, scale), x16, **timing)
    del x16
    # ---- attention backward: the composition and its parts ----
    bench_ms(out, "attn_bwd_f32", attn_grad, x, **timing)
    bench_ms(out, "sddmm_alone", lambda a, b: sddmm_tiles(
        tgT.tile_rows, tgT.tile_cols, tgT.mask, a, b), x, x, **timing)
    s0 = sddmm_tiles(tgT.tile_rows, tgT.tile_cols, tgT.mask, x, x)
    bench_ms(out, "softmax_scan_alone", lambda s: _softmax_fwd(tgT, s, "src"),
             s0, **timing)
    bench_ms(out, "row_sweep_alone", lambda v, x: spmm_row_sweep(
        tgT.tile_ptr, tgT.tile_cols, v, x), s0, x, **timing)
    bench_ms(out, "col_sweep_alone", lambda v, x: spmm_col_sweep(
        tgT.tile_ptr_c, tgT.tile_perm_c, tgT.tile_rows, v, x), s0, x,
             **timing)
    out["device"] = torch.cuda.get_device_name(x.device)
    return out


def main() -> int:
    case = grid_case(1024, 1024, 128, device=cuda_device())
    print(json.dumps({"grid_bisect": run(case)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
