"""Row-block-owned SpMM sweeps S1 and S2, each beside its plain version.

Counterparts of the two manual-DMA kernels of scripts/exp_grid_dma.py:

- :func:`spmm_row_sweep_dma` (S1) — ``Y[i] = Σ_s vals_pad[i, s] @
  X[cols_pad[i, s]·128 : +128]`` over the dense-padded layout that
  :func:`pad_layout` builds, whose zero padding contributes 0;
- :func:`spmm_row_sweep_dma_v2` (S2) — K2's function on K2's inputs,
  ``Y[i] = Σ_{t ∈ ptr[i]..ptr[i+1]} vals[t] @ X[cols[t]·128 : +128]``.

Both are single-head (x is ``(n, d)``) and take 128×128 tiles; rows of x at
or past n count as zero, so callers never pad. They take float32 or
bfloat16 (one dtype per call), accumulate in f32 and return the input's
dtype, rounded once; the plain versions compute in f32 and round once.
The CUDA kernel (csrc/grid_dma.cu) runs K2's tensor-core arithmetic in
persistent blocks whose TMA copy ring runs across row blocks, so S2 gives
K2's bits. Each wrapper runs its kernel on CUDA tensors and its plain
version only on CPU tensors; ``<wrapper>.launches`` counts kernel launches
in float32, ``<wrapper>.launches_bf16`` those in bfloat16.
"""

from __future__ import annotations

from typing import Optional

import torch

from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    TILE,
    _check_cuda,
    _count,
    _entry,
    _on_cpu,
    _p,
    _row_tiles,
    _stream,
    _vec,
    spmm_row_sweep_plain,
)


def pad_layout(tg, vals: torch.Tensor):
    """(T, R, C) tile list → ((nrb, max_tpr) int32 col ids, (nrb, max_tpr,
    R, C) dense-padded vals), on ``vals``' device.

    Slot s of row block i holds tile ``ptr[i] + s`` when the block has one;
    a padding slot holds zeros and repeats the block's last column id (0
    for an empty block), as scripts/exp_grid_dma.py ``pad_layout`` does.
    """
    nrb, mt = tg.num_row_blocks, tg.max_tiles_per_row
    t = vals.shape[0]
    ptr = tg.tile_ptr.to(vals.device).long()
    counts = (ptr[1:] - ptr[:-1])[:, None]
    slot = torch.arange(mt, device=vals.device)
    live = slot < counts                                    # (nrb, mt)
    if t == 0:
        return (torch.zeros((nrb, mt), dtype=torch.int32, device=vals.device),
                vals.new_zeros((nrb, mt) + tuple(vals.shape[1:])))
    idx = (ptr[:-1, None] + slot).clamp(max=t - 1)
    last = ptr[:-1, None] + torch.minimum(slot, (counts - 1).clamp(min=0))
    cols = tg.tile_cols.to(vals.device).long()
    cols_pad = torch.where(counts > 0, cols[last.clamp(max=t - 1)], 0)
    vals_pad = vals[idx]
    vals_pad.masked_fill_(~live[..., None, None], 0.0)
    return cols_pad.to(torch.int32), vals_pad


def _check_dma(vals, x, n_out, nrb):
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    if tuple(vals.shape[-2:]) != (TILE, TILE):
        raise ValueError(f"the kernels take {TILE}x{TILE} tiles, got "
                         f"{tuple(vals.shape[-2:])}")
    if not 0 <= n_out <= nrb * TILE:
        raise ValueError(f"n_out={n_out} outside [0, {nrb * TILE}]")
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")


def copy_path(x: torch.Tensor) -> str:
    """How the kernels move x's rows: ``"tma"`` (2-D TMA box copies; rows
    of whole 16-byte pieces and x 16-byte aligned) or ``"element"`` (4-byte
    cp.async for float32, loads and stores for bfloat16)."""
    return "tma" if _vec(x.shape[1], x) else "element"


# ---------------------------------------------------------------------------
# S1: dense-padded row sweep
# ---------------------------------------------------------------------------

def spmm_row_sweep_dma_plain(cols_pad, vals_pad, x, n_out=None):
    nrb, mt, r, c = vals_pad.shape
    xt = _row_tiles(x[:, None], cols_pad.reshape(-1), c)    # (nrb·mt, C, 1, d)
    xt = xt[:, :, 0].reshape(nrb, mt, c, x.shape[1]).float()
    y = torch.einsum("bsrc,bscd->brd", vals_pad.float(), xt)
    y = y.reshape(nrb * r, -1)[: nrb * r if n_out is None else n_out]
    return y.to(x.dtype)


def spmm_row_sweep_dma(cols_pad, vals_pad, x, n_out: Optional[int] = None):
    """cols_pad: (nrb, max_tpr) int32, vals_pad: (nrb, max_tpr, R, C), x:
    (n_x, d) → y (n_out, d) with ``n_out`` ≤ nrb·R (default nrb·R);
    float32 or bfloat16."""
    if _on_cpu(cols_pad, vals_pad, x):
        return spmm_row_sweep_dma_plain(cols_pad, vals_pad, x, n_out)
    _check_cuda(ints=(cols_pad,), floats=(vals_pad, x), bf16=True)
    nrb, mt = vals_pad.shape[:2]
    if tuple(cols_pad.shape) != (nrb, mt):
        raise ValueError(f"cols_pad {tuple(cols_pad.shape)} does not match "
                         f"vals_pad {tuple(vals_pad.shape[:2])}")
    n_out = nrb * TILE if n_out is None else n_out
    _check_dma(vals_pad, x, n_out, nrb)
    d = x.shape[1]
    out = torch.empty((n_out, d), device=x.device, dtype=x.dtype)
    dev, stream = _stream(x)
    entry = _entry("spmm_row_sweep_dma", x)
    _build.check(getattr(_build.library(), entry)(
        _p(cols_pad), _p(vals_pad), _p(x), _p(out), nrb, mt, d, x.shape[0],
        n_out, _vec(d, x), dev, stream), entry)
    _count(spmm_row_sweep_dma, x)
    return out


spmm_row_sweep_dma.launches = spmm_row_sweep_dma.launches_bf16 = 0


# ---------------------------------------------------------------------------
# S2: row sweep over the tile list
# ---------------------------------------------------------------------------

def spmm_row_sweep_dma_v2(tile_ptr, tile_cols, vals, x,
                          n_out: Optional[int] = None):
    """vals: (T, R, C), x: (n_x, d) → y (n_out, d) with ``n_out`` ≤ NRB·R
    (default NRB·R); float32 or bfloat16. S2 computes K2's function, so its
    plain version is K2's, :func:`spmm_row_sweep_plain`."""
    if _on_cpu(tile_ptr, tile_cols, vals, x):
        return spmm_row_sweep_plain(tile_ptr, tile_cols, vals, x, n_out)
    _check_cuda(ints=(tile_ptr, tile_cols), floats=(vals, x), bf16=True)
    nrb = tile_ptr.shape[0] - 1
    if vals.dim() != 3 or tile_cols.shape != vals.shape[:1]:
        raise ValueError(f"vals must be (T, R, C) with T = {tile_cols.shape[0]}"
                         f", got {tuple(vals.shape)}")
    n_out = nrb * TILE if n_out is None else n_out
    _check_dma(vals, x, n_out, nrb)
    d = x.shape[1]
    out = torch.empty((n_out, d), device=x.device, dtype=x.dtype)
    dev, stream = _stream(x)
    entry = _entry("spmm_row_sweep_dma_v2", x)
    _build.check(getattr(_build.library(), entry)(
        _p(tile_ptr), _p(tile_cols), _p(vals), _p(x), _p(out), nrb, d,
        x.shape[0], n_out, _vec(d, x), dev, stream), entry)
    _count(spmm_row_sweep_dma_v2, x)
    return out


spmm_row_sweep_dma_v2.launches = spmm_row_sweep_dma_v2.launches_bf16 = 0
