"""The three tile kernels K1–K3, each beside its plain PyTorch version.

Counterparts of custom_op_benchmark_tpu/ops/pallas/tiled_kernels.py:

- :func:`sddmm_tiles` (K1) — per nonzero tile t and head h,
  ``S[h, t] = mask[t] ⊙ (A[rows[t]·R : +R, h] @ B[cols[t]·C : +C, h]ᵀ)``;
- :func:`spmm_row_sweep` (K2) — per row block i,
  ``Y[i] = Σ_{t ∈ ptr[i]..ptr[i+1]} vals[t] @ X[cols[t]]``;
- :func:`spmm_col_sweep` (K3) — per column block j, over the column-sorted
  tile view, ``X'[j] = Σ_t vals[perm[t]]ᵀ @ Y[rows[perm[t]]]``;

and of ``spmm_dotonly`` in scripts/exp_grid_bisect.py:

- :func:`spmm_dotonly` (S4) — K2 with every vals entry the constant 0.01,
  a diagnostic that does K2's tile products without reading vals.

Shapes: node arrays are ``(n, d)`` or ``(n, H, d)`` (heads read in place);
tile arrays are ``(T, R, C)`` or ``(H, T, R, C)`` to match. Node rows at or
past ``n`` count as zero, so callers never pad rows or features.

Each wrapper runs its CUDA kernel (csrc/tiled_kernels.cu) when given CUDA
tensors, and its plain version only when given CPU tensors; on any other
input it raises. ``<wrapper>.launches`` counts kernel launches in float32
and, for the wrappers that take bfloat16, ``<wrapper>.launches_bf16``
those in bfloat16.

K1–K3 take float32 or bfloat16 node and tile arrays (one dtype per call),
accumulate in f32 and return the input's dtype, as the Pallas kernels do;
their plain versions widen bf16 inputs to f32, compute in f32 and round
once at the end, so kernel and plain version differ only in the order of
f32 sums and that final rounding. S4 takes float32.

Index arrays stay int32 everywhere, as the kernels take them; the plain
versions convert to int64 (``.long()``) at the point where they index.
"""

from __future__ import annotations

from typing import Optional

import torch

from custom_op_benchmark_tpu_torch.ops.kernels._build import (
    c_ptr,
    call,
    check_cuda,
    on_cpu,
)
from custom_op_benchmark_tpu_torch.ops.segments import sorted_segment_reduce

TILE = 128  # the only tile size the kernels take (tile_r == tile_c)


# ---------------------------------------------------------------------------
# Shared by the tile wrappers (also used by attention.py and grid_dma.py)
# ---------------------------------------------------------------------------

def as_heads(x: torch.Tensor) -> torch.Tensor:
    """(n, d) → (n, 1, d); (n, H, d) unchanged."""
    return x[:, None] if x.dim() == 2 else x


def as_tiles4(vals: torch.Tensor) -> torch.Tensor:
    """(T, R, C) → (1, T, R, C); (H, T, R, C) unchanged."""
    return vals[None] if vals.dim() == 3 else vals


def row_tiles(x: torch.Tensor, blocks: torch.Tensor,
              size: int) -> torch.Tensor:
    """Rows ``blocks[t]·size : +size`` of ``x`` (n, H, d) per tile →
    (T, size, H, d); rows at or past n read as zero."""
    idx = (blocks.long()[:, None] * size
           + torch.arange(size, device=x.device))
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz[idx.clamp(max=x.shape[0])]


def check_mask(mask: torch.Tensor) -> None:
    """The kernels take a contiguous bool mask of TILE×TILE tiles."""
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous bool tensor")
    if tuple(mask.shape[1:]) != (TILE, TILE):
        raise ValueError(f"the kernels take {TILE}x{TILE} tiles, got "
                         f"{tuple(mask.shape[1:])}")


def vec16(d: int, *tensors: torch.Tensor) -> int:
    """1 when rows of width d move as 16-byte copies: d a multiple of
    16 bytes' worth of elements and every base 16-byte aligned."""
    per16 = 16 // tensors[0].element_size()
    return int(d % per16 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in tensors))


# ---------------------------------------------------------------------------
# K1: SDDMM over tiles
# ---------------------------------------------------------------------------

def sddmm_tiles_plain(tile_rows, tile_cols, mask, A, B):
    t, r, c = mask.shape
    a = row_tiles(as_heads(A).float(), tile_rows, r)         # (T, R, H, d)
    b = row_tiles(as_heads(B).float(), tile_cols, c)         # (T, C, H, d)
    s = torch.where(mask, torch.einsum("trhd,tchd->htrc", a, b), 0.0)
    s = s.to(A.dtype)
    return s[0] if A.dim() == 2 else s


def sddmm_tiles(tile_rows, tile_cols, mask, A, B):
    """A: (nA, [H,] d), B: (nB, [H,] d), mask (T, R, C) → (T, R, C), or
    (H, T, R, C) for three-dimensional A and B; zero off the mask."""
    if A.shape[1:] != B.shape[1:]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} differ "
                         "in heads or width")
    if on_cpu(tile_rows, tile_cols, mask, A, B):
        return sddmm_tiles_plain(tile_rows, tile_cols, mask, A, B)
    check_cuda(ints=(tile_rows, tile_cols), floats=(A, B), bf16=True)
    check_mask(mask)
    t = mask.shape[0]
    if tile_rows.shape != (t,) or tile_cols.shape != (t,):
        raise ValueError(f"tile_rows/tile_cols must have shape ({t},)")
    if mask.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    a, b = as_heads(A), as_heads(B)
    h, d = a.shape[1], a.shape[2]
    out = torch.empty((h, t, TILE, TILE), device=A.device, dtype=A.dtype)
    if t:
        call(sddmm_tiles, "sddmm_tiles", A, c_ptr(tile_rows),
             c_ptr(tile_cols), c_ptr(mask), c_ptr(a), c_ptr(b), c_ptr(out),
             t, h, d, a.shape[0], b.shape[0])
    return out[0] if A.dim() == 2 else out


sddmm_tiles.launches = sddmm_tiles.launches_bf16 = 0


# ---------------------------------------------------------------------------
# K2: SpMM row sweep
# ---------------------------------------------------------------------------

def spmm_row_sweep_plain(tile_ptr, tile_cols, vals, x, n_out=None):
    v = as_tiles4(vals).float()
    _, _, r, c = v.shape
    nrb = tile_ptr.shape[0] - 1
    xt = row_tiles(as_heads(x).float(), tile_cols, c)        # (T, C, H, d)
    prod = torch.einsum("htrc,tchd->trhd", v, xt)           # (T, R, H, d)
    y = sorted_segment_reduce(prod, tile_ptr, "sum")        # (NRB, R, H, d)
    y = y.reshape((nrb * r,) + tuple(y.shape[2:]))
    y = y[: nrb * r if n_out is None else n_out].to(x.dtype)
    return y[:, 0] if x.dim() == 2 else y


def spmm_row_sweep(tile_ptr, tile_cols, vals, x,
                   n_out: Optional[int] = None):
    """vals: (T, R, C) or (H, T, R, C), x: (n_x, [H,] d) →
    y (n_out, [H,] d) with ``n_out`` ≤ NRB·R (default NRB·R)."""
    if on_cpu(tile_ptr, tile_cols, vals, x):
        return spmm_row_sweep_plain(tile_ptr, tile_cols, vals, x, n_out)
    check_cuda(ints=(tile_ptr, tile_cols), floats=(vals, x), bf16=True)
    v, xh = as_tiles4(vals), as_heads(x)
    h, t = v.shape[0], v.shape[1]
    d = xh.shape[2]
    nrb = tile_ptr.shape[0] - 1
    n_out = nrb * TILE if n_out is None else n_out
    _check_sweep(v, xh, n_out, nrb)
    if v.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    out = torch.empty((n_out, h, d), device=x.device, dtype=x.dtype)
    call(spmm_row_sweep, "spmm_row_sweep", x, c_ptr(tile_ptr),
         c_ptr(tile_cols), c_ptr(v), c_ptr(xh), c_ptr(out), nrb, t, h, d,
         xh.shape[0], n_out)
    return out[:, 0] if x.dim() == 2 else out


spmm_row_sweep.launches = spmm_row_sweep.launches_bf16 = 0


# ---------------------------------------------------------------------------
# S4: the row sweep with constant tiles (diagnostic)
# ---------------------------------------------------------------------------

DOTONLY_VALUE = 0.01


def spmm_dotonly_plain(tile_ptr, tile_cols, x, n_out=None):
    """Every row of block i is 0.01 · Σ_{t of i} Σ_c x[cols[t]·C + c]."""
    nrb = tile_ptr.shape[0] - 1
    xt = row_tiles(as_heads(x), tile_cols, TILE)             # (T, C, H, d)
    colsum = xt.sum(1) * DOTONLY_VALUE                      # (T, H, d)
    y = sorted_segment_reduce(colsum, tile_ptr, "sum")      # (NRB, H, d)
    y = y[:, None].expand(nrb, TILE, *y.shape[1:])
    y = y.reshape((nrb * TILE,) + tuple(y.shape[2:]))
    y = y[: nrb * TILE if n_out is None else n_out]
    return y[:, 0] if x.dim() == 2 else y


def spmm_dotonly(tile_ptr, tile_cols, x, n_out: Optional[int] = None):
    """x: (n_x, [H,] d) → y (n_out, [H,] d) = K2 over the tiles of
    ``tile_ptr``/``tile_cols`` with every tile 128×128 of 0.01 (the mask is
    not read). ``n_out`` ≤ NRB·128 (default NRB·128)."""
    if on_cpu(tile_ptr, tile_cols, x):
        return spmm_dotonly_plain(tile_ptr, tile_cols, x, n_out)
    check_cuda(ints=(tile_ptr, tile_cols), floats=(x,))
    xh = as_heads(x)
    h, d = xh.shape[1], xh.shape[2]
    nrb = tile_ptr.shape[0] - 1
    n_out = nrb * TILE if n_out is None else n_out
    if not 0 <= n_out <= nrb * TILE:
        raise ValueError(f"n_out={n_out} outside [0, {nrb * TILE}]")
    out = torch.empty((n_out, h, d), device=x.device, dtype=x.dtype)
    call(spmm_dotonly, "spmm_dotonly", x, c_ptr(tile_ptr),
         c_ptr(tile_cols), c_ptr(xh), c_ptr(out), nrb, h, d, xh.shape[0],
         n_out)
    return out[:, 0] if x.dim() == 2 else out


spmm_dotonly.launches = 0


def _check_sweep(v, xh, n_out, n_blocks):
    if tuple(v.shape[2:]) != (TILE, TILE):
        raise ValueError(f"the kernels take {TILE}x{TILE} tiles, got "
                         f"{tuple(v.shape[2:])}")
    if v.shape[0] != xh.shape[1]:
        raise ValueError(f"{v.shape[0]} heads of tiles, {xh.shape[1]} of x")
    if not 0 <= n_out <= n_blocks * TILE:
        raise ValueError(f"n_out={n_out} outside [0, {n_blocks * TILE}]")


# ---------------------------------------------------------------------------
# K3: SpMM column sweep (transpose)
# ---------------------------------------------------------------------------

def spmm_col_sweep_plain(tile_ptr_c, tile_perm_c, tile_rows, vals, y,
                         n_out=None):
    perm = tile_perm_c.long()
    v = as_tiles4(vals)[:, perm].float()                      # column order
    _, _, r, c = v.shape
    ncb = tile_ptr_c.shape[0] - 1
    yt = row_tiles(as_heads(y).float(), tile_rows[perm], r)  # (T, R, H, d)
    prod = torch.einsum("htrc,trhd->tchd", v, yt)           # (T, C, H, d)
    x = sorted_segment_reduce(prod, tile_ptr_c, "sum")      # (NCB, C, H, d)
    x = x.reshape((ncb * c,) + tuple(x.shape[2:]))
    x = x[: ncb * c if n_out is None else n_out].to(y.dtype)
    return x[:, 0] if y.dim() == 2 else x


def spmm_col_sweep(tile_ptr_c, tile_perm_c, tile_rows, vals, y,
                   n_out: Optional[int] = None):
    """vals: (T, R, C) or (H, T, R, C), y: (n_y, [H,] d) →
    x' (n_out, [H,] d) = Σ valsᵀ·y over column blocks, with ``n_out`` ≤
    NCB·C (default NCB·C)."""
    if on_cpu(tile_ptr_c, tile_perm_c, tile_rows, vals, y):
        return spmm_col_sweep_plain(tile_ptr_c, tile_perm_c, tile_rows, vals,
                                    y, n_out)
    check_cuda(ints=(tile_ptr_c, tile_perm_c, tile_rows), floats=(vals, y),
               bf16=True)
    v, yh = as_tiles4(vals), as_heads(y)
    h, t = v.shape[0], v.shape[1]
    d = yh.shape[2]
    ncb = tile_ptr_c.shape[0] - 1
    n_out = ncb * TILE if n_out is None else n_out
    _check_sweep(v, yh, n_out, ncb)
    if v.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    vec = vec16(d, yh)
    out = torch.empty((n_out, h, d), device=y.device, dtype=y.dtype)
    call(spmm_col_sweep, "spmm_col_sweep", y, c_ptr(tile_ptr_c),
         c_ptr(tile_perm_c), c_ptr(tile_rows), c_ptr(v), c_ptr(yh),
         c_ptr(out), ncb, t, h, d, yh.shape[0], n_out, vec)
    return out[:, 0] if y.dim() == 2 else out


spmm_col_sweep.launches = spmm_col_sweep.launches_bf16 = 0
