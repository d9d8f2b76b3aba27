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

import ctypes
from typing import Optional

import torch

from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.segments import sorted_segment_reduce
from custom_op_benchmark_tpu_torch.utils.spans import launch

TILE = 128  # the only tile size the kernels take (tile_r == tile_c)


# ---------------------------------------------------------------------------
# Shared by the wrappers (also used by ops/kernels/attention.py)
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor) -> torch.Tensor:
    """(n, d) → (n, 1, d); (n, H, d) unchanged."""
    return x[:, None] if x.dim() == 2 else x


def _tiles4(vals: torch.Tensor) -> torch.Tensor:
    """(T, R, C) → (1, T, R, C); (H, T, R, C) unchanged."""
    return vals[None] if vals.dim() == 3 else vals


def _row_tiles(x: torch.Tensor, blocks: torch.Tensor,
               size: int) -> torch.Tensor:
    """Rows ``blocks[t]·size : +size`` of ``x`` (n, H, d) per tile →
    (T, size, H, d); rows at or past n read as zero."""
    idx = (blocks.long()[:, None] * size
           + torch.arange(size, device=x.device))
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz[idx.clamp(max=x.shape[0])]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every tensor lies
    on one CUDA device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(*, ints=(), floats=(), mask=None, bf16=False) -> None:
    """The checks every CUDA entry point needs of its arguments. ``floats``
    must be contiguous and of one dtype: float32, or with ``bf16`` also
    bfloat16."""
    for t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("index arrays must be contiguous int32")
    allowed = KERNEL_DTYPES if bf16 else (torch.float32,)
    for t in floats:
        if t.dtype not in allowed or not t.is_contiguous():
            raise ValueError(
                "the kernel takes contiguous tensors of "
                f"{' or '.join(map(str, allowed))}, got {t.dtype}, "
                f"contiguous={t.is_contiguous()}")
    if len({t.dtype for t in floats}) > 1:
        raise ValueError("the kernel takes one dtype per call, got "
                         f"{sorted(str(t.dtype) for t in floats)}")
    if mask is not None:
        if mask.dtype != torch.bool or not mask.is_contiguous():
            raise ValueError("mask must be a contiguous bool tensor")
        if tuple(mask.shape[1:]) != (TILE, TILE):
            raise ValueError(f"the kernels take {TILE}x{TILE} tiles, got "
                             f"{tuple(mask.shape[1:])}")


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _entry(name: str, t: torch.Tensor) -> str:
    """The C entry point of ``name`` for ``t``'s dtype (``<name>_f32`` or
    ``<name>_bf16``)."""
    return f"{name}_{'bf16' if t.dtype == torch.bfloat16 else 'f32'}"


def _vec(d: int, *tensors: torch.Tensor) -> int:
    """1 when rows of width d move as 16-byte copies: d a multiple of
    16 bytes' worth of elements and every base 16-byte aligned."""
    per16 = 16 // tensors[0].element_size()
    return int(d % per16 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in tensors))


def _count(fn, t: torch.Tensor) -> None:
    """One launch of ``fn``'s kernel in ``t``'s dtype."""
    if t.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _stream(t: torch.Tensor):
    return (t.device.index,
            ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream))


def _call(name: str, t: torch.Tensor, *args) -> None:
    """Launch the C entry point of ``name`` for ``t``'s dtype with
    ``args``, then ``t``'s device and current stream, inside
    ``spans.launch`` (a profiler then links the kernel to the caller's
    span); raise if the launch failed. The launch path for new wrappers
    (ops/kernels/ell_gat.py takes it)."""
    entry = _entry(name, t)
    dev, stream = _stream(t)
    fn = getattr(_build.library(), entry)
    with launch(entry):
        _build.check(fn(*args, dev, stream), entry)


# ---------------------------------------------------------------------------
# K1: SDDMM over tiles
# ---------------------------------------------------------------------------

def sddmm_tiles_plain(tile_rows, tile_cols, mask, A, B):
    t, r, c = mask.shape
    a = _row_tiles(_heads(A).float(), tile_rows, r)         # (T, R, H, d)
    b = _row_tiles(_heads(B).float(), tile_cols, c)         # (T, C, H, d)
    s = torch.where(mask, torch.einsum("trhd,tchd->htrc", a, b), 0.0)
    s = s.to(A.dtype)
    return s[0] if A.dim() == 2 else s


def sddmm_tiles(tile_rows, tile_cols, mask, A, B):
    """A: (nA, [H,] d), B: (nB, [H,] d), mask (T, R, C) → (T, R, C), or
    (H, T, R, C) for three-dimensional A and B; zero off the mask."""
    if A.shape[1:] != B.shape[1:]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} differ "
                         "in heads or width")
    if _on_cpu(tile_rows, tile_cols, mask, A, B):
        return sddmm_tiles_plain(tile_rows, tile_cols, mask, A, B)
    _check_cuda(ints=(tile_rows, tile_cols), floats=(A, B), mask=mask,
                bf16=True)
    t = mask.shape[0]
    if tile_rows.shape != (t,) or tile_cols.shape != (t,):
        raise ValueError(f"tile_rows/tile_cols must have shape ({t},)")
    if mask.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    a, b = _heads(A), _heads(B)
    h, d = a.shape[1], a.shape[2]
    out = torch.empty((h, t, TILE, TILE), device=A.device, dtype=A.dtype)
    if t:
        dev, stream = _stream(A)
        entry = _entry("sddmm_tiles", A)
        _build.check(getattr(_build.library(), entry)(
            _p(tile_rows), _p(tile_cols), _p(mask), _p(a), _p(b), _p(out),
            t, h, d, a.shape[0], b.shape[0], dev, stream), entry)
        _count(sddmm_tiles, A)
    return out[0] if A.dim() == 2 else out


sddmm_tiles.launches = sddmm_tiles.launches_bf16 = 0


# ---------------------------------------------------------------------------
# K2: SpMM row sweep
# ---------------------------------------------------------------------------

def spmm_row_sweep_plain(tile_ptr, tile_cols, vals, x, n_out=None):
    v = _tiles4(vals).float()
    _, _, r, c = v.shape
    nrb = tile_ptr.shape[0] - 1
    xt = _row_tiles(_heads(x).float(), tile_cols, c)        # (T, C, H, d)
    prod = torch.einsum("htrc,tchd->trhd", v, xt)           # (T, R, H, d)
    y = sorted_segment_reduce(prod, tile_ptr, "sum")        # (NRB, R, H, d)
    y = y.reshape((nrb * r,) + tuple(y.shape[2:]))
    y = y[: nrb * r if n_out is None else n_out].to(x.dtype)
    return y[:, 0] if x.dim() == 2 else y


def spmm_row_sweep(tile_ptr, tile_cols, vals, x,
                   n_out: Optional[int] = None):
    """vals: (T, R, C) or (H, T, R, C), x: (n_x, [H,] d) →
    y (n_out, [H,] d) with ``n_out`` ≤ NRB·R (default NRB·R)."""
    if _on_cpu(tile_ptr, tile_cols, vals, x):
        return spmm_row_sweep_plain(tile_ptr, tile_cols, vals, x, n_out)
    _check_cuda(ints=(tile_ptr, tile_cols), floats=(vals, x), bf16=True)
    v, xh = _tiles4(vals), _heads(x)
    h, t = v.shape[0], v.shape[1]
    d = xh.shape[2]
    nrb = tile_ptr.shape[0] - 1
    n_out = nrb * TILE if n_out is None else n_out
    _check_sweep(v, xh, n_out, nrb)
    if v.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    out = torch.empty((n_out, h, d), device=x.device, dtype=x.dtype)
    dev, stream = _stream(x)
    entry = _entry("spmm_row_sweep", x)
    _build.check(getattr(_build.library(), entry)(
        _p(tile_ptr), _p(tile_cols), _p(v), _p(xh), _p(out),
        nrb, t, h, d, xh.shape[0], n_out, dev, stream), entry)
    _count(spmm_row_sweep, x)
    return out[:, 0] if x.dim() == 2 else out


spmm_row_sweep.launches = spmm_row_sweep.launches_bf16 = 0


# ---------------------------------------------------------------------------
# S4: the row sweep with constant tiles (diagnostic)
# ---------------------------------------------------------------------------

DOTONLY_VALUE = 0.01


def spmm_dotonly_plain(tile_ptr, tile_cols, x, n_out=None):
    """Every row of block i is 0.01 · Σ_{t of i} Σ_c x[cols[t]·C + c]."""
    nrb = tile_ptr.shape[0] - 1
    xt = _row_tiles(_heads(x), tile_cols, TILE)             # (T, C, H, d)
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
    if _on_cpu(tile_ptr, tile_cols, x):
        return spmm_dotonly_plain(tile_ptr, tile_cols, x, n_out)
    _check_cuda(ints=(tile_ptr, tile_cols), floats=(x,))
    xh = _heads(x)
    h, d = xh.shape[1], xh.shape[2]
    nrb = tile_ptr.shape[0] - 1
    n_out = nrb * TILE if n_out is None else n_out
    if not 0 <= n_out <= nrb * TILE:
        raise ValueError(f"n_out={n_out} outside [0, {nrb * TILE}]")
    out = torch.empty((n_out, h, d), device=x.device, dtype=x.dtype)
    dev, stream = _stream(x)
    _build.check(_build.library().spmm_dotonly_f32(
        _p(tile_ptr), _p(tile_cols), _p(xh), _p(out), nrb, h, d,
        xh.shape[0], n_out, dev, stream), "spmm_dotonly")
    spmm_dotonly.launches += 1
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
    v = _tiles4(vals)[:, perm].float()                      # column order
    _, _, r, c = v.shape
    ncb = tile_ptr_c.shape[0] - 1
    yt = _row_tiles(_heads(y).float(), tile_rows[perm], r)  # (T, R, H, d)
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
    if _on_cpu(tile_ptr_c, tile_perm_c, tile_rows, vals, y):
        return spmm_col_sweep_plain(tile_ptr_c, tile_perm_c, tile_rows, vals,
                                    y, n_out)
    _check_cuda(ints=(tile_ptr_c, tile_perm_c, tile_rows), floats=(vals, y),
                bf16=True)
    v, yh = _tiles4(vals), _heads(y)
    h, t = v.shape[0], v.shape[1]
    d = yh.shape[2]
    ncb = tile_ptr_c.shape[0] - 1
    n_out = ncb * TILE if n_out is None else n_out
    _check_sweep(v, yh, n_out, ncb)
    if v.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    vec = _vec(d, yh)
    out = torch.empty((n_out, h, d), device=y.device, dtype=y.dtype)
    dev, stream = _stream(y)
    entry = _entry("spmm_col_sweep", y)
    _build.check(getattr(_build.library(), entry)(
        _p(tile_ptr_c), _p(tile_perm_c), _p(tile_rows), _p(v), _p(yh),
        _p(out), ncb, t, h, d, yh.shape[0], n_out, vec, dev, stream), entry)
    _count(spmm_col_sweep, y)
    return out[:, 0] if y.dim() == 2 else out


spmm_col_sweep.launches = spmm_col_sweep.launches_bf16 = 0
