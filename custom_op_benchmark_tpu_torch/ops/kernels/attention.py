"""Fused block-sparse graph attention K4 and its diagnostic variant S5, each
beside its plain PyTorch version.

Counterparts of custom_op_benchmark_tpu/ops/pallas/attention.py (K4) and
``attn_variant`` in scripts/exp_grid_bisect.py (S5). Per row block I and
head h, over I's nonzero tiles (the src direction):

    s      = (Q[I] @ K[J(t)]ᵀ) · scale, non-edges set to -1e30
    m      = max(-1e9, max over I's tiles of s)        per row
    out[I] = Σ_t exp(s − m) @ V[J(t)] / Σ_t rowsum(exp(s − m)),
             or 0 for a row with no edges.

Both run the online-softmax recurrence in csrc/attention.cu, one tile at
a time, and never store a score in device memory. K4 runs on the
tensor-core kernel at every head width, in float32 or bfloat16 (f32
accumulation, the input's dtype out): with Q resident for d ≤ 128, and
for wider heads one block per 128 output features that recomputes the
scores (:func:`kernel_route`). S5 takes the CUDA-core kernel (float32,
d ≤ 256), which switches the exponentials (``use_exp``) and the mask
(``use_mask``) off. The plain K4 materialises the masked scores and
composes the softmax in f32; the plain S5 runs the recurrence one tile
slot at a time over all row blocks, since without ``exp`` it is not a
softmax. Each wrapper runs its kernel on CUDA tensors and its plain
version only on CPU tensors; ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    TILE,
    _check_cuda,
    _entry,
    _heads,
    _on_cpu,
    _p,
    _row_tiles,
    _stream,
    _vec,
)
from custom_op_benchmark_tpu_torch.ops.segments import sorted_segment_reduce

NEG_INF = -1e30
M_INIT = -1e9      # the kernel's first running max
S5_MAX_HEAD_DIM = 256  # widest head of the CUDA-core kernel (S5)
RESIDENT_MAX_HEAD_DIM = 128  # widest head K4 runs with Q resident


def fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k, v, scale):
    t, r, c = mask.shape
    nrb = tile_ptr.shape[0] - 1
    ptr = tile_ptr.long()
    rows = torch.repeat_interleave(torch.arange(nrb, device=q.device),
                                   ptr[1:] - ptr[:-1])
    qh, kh, vh = _heads(q).float(), _heads(k).float(), _heads(v).float()
    qt = _row_tiles(qh, rows, r)                            # (T, R, H, d)
    kt = _row_tiles(kh, tile_cols, c)                       # (T, C, H, d)
    vt = _row_tiles(vh, tile_cols, c)
    s = torch.einsum("trhd,tchd->htrc", qt, kt) * scale
    s = torch.where(mask, s, NEG_INF)
    m = sorted_segment_reduce(s.amax(-1), ptr, "max", dim=1)  # (H, NRB, R)
    m = m.clamp(min=M_INIT)
    p = torch.exp(s - m[:, rows, :, None])
    l = sorted_segment_reduce(p.sum(-1), ptr, "sum", dim=1)   # (H, NRB, R)
    acc = sorted_segment_reduce(
        torch.einsum("htrc,tchd->trhd", p, vt), ptr, "sum")   # (NRB, R, H, d)
    l = l.permute(1, 2, 0)[..., None]                         # (NRB, R, H, 1)
    out = torch.where(l > 0, acc / l.clamp(min=1e-30), 0.0)
    out = out.reshape((nrb * r,) + tuple(out.shape[2:]))[: q.shape[0]]
    out = out.to(q.dtype)
    return out[:, 0] if q.dim() == 2 else out


def check_kernel_args(tile_ptr, tile_cols, mask, q, k, v, *, s5=False):
    """The checks the CUDA kernels need of their arguments; raises
    ValueError on anything they do not take. K4 takes float32 or bfloat16
    and any head width d ≥ 1; S5 (``s5=True``) float32 and 1 ≤ d ≤ 256.
    Returns (n_q, H, d, nrb)."""
    _check_cuda(ints=(tile_ptr, tile_cols), floats=(q, k, v), mask=mask,
                bf16=not s5)
    qh = _heads(q)
    n_q, h, d = qh.shape
    nrb = tile_ptr.shape[0] - 1
    top = S5_MAX_HEAD_DIM if s5 else None
    if d < 1 or (top is not None and d > top):
        raise ValueError(f"head width {d} outside [1, {top or '∞'}]")
    if n_q > nrb * TILE:
        raise ValueError(f"{n_q} query rows exceed {nrb} row blocks")
    if tile_cols.shape != mask.shape[:1]:
        raise ValueError(f"tile_cols {tuple(tile_cols.shape)} does not match "
                         f"{mask.shape[0]} mask tiles")
    return n_q, h, d, nrb


def kernel_route(d: int) -> str:
    """The tensor-core kernel's form that serves K4 at head width d:
    ``"mma"`` (1 ≤ d ≤ 128, Q resident in shared memory) or ``"wide"``
    (d > 128: one block per 128 output features, Q staged in 64-feature
    chunks beside K, the scores recomputed per block). Both are the one C
    entry point ``fused_attention_rows_*``; no width takes the plain
    version."""
    if d < 1:
        raise ValueError(f"head width {d} < 1")
    return "mma" if d <= RESIDENT_MAX_HEAD_DIM else "wide"


def _launch(entry, args, tile_ptr, tile_cols, mask, q, k, v, scale, s5):
    n_q, h, d, nrb = check_kernel_args(tile_ptr, tile_cols, mask, q, k, v,
                                       s5=s5)
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    out = torch.empty_like(qh)
    dev, stream = _stream(q)
    _build.check(getattr(_build.library(), entry)(
        _p(tile_ptr), _p(tile_cols), _p(mask), _p(qh), _p(kh), _p(vh),
        _p(out), nrb, h, d, n_q, kh.shape[0], n_q, float(scale), *args, dev,
        stream), entry)
    return out[:, 0] if q.dim() == 2 else out


def fused_attention_rows(tile_ptr, tile_cols, mask, q, k, v, scale: float):
    """q: (n_q, [H,] d), k/v: (n_kv, [H,] d), mask (T, R, C) →
    out (n_q, [H,] d), softmax over each row's tiles. n_q ≤ NRB·R; float32
    or bfloat16, any d ≥ 1."""
    if not q.shape[1:] == k.shape[1:] == v.shape[1:]:
        raise ValueError("q, k and v differ in heads or width")
    if _on_cpu(tile_ptr, tile_cols, mask, q, k, v):
        return fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k, v,
                                          scale)
    if mask.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    out = _launch(_entry("fused_attention_rows", q),
                  (_vec(q.shape[-1], q, k, v),), tile_ptr, tile_cols, mask,
                  q, k, v, scale, s5=False)
    fused_attention_rows.launches += 1
    return out


fused_attention_rows.launches = 0


# ---------------------------------------------------------------------------
# S5: K4 with the exponentials and the mask switched
# ---------------------------------------------------------------------------

def attn_variant_plain(tile_ptr, tile_cols, mask, q, k, v, scale,
                       use_exp=True, use_mask=True):
    """The recurrence of scripts/exp_grid_bisect.py ``_attn_body``, one tile
    slot at a time over all row blocks (slot s of a row block is its tile
    ptr[i] + s, if it has one)."""
    _, r, c = mask.shape
    nrb = tile_ptr.shape[0] - 1
    ptr = tile_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    blocks = torch.arange(nrb, device=q.device)
    qt = _row_tiles(qh, blocks, r)                            # (NRB, R, H, d)
    h = qh.shape[1]
    m = q.new_full((nrb, r, h), M_INIT)
    l = q.new_zeros((nrb, r, h))
    acc = torch.zeros_like(qt)
    n_slots = int(counts.max()) if nrb else 0
    for slot in range(n_slots):
        live = slot < counts                                  # (NRB,)
        t = (ptr[:-1] + slot).clamp(max=max(mask.shape[0] - 1, 0))
        kt = _row_tiles(kh, tile_cols[t], c)                  # (NRB, C, H, d)
        vt = _row_tiles(vh, tile_cols[t], c)
        s = torch.einsum("brhd,bchd->brch", qt, kt) * scale
        if use_mask:
            s = torch.where(mask[t][..., None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(2))
        if use_exp:
            p = torch.exp(s - m_new[:, :, None])
            corr = torch.exp(m - m_new)
        else:
            p = s - m_new[:, :, None]
            corr = m - m_new
        l_new = l * corr + p.sum(2)
        acc_new = acc * corr[..., None] + torch.einsum("brch,bchd->brhd",
                                                       p, vt)
        sel = live[:, None, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel[..., None], acc_new, acc)
    l = l[..., None]
    out = torch.where(l > 0, acc / l.clamp(min=1e-30), 0.0)
    out = out.reshape((nrb * r,) + tuple(out.shape[2:]))[: q.shape[0]]
    return out[:, 0] if q.dim() == 2 else out


def attn_variant(tile_ptr, tile_cols, mask, q, k, v, scale: float, *,
                 use_exp: bool = True, use_mask: bool = True):
    """S5: :func:`fused_attention_rows` with ``use_exp=False`` (p = s − m,
    corr = m_prev − m) and/or ``use_mask=False`` (every column of each tile
    counts, key rows past n reading as zero). A diagnostic on the CUDA
    cores, float32, 1 ≤ d ≤ 256; with both on it is K4's function."""
    if not q.shape[1:] == k.shape[1:] == v.shape[1:]:
        raise ValueError("q, k and v differ in heads or width")
    if _on_cpu(tile_ptr, tile_cols, mask, q, k, v):
        return attn_variant_plain(tile_ptr, tile_cols, mask, q, k, v, scale,
                                  use_exp, use_mask)
    out = _launch("attn_variant_f32", (int(use_exp), int(use_mask)),
                  tile_ptr, tile_cols, mask, q, k, v, scale, s5=True)
    attn_variant.launches += 1
    return out


attn_variant.launches = 0
