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
a time, and never store a score in device memory. K4 takes the
tensor-core kernel for head widths 1 to 128 and the CUDA-core kernel for
129 to 256 (:func:`kernel_route`); S5 always takes the CUDA-core kernel,
which switches the exponentials (``use_exp``) and the mask (``use_mask``)
off. The plain K4 materialises the masked scores and composes the
softmax; the plain S5 runs the recurrence one tile slot at a time over
all row blocks, since without ``exp`` it is not a softmax. Each wrapper
runs its kernel on CUDA tensors and its plain version only on CPU
tensors; ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    TILE,
    _check_cuda,
    _heads,
    _on_cpu,
    _p,
    _row_tiles,
    _stream,
)
from custom_op_benchmark_tpu_torch.ops.segments import sorted_segment_reduce

NEG_INF = -1e30
M_INIT = -1e9      # the kernel's first running max
MAX_HEAD_DIM = 256  # widest head the kernels are built for (csrc/attention.cu)
MMA_MAX_HEAD_DIM = 128  # widest head of the tensor-core kernel


def fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k, v, scale):
    t, r, c = mask.shape
    nrb = tile_ptr.shape[0] - 1
    ptr = tile_ptr.long()
    rows = torch.repeat_interleave(torch.arange(nrb, device=q.device),
                                   ptr[1:] - ptr[:-1])
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
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
    return out[:, 0] if q.dim() == 2 else out


def check_kernel_args(tile_ptr, tile_cols, mask, q, k, v):
    """The checks the CUDA kernels need of their arguments; raises
    ValueError on anything they do not take. Returns (n_q, H, d, nrb)."""
    _check_cuda(ints=(tile_ptr, tile_cols), floats=(q, k, v), mask=mask)
    qh = _heads(q)
    n_q, h, d = qh.shape
    nrb = tile_ptr.shape[0] - 1
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head widths 1 to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if n_q > nrb * TILE:
        raise ValueError(f"{n_q} query rows exceed {nrb} row blocks")
    if tile_cols.shape != mask.shape[:1]:
        raise ValueError(f"tile_cols {tuple(tile_cols.shape)} does not match "
                         f"{mask.shape[0]} mask tiles")
    return n_q, h, d, nrb


def kernel_route(d: int) -> str:
    """The CUDA kernel that serves K4 at head width d: ``"mma"``, the
    tensor-core kernel (1 ≤ d ≤ 128), or ``"rows"``, the CUDA-core kernel
    that S5 runs (128 < d ≤ 256), whose Q, K and V tiles would not fit the
    tensor-core kernel's shared memory."""
    return "mma" if d <= MMA_MAX_HEAD_DIM else "rows"


def _launch(entry, args, tile_ptr, tile_cols, mask, q, k, v, scale):
    n_q, h, d, nrb = check_kernel_args(tile_ptr, tile_cols, mask, q, k, v)
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    out = torch.empty_like(qh)
    dev, stream = _stream(q)
    _build.check(getattr(_build.library(), entry)(
        _p(tile_ptr), _p(tile_cols), _p(mask), _p(qh), _p(kh), _p(vh),
        _p(out), nrb, h, d, n_q, kh.shape[0], n_q, float(scale), *args, dev,
        stream), entry)
    return out[:, 0] if q.dim() == 2 else out


def _mma_args(mask, q, k, v):
    """The tensor-core kernel's extra argument (``vec``: q, k and v rows
    move as 16-byte copies); it stages the mask with 16-byte copies."""
    if mask.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    d = q.shape[-1]
    return (int(d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in (q, k, v))),)


def fused_attention_rows(tile_ptr, tile_cols, mask, q, k, v, scale: float):
    """q: (n_q, [H,] d), k/v: (n_kv, [H,] d), mask (T, R, C) →
    out (n_q, [H,] d), softmax over each row's tiles. n_q ≤ NRB·R; on the
    GPU 1 ≤ d ≤ 256."""
    if not q.shape[1:] == k.shape[1:] == v.shape[1:]:
        raise ValueError("q, k and v differ in heads or width")
    if _on_cpu(tile_ptr, tile_cols, mask, q, k, v):
        return fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k, v,
                                          scale)
    if kernel_route(q.shape[-1]) == "mma":
        entry, args = "fused_attention_rows_f32", _mma_args(mask, q, k, v)
    else:
        entry, args = "attn_variant_f32", (1, 1)
    out = _launch(entry, args, tile_ptr, tile_cols, mask, q, k, v, scale)
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
    counts, key rows past n reading as zero). A diagnostic; with both on it
    is K4."""
    if not q.shape[1:] == k.shape[1:] == v.shape[1:]:
        raise ValueError("q, k and v differ in heads or width")
    if _on_cpu(tile_ptr, tile_cols, mask, q, k, v):
        return attn_variant_plain(tile_ptr, tile_cols, mask, q, k, v, scale,
                                  use_exp, use_mask)
    out = _launch("attn_variant_f32", (int(use_exp), int(use_mask)),
                  tile_ptr, tile_cols, mask, q, k, v, scale)
    attn_variant.launches += 1
    return out


attn_variant.launches = 0
