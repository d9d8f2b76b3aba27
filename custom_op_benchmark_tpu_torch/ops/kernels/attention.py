"""Fused block-sparse graph attention K4, beside its plain PyTorch version.

Counterpart of custom_op_benchmark_tpu/ops/pallas/attention.py. Per row
block I and head h, over I's nonzero tiles (the src direction):

    s      = (Q[I] @ K[J(t)]ᵀ) · scale, non-edges set to -1e30
    m      = max(-1e9, max over I's tiles of s)        per row
    out[I] = Σ_t exp(s − m) @ V[J(t)] / Σ_t rowsum(exp(s − m)),
             or 0 for a row with no edges.

The CUDA kernel (csrc/attention.cu) computes it with the online-softmax
recurrence and never stores a score; the plain version materialises the
masked scores and composes the softmax. :func:`fused_attention_rows` runs
the kernel on CUDA tensors and the plain version only on CPU tensors.
``fused_attention_rows.launches`` counts kernel launches.
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
HEAD_DIM = 64      # the only head width the kernel is built for


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


def fused_attention_rows(tile_ptr, tile_cols, mask, q, k, v, scale: float):
    """q: (n_q, [H,] d), k/v: (n_kv, [H,] d), mask (T, R, C) →
    out (n_q, [H,] d), softmax over each row's tiles. n_q ≤ NRB·R."""
    if not q.shape[1:] == k.shape[1:] == v.shape[1:]:
        raise ValueError("q, k and v differ in heads or width")
    if _on_cpu(tile_ptr, tile_cols, mask, q, k, v):
        return fused_attention_rows_plain(tile_ptr, tile_cols, mask, q, k, v,
                                          scale)
    _check_cuda(ints=(tile_ptr, tile_cols), floats=(q, k, v), mask=mask)
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    n_q, h, d = qh.shape
    nrb = tile_ptr.shape[0] - 1
    if d != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head width "
                         f"{HEAD_DIM}, got {d}")
    if n_q > nrb * TILE:
        raise ValueError(f"{n_q} query rows exceed {nrb} row blocks")
    out = torch.empty_like(qh)
    dev, stream = _stream(q)
    _build.check(_build.library().fused_attention_rows_f32(
        _p(tile_ptr), _p(tile_cols), _p(mask), _p(qh), _p(kh), _p(vh),
        _p(out), nrb, h, d, n_q, kh.shape[0], n_q, float(scale), dev,
        stream), "fused_attention_rows")
    fused_attention_rows.launches += 1
    return out[:, 0] if q.dim() == 2 else out


fused_attention_rows.launches = 0
