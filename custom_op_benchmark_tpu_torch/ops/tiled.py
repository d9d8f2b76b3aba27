"""Public block-sparse (tiled) ops, each with a hand VJP.

Counterparts of custom_op_benchmark_tpu/ops/tiled.py. Edge data lives
tile-dense, ``(T, R, C)`` (or ``(H, T, R, C)`` with heads) over the nonzero
adjacency tiles of a :class:`TiledGraph`; convert with
``tg.scatter_edges`` / ``tg.gather_edges`` at the boundary.

Every gradient runs through the same three tile kernels K1–K3
(ops/kernels/tiled_kernels.py), and the fused attention forward through K4
(ops/kernels/attention.py). Heads are a grid axis of the kernels, read in
place from the ``(n, H, d)`` layout. Rows and features are never padded:
the kernels read rows past a node array's end as zero.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.graph.tiled import TiledGraph
from custom_op_benchmark_tpu_torch.ops.kernels.attention import (
    fused_attention_rows,
)
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    sddmm_tiles,
    spmm_col_sweep,
    spmm_row_sweep,
)
from custom_op_benchmark_tpu_torch.ops.segments import sorted_segment_reduce

_NEG = -1e30


# ---------------------------------------------------------------------------
# SDDMM
# ---------------------------------------------------------------------------

class _SddmmT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tg, A, B):
        ctx.tg = tg
        ctx.save_for_backward(A, B)
        return sddmm_tiles(tg.tile_rows, tg.tile_cols, tg.mask, A, B)

    @staticmethod
    def backward(ctx, dS):
        tg = ctx.tg
        A, B = ctx.saved_tensors
        # dS may arrive strided (the public op reaches the tiles through a
        # permute) and torch.where keeps its layout; the kernels take
        # contiguous tiles.
        dS = torch.where(tg.mask, dS, 0.0).contiguous()
        dA = spmm_row_sweep(tg.tile_ptr, tg.tile_cols, dS, B, A.shape[0])
        dB = spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows, dS,
                            A, B.shape[0])
        return None, dA, dB


def tiled_sddmm(tg: TiledGraph, A: torch.Tensor,
                B: torch.Tensor) -> torch.Tensor:
    """scores (T, R, C) = mask ⊙ (A[rows] @ B[cols]ᵀ).  A, B: (n, d), or
    (n, H, d) for scores (H, T, R, C)."""
    return _SddmmT.apply(tg, A.contiguous(), B.contiguous())


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

class _SpmmT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tg, vals, x, n_out):
        ctx.tg = tg
        ctx.save_for_backward(vals, x)
        return spmm_row_sweep(tg.tile_ptr, tg.tile_cols, vals, x, n_out)

    @staticmethod
    def backward(ctx, dy):
        tg = ctx.tg
        vals, x = ctx.saved_tensors
        dy = dy.contiguous()
        dvals = sddmm_tiles(tg.tile_rows, tg.tile_cols, tg.mask, dy, x)
        dx = spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows,
                            vals, dy, x.shape[0])
        return None, dvals, dx, None


def tiled_spmm(tg: TiledGraph, vals: torch.Tensor, x: torch.Tensor,
               out_rows: int = None) -> torch.Tensor:
    """y[u] = Σ_{e=(u,v)} vals[e]·x[v] with vals tile-dense (T, R, C).

    Returns (out_rows or tg.n_nodes, d); with heads, vals (H, T, R, C) and
    x (n, H, d) give (rows, H, d).
    """
    return _SpmmT.apply(tg, vals.contiguous(), x.contiguous(),
                        out_rows or tg.n_nodes)


# ---------------------------------------------------------------------------
# Softmax over tile-dense scores (plain torch: small per-tile reductions)
# ---------------------------------------------------------------------------

def _tsm_axes(tg: TiledGraph, by: str):
    """(segment id per tile, reduced tile axis, tile order or None, segment
    pointers, longest segment)."""
    if by == "src":
        return tg.tile_rows, -1, None, tg.tile_ptr, tg.max_tiles_per_row
    if by == "dst":
        return (tg.tile_cols, -2, tg.tile_perm_c, tg.tile_ptr_c,
                tg.max_tiles_per_col)
    raise ValueError(f"by must be 'src' or 'dst', got {by!r}")


def _seg_per_tile(tg, local, by, kind):
    """Reduce ``local`` (..., T, lanes) over each tile's segment and hand
    the segment's result back to each of its tiles."""
    ids, _, perm, ptr, max_len = _tsm_axes(tg, by)
    if perm is not None:
        local = local.index_select(-2, perm.long())
    seg = sorted_segment_reduce(local, ptr, kind, dim=-2, max_len=max_len)
    return seg.index_select(-2, ids.long())


def _softmax_fwd(tg, scores, by):
    axis = _tsm_axes(tg, by)[1]
    s = torch.where(tg.mask, scores, _NEG)
    m = _seg_per_tile(tg, s.amax(axis), by, "max").unsqueeze(axis)
    z = torch.where(tg.mask, torch.exp(s - m), 0.0)
    denom = _seg_per_tile(tg, z.sum(axis), by, "sum").unsqueeze(axis)
    return z / denom.clamp(min=1e-30)


def _softmax_bwd(tg, y, dy, by):
    """dS = y ⊙ (dy − Σ_seg y·dy)."""
    axis = _tsm_axes(tg, by)[1]
    agg = _seg_per_tile(tg, (y * dy).sum(axis), by, "sum").unsqueeze(axis)
    return y * (dy - agg)


class _TiledSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tg, scores, by):
        y = _softmax_fwd(tg, scores, by)
        ctx.tg, ctx.by = tg, by
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return None, _softmax_bwd(ctx.tg, y, dy, ctx.by), None


def tiled_softmax(tg: TiledGraph, scores: torch.Tensor, *,
                  by: str = "src") -> torch.Tensor:
    """Segment softmax of (…, T, R, C) scores over row (src) or column
    (dst) segments, masked to real edges; scatter-free both ways."""
    _tsm_axes(tg, by)
    return _TiledSoftmax.apply(tg, scores, by)


# ---------------------------------------------------------------------------
# Fused attention
# ---------------------------------------------------------------------------

class _FusedAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tg, q, k, v, scale):
        ctx.tg, ctx.scale = tg, scale
        ctx.save_for_backward(q, k, v)
        return fused_attention_rows(tg.tile_ptr, tg.tile_cols, tg.mask,
                                    q, k, v, scale)

    @staticmethod
    def backward(ctx, dy):
        """Recompute through K1–K3, as the JAX package does
        (custom_op_benchmark_tpu/ops/tiled.py:258-283): scores and α are
        rematerialised, never stored by the forward."""
        tg, scale = ctx.tg, ctx.scale
        q, k, v = ctx.saved_tensors
        dy = dy.contiguous()
        rows, cols, mask = tg.tile_rows, tg.tile_cols, tg.mask
        s = sddmm_tiles(rows, cols, mask, q, k) * scale
        alpha = _softmax_fwd(tg, s, "src")
        dv = spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c, rows, alpha, dy,
                            v.shape[0])
        dalpha = sddmm_tiles(rows, cols, mask, dy, v)
        dS = _softmax_bwd(tg, alpha, dalpha, "src") * scale
        dq = spmm_row_sweep(tg.tile_ptr, cols, dS, k, q.shape[0])
        dk = spmm_col_sweep(tg.tile_ptr_c, tg.tile_perm_c, rows, dS, q,
                            k.shape[0])
        return None, dq, dk, dv, None


def tiled_attention(tg: TiledGraph, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, scale: float = None,
                    normalize: str = "src") -> torch.Tensor:
    """Fused masked attention over the graph's adjacency tiles.

    ``normalize="src"``: out[u] = Σ_{e=(u,v)} softmax_u(<q[u],k[v]>)·v[v].
    ``normalize="dst"`` runs the same kernel on the transposed tiling
    (cached on ``tg``): out[v] = Σ_{e=(u,v)} softmax_v(<q[v],k[u]>)·v[u].

    q, k, v: (n, H, d) or (n, d). Returns the same shape as q.
    """
    if normalize == "dst":
        tg = tg.transpose()
    elif normalize != "src":
        raise ValueError(f"normalize must be 'src'/'dst', got {normalize!r}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FusedAttn.apply(tg, q.contiguous(), k.contiguous(),
                            v.contiguous(), float(scale))
