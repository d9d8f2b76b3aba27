"""Segment implementations of the op family: the port's oracle.

Counterpart of custom_op_benchmark_tpu/ops/xla.py, in plain PyTorch. Every
function works on normalised shapes — node features ``(n, h, d)``, edge
features or scores ``(e, h)`` or ``(e, d)`` — in the graph's canonical
(row-sorted) edge order:

- reductions over ``dst`` go through the precomputed CSC permutation, so
  their ids are sorted, as in the reference;
- padded edges carry endpoint id ``n`` (one past the last node): gathers
  clamp it to row ``n - 1``, and scatters drop it (their segment ``n``
  lies past the last row).

Every sum over segments is a sum over sorted segments in a fixed order:
the ids are sorted, so segment ``s`` is the range ``ptr[s] .. ptr[s+1]``
of a CSR offset array, and ``csr_sum`` (S3's CSR entry,
ops/kernels/gather_sum.py) sums each range in slot order, one warp a row
on the card, with no atomics. The same inputs give the same bits on every
run, as the reference asserts (tests/test_determinism.py). The autograd
Functions at the end, :func:`gather_rows`, :func:`sorted_segment_sum` and
:func:`copy_sum`, are each other's VJPs, so no autograd backward of a
gather over repeated ids (an ``index_put_`` with accumulation) runs
either. :func:`segment_max` keeps ``scatter_reduce_`` with ``"amax"``: a
maximum does not depend on the order of its operands.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import csr_sum


def _gather_nodes(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat[(n, ...)][idx] with padded ids (== n) clamped to row n-1."""
    return feat[idx.long().clamp(max=feat.shape[0] - 1)]


def segment_ptr(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The CSR offsets (num_segments + 1,) int32 of sorted ``ids``: segment
    s is ``ids[ptr[s]:ptr[s+1]]``; ids ≥ num_segments lie past ptr[-1]."""
    ids = ids.int().contiguous()
    if ids.device.type == "cpu" and ids.numel() > 1 and bool(
            (ids[1:] < ids[:-1]).any()):
        raise ValueError("segment ids must be sorted")
    bounds = torch.arange(num_segments + 1, device=ids.device,
                          dtype=torch.int32)
    return torch.searchsorted(ids, bounds, out_int32=True)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num_segments: int,
                perm: torch.Tensor = None) -> torch.Tensor:
    """Sum ``vals`` over sorted segments into ``num_segments`` rows; ids ≥
    num_segments are dropped. ``ids`` must be sorted. With ``perm`` the
    k-th id belongs to ``vals[perm[k]]`` (CSC order over canonical edge
    data), so the permuted copy of ``vals`` is never made. Fixed order,
    no atomics (``csr_sum``)."""
    ptr = segment_ptr(ids, num_segments)
    idx = None if perm is None else perm.int().contiguous()
    return csr_sum(ptr, vals.contiguous(), idx)


def segment_max(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment max; an empty segment gives -1e9 (the reference's init)."""
    ids = ids.long().clamp(max=num_segments)
    out = vals.new_full((num_segments + 1,) + tuple(vals.shape[1:]), -1e9)
    index = ids.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce_(0, index, vals, "amax")[:num_segments]


def _edge_valid(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(e, 1) bool: False on padded edges (id == n)."""
    return (ids < n)[:, None]


# ---------------------------------------------------------------------------
# SDDMM  —  score[e, h] = <A[src(e), h, :], B[dst(e), h, :]>
# ---------------------------------------------------------------------------

def sddmm_fwd(src, dst, A, B):
    y = torch.einsum("ehd,ehd->eh", _gather_nodes(A, src),
                     _gather_nodes(B, dst))
    return torch.where(_edge_valid(src, A.shape[0]), y, 0.0)


def sddmm_bwd(src, dst, csc_perm, dst_csc, A, B, dy):
    n = A.shape[0]
    dA = segment_sum(dy[:, :, None] * _gather_nodes(B, dst), src, n)
    contrib = dy[:, :, None] * _gather_nodes(A, src)
    dB = segment_sum(contrib, dst_csc, n, perm=csc_perm)
    return dA.to(A.dtype), dB.to(B.dtype)


# ---------------------------------------------------------------------------
# NodeMulEdge  —  score[e, h] = <A[src(e), h, :], B[e, :]>
# ---------------------------------------------------------------------------

def node_mul_edge_fwd(src, A, B):
    y = torch.einsum("ehd,ed->eh", _gather_nodes(A, src), B)
    return torch.where(_edge_valid(src, A.shape[0]), y, 0.0)


def node_mul_edge_bwd(src, A, B, dy):
    n = A.shape[0]
    dA = segment_sum(dy[:, :, None] * B[:, None, :], src, n)
    dB = torch.einsum("eh,ehd->ed", dy, _gather_nodes(A, src))
    dB = torch.where(_edge_valid(src, n), dB, 0.0)
    return dA.to(A.dtype), dB.to(B.dtype)


# ---------------------------------------------------------------------------
# Edge softmax over the segment of edges sharing an endpoint
# ---------------------------------------------------------------------------

def edge_softmax_fwd(ids, x, num_segments):
    m = segment_max(x, ids, num_segments)
    seg = ids.long().clamp(max=num_segments - 1)
    z = torch.exp(x - m[seg])
    s = segment_sum(z, ids, num_segments)
    y = z / s[seg].clamp(min=1e-30)
    return torch.where(_edge_valid(ids, num_segments), y, 0.0)


def edge_softmax_bwd(ids, y, dy, num_segments):
    """dx = y·dy − y·segsum(y·dy)[segment]."""
    agg = segment_sum(y * dy, ids, num_segments)
    seg = ids.long().clamp(max=num_segments - 1)
    dx = y * dy - y * agg[seg]
    return torch.where(_edge_valid(ids, num_segments), dx, 0.0)


# ---------------------------------------------------------------------------
# Vector SpMM  —  out[u, h, :] = Σ_{e=(u,v)} edata[e, h] · x[v, h, :]
# ---------------------------------------------------------------------------

def vector_spmm_fwd(src, dst, edata, x):
    contrib = edata[:, :, None] * _gather_nodes(x, dst)
    return segment_sum(contrib, src, x.shape[0])


def vector_spmm_bwd(src, dst, csc_perm, dst_csc, edata, x, dy):
    n = x.shape[0]
    dedata = torch.einsum("ehd,ehd->eh", _gather_nodes(dy, src),
                          _gather_nodes(x, dst))
    dedata = torch.where(_edge_valid(src, n), dedata, 0.0)
    contrib = edata[:, :, None] * _gather_nodes(dy, src)
    dx = segment_sum(contrib, dst_csc, n, perm=csc_perm)
    return dedata.to(edata.dtype), dx.to(x.dtype)


# ---------------------------------------------------------------------------
# Gathers by endpoint and sums over sorted segments, each the other's VJP
# ---------------------------------------------------------------------------

class GatherRows(torch.autograd.Function):
    """``x[idx]`` with ids past the last row clamped to it. ``ptr``
    (``x.shape[0] + 1`` offsets) and ``order`` are the CSR of the clamped
    ids, so the VJP sums the cotangent over each row's slots on
    ``csr_sum``. The distributed plans (``parallel/rows.py``) use it on
    tables of P shards' rows."""

    @staticmethod
    def forward(ctx, x, idx, ptr, order):
        ctx.save_for_backward(ptr, order)
        return _gather_nodes(x, idx)

    @staticmethod
    def backward(ctx, dy):
        ptr, order = ctx.saved_tensors
        return csr_sum(ptr, dy.contiguous(), order), None, None, None


class SegmentSum(torch.autograd.Function):
    """Σ of ``vals`` over the sorted segments of ``ptr`` (slots listed by
    ``order``), on ``csr_sum``; ``seg`` names each slot's segment, so the
    VJP gathers the cotangent by it."""

    @staticmethod
    def forward(ctx, vals, ptr, order, seg):
        ctx.save_for_backward(seg)
        return csr_sum(ptr, vals.contiguous(), order)

    @staticmethod
    def backward(ctx, dy):
        (seg,) = ctx.saved_tensors
        return dy[seg.long()], None, None, None


class _CopySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ptr, idx, ptr_t, idx_t):
        ctx.save_for_backward(ptr_t, idx_t)
        return csr_sum(ptr, x.contiguous(), idx)

    @staticmethod
    def backward(ctx, dy):
        ptr_t, idx_t = ctx.saved_tensors
        return csr_sum(ptr_t, dy.contiguous(), idx_t), None, None, None, None


def _side(g, by: str):
    """(endpoint ids in canonical order, CSR offsets over n + 1 segments
    with the padded one last, the order that lists the edges by that
    endpoint: None for src, ``csc_perm`` for dst)."""
    if by == "src":
        return g.src, g.indptr_r, None
    if by == "dst":
        return g.dst, g.indptr_c, g.csc_perm
    raise ValueError(f"by must be 'src' or 'dst', got {by!r}")


def gather_rows(g, x: torch.Tensor, by: str) -> torch.Tensor:
    """``x[src(e)]`` (``by="src"``) or ``x[dst(e)]`` (``by="dst"``) for
    every edge in canonical order, padded edges reading row n - 1. Its
    VJP is the sorted segment sum of the cotangent over the edges of each
    node (the padded edges' into row n - 1), with no atomics."""
    if x.shape[0] != g.n_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, the graph "
                         f"{g.n_nodes} nodes")
    ids, ptr, order = _side(g, by)
    n = g.n_nodes
    # The clamp sends the padded segment n to row n - 1: merge the two.
    merged = torch.cat([ptr[:n], ptr[n + 1: n + 2]])
    return GatherRows.apply(x, ids, merged, order)


def sorted_segment_sum(g, vals: torch.Tensor, to: str) -> torch.Tensor:
    """``out[u] = Σ_{e: src(e)=u} vals[e]`` (``to="src"``) or over the
    in-edges of each node (``to="dst"``); ``vals`` is edge data in
    canonical order, padded edges dropped. Its VJP gathers the cotangent
    by each edge's endpoint (0 on padded edges)."""
    ids, ptr, order = _side(g, to)
    # The padded segment n is summed and sliced off; its slots get 0.
    return SegmentSum.apply(vals, ptr, order, ids)[: g.n_nodes]


def copy_sum(g, x: torch.Tensor, frm: str, to: str) -> torch.Tensor:
    """``out[v] = Σ_{e: to(e)=v} x[frm(e)]`` over real edges, with
    ``(frm, to)`` = ``("src", "dst")`` or ``("dst", "src")``: the copy
    form of ``gspmm`` with no ``(E, d)`` message in memory. Its VJP is the
    same sum over the transpose."""
    n = g.n_nodes
    if x.shape[0] != n:
        raise ValueError(f"x has {x.shape[0]} rows, the graph {n} nodes")
    if (frm, to) == ("src", "dst"):
        fwd = (g.indptr_c[: n + 1], g.src_csc)
        bwd = (g.indptr_r[: n + 1], g.dst)
    elif (frm, to) == ("dst", "src"):
        fwd = (g.indptr_r[: n + 1], g.dst)
        bwd = (g.indptr_c[: n + 1], g.src_csc)
    else:
        raise ValueError(f"copy_sum goes src→dst or dst→src, got "
                         f"{frm}→{to}")
    return _CopySum.apply(x, *fwd, *bwd)
