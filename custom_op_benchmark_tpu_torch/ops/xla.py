"""Segment implementations of the op family: the port's oracle.

Counterpart of custom_op_benchmark_tpu/ops/xla.py, in plain PyTorch. Every
function works on normalised shapes — node features ``(n, h, d)``, edge
features or scores ``(e, h)`` or ``(e, d)`` — in the graph's canonical
(row-sorted) edge order:

- reductions over ``dst`` go through the precomputed CSC permutation, so
  their ids are sorted, as in the reference;
- padded edges carry endpoint id ``n`` (one past the last node): gathers
  clamp it to row ``n - 1``, and scatters drop it (they write into a
  scratch row ``n`` that is cut off).

The scatters use ``index_add_`` and ``scatter_reduce_``, which on CUDA add
with atomics in an order that can change from run to run. That is allowed
here, in the oracle only: the tile kernels own their outputs and repeat
bit for bit; this module is what they are checked against.
"""

from __future__ import annotations

import torch


def _gather_nodes(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat[(n, ...)][idx] with padded ids (== n) clamped to row n-1."""
    return feat[idx.long().clamp(max=feat.shape[0] - 1)]


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Scatter-add ``vals`` into ``num_segments`` rows; ids ≥ num_segments
    are dropped."""
    ids = ids.long().clamp(max=num_segments)
    out = vals.new_zeros((num_segments + 1,) + tuple(vals.shape[1:]))
    return out.index_add_(0, ids, vals)[:num_segments]


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
    dB = segment_sum(contrib[csc_perm.long()], dst_csc, n)
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
    dx = segment_sum(contrib[csc_perm.long()], dst_csc, n)
    return dedata.to(edata.dtype), dx.to(x.dtype)
