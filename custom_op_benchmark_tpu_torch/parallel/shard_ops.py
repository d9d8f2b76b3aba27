"""The gather plan: edge-partitioned ops with all_gather and psum_scatter.

Counterpart of custom_op_benchmark_tpu/parallel/shard_ops.py. Layout:

- the canonical (row-sorted) edge list is split into ``P`` contiguous,
  equally padded shards: edge arrays are ``(P·E_p, ...)``, sharded over
  the ``edge`` axis;
- node arrays are ``(P·n_p, ...)``, shard ``p`` owning rows
  ``[p·n_p, (p+1)·n_p)``;
- remote endpoint rows come with an ``all_gather``; a shard's partial
  segment sums over all nodes go back to their owners with a
  ``psum_scatter``; the softmax over segments split across shards heals
  with ``pmax`` and ``psum``.

The JAX package leaves the VJPs to AD through its collectives. Here the
collectives are ``autograd.Function`` s with the transposed collective as
backward (parallel/mesh.py), and the gathers by endpoint and the segment
sums are the Functions of parallel/rows.py, which sum on S3's CSR entry
in a fixed order. The ids of a shard are sorted by src (canonical order),
not by dst: their CSR is built once on the host with an argsort. A padded
edge names node ``n_nodes``; here it reads a zero row past the table and
sums into a dropped segment, where the reference clamps and masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph.graph import Graph, _round_up
from custom_op_benchmark_tpu_torch.graph.partition import edge_partition
from custom_op_benchmark_tpu_torch.parallel import rows as _rows
from custom_op_benchmark_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    blocks,
    pmax,
    psum,
    psum_scatter,
    shard,
    shard_rows,
    unblocks,
)


@dataclasses.dataclass(frozen=True, eq=False)
class DistGraph:
    """An edge-partitioned graph on a mesh axis.

    src, dst: ``(L, E_p)`` int32 blocks of global node ids (pad
    ``n_nodes``); ``eid`` the host plan's canonical edge ids ``(P, E_p)``
    (pad ``n_edges``).
    """

    src: torch.Tensor
    dst: torch.Tensor
    eid: np.ndarray
    n_nodes: int
    n_pad: int
    n_edges: int
    num_parts: int
    edges_per_part: int
    axis: str
    _cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nodes_per_part(self) -> int:
        return self.n_pad // self.num_parts

    def rows(self, side: str) -> _rows.RowIndex:
        """The CSR plan of the ``src`` or ``dst`` ids over the
        ``n_pad + 1`` rows of a gathered table (pad ids → row n_pad)."""
        ri = self._cache.get(side)
        if ri is None:
            ids = (self.src if side == "src" else self.dst).cpu().numpy()
            ids = np.where(ids < self.n_nodes, ids, self.n_pad)
            ri = _rows.row_index(ids, self.n_pad + 1, self.src.device)
            self._cache[side] = ri
        return ri

    def valid(self, side: str = "src") -> torch.Tensor:
        ids = self.src if side == "src" else self.dst
        return ids < self.n_nodes


def dist_graph(g: Graph, mesh: Mesh, axis: str = "edge") -> DistGraph:
    """Shard ``g``'s canonical edge list over ``mesh[axis]``."""
    p = mesh.shape[axis]
    plan = edge_partition(g, p, pad_multiple=8)
    return DistGraph(
        src=shard_rows(mesh, plan.src, axis),
        dst=shard_rows(mesh, plan.dst, axis),
        eid=plan.eid, n_nodes=g.n_nodes, n_pad=_round_up(g.n_nodes, p),
        n_edges=g.n_edges, num_parts=p, edges_per_part=plan.edges_per_part,
        axis=axis)


def node_sharding(dg: DistGraph, mesh: Mesh) -> tuple:
    """The spec of node arrays: rows over the edge axis."""
    return (dg.axis,)


def shard_nodes(dg: DistGraph, mesh: Mesh, x):
    """Pad a node array to ``n_pad`` rows and shard it over the mesh."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if x.shape[0] < dg.n_pad:
        x = np.pad(x, [(0, dg.n_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
    return shard(mesh, x, node_sharding(dg, mesh))


def shard_edges(dg: DistGraph, mesh: Mesh, edata_canonical):
    """Canonical ``(E, ...)`` edge data → the partition's slot order
    ``(P·E_p, ...)`` (pad slots zero), sharded."""
    ed = edata_canonical
    ed = ed.detach().cpu().numpy() if isinstance(ed, torch.Tensor) \
        else np.asarray(ed)
    eid = dg.eid.reshape(-1)
    out = np.zeros((len(eid),) + ed.shape[1:], ed.dtype)
    real = eid < dg.n_edges
    out[real] = ed[eid[real]]
    return shard_rows(mesh, out, dg.axis)


def _full(dg: DistGraph, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Node-sharded x → every shard's ``(n_pad + 1, ...)`` copy of all
    rows, a zero row last (the all_gather)."""
    xb = blocks(mesh, dg.axis, x)
    n_l = xb.shape[0]
    full = all_gather(mesh, dg.axis, xb).reshape(
        (n_l, dg.n_pad) + tuple(x.shape[1:]))
    return torch.cat([full, full.new_zeros((n_l, 1) + tuple(x.shape[1:]))],
                     1)


def _edge_blocks(dg, mesh, e):
    return blocks(mesh, dg.axis, e)


def dist_sddmm(dg: DistGraph, mesh: Mesh, A, B):
    """Edge-sharded scores ``y[e, h] = <A[src], B[dst]>``. A, B:
    ``(n_pad, h, d)`` node-sharded → ``(P·E_p, h)``."""
    ae = _rows.take(_full(dg, mesh, A), dg.rows("src"))
    be = _rows.take(_full(dg, mesh, B), dg.rows("dst"))
    y = torch.einsum("lehd,lehd->leh", ae, be)
    return unblocks(torch.where(dg.valid()[..., None], y, 0.0))


def _softmax_blocks(dg, mesh, ri, x):
    """The segment softmax of edge blocks ``x`` ``(L, E_p, h)`` over the
    segments of ``ri``, split across shards: the max heals with pmax (a
    constant of the VJP), the sum with psum."""
    m = pmax(mesh, dg.axis, _rows.segment_max(x.detach(), ri))
    z = torch.exp(x - _rows.take_raw(m, ri.ids))
    s = psum(mesh, dg.axis, _rows.segment_sum(z, ri))
    return z / _rows.take(s, ri).clamp(min=1e-30)


def dist_edge_softmax(dg: DistGraph, mesh: Mesh, x, *, by: str = "dst"):
    """Segment softmax over segments split across shards (the ring-
    attention analog). x: ``(P·E_p, h)`` edge-sharded."""
    if by not in ("src", "dst"):
        raise ValueError(f"by must be 'src' or 'dst', got {by!r}")
    xb = _edge_blocks(dg, mesh, x)
    ri = dg.rows(by)
    y = _softmax_blocks(dg, mesh, ri, xb)
    valid = (dg.src if by == "src" else dg.dst) < dg.n_nodes
    return unblocks(torch.where(valid[..., None], y, 0.0))


def _scatter_owned(dg, mesh, partial):
    """Per-shard partial sums over all ``n_pad`` rows → each owner's rows,
    summed over shards in order (psum_scatter)."""
    n_l = partial.shape[0]
    p = dg.num_parts
    parts = partial[:, : dg.n_pad].reshape(
        (n_l, p, dg.nodes_per_part) + tuple(partial.shape[2:]))
    return unblocks(psum_scatter(mesh, dg.axis, parts))


def dist_vector_spmm(dg: DistGraph, mesh: Mesh, edata, x, *,
                     to: str = "src"):
    """``out[u, h, :] = Σ_{e=(u,v)} edata[e, h]·x[v, h, :]``, node-sharded:
    local partial segment sums, then psum_scatter."""
    agg, gat = ("src", "dst") if to == "src" else ("dst", "src")
    eb = _edge_blocks(dg, mesh, edata)
    xs = _rows.take(_full(dg, mesh, x), dg.rows(gat))
    contrib = eb[..., None] * xs
    contrib = torch.where(dg.valid(agg)[..., None, None], contrib, 0.0)
    return _scatter_owned(dg, mesh, _rows.segment_sum(contrib,
                                                      dg.rows(agg)))


def dist_gat_attention(dg: DistGraph, mesh: Mesh, q, k, v):
    """Fused distributed attention: SDDMM → softmax over dst → SpMM into
    dst, one all_gather of q, k and v feeding all three. q, k, v:
    ``(n_pad, h, d)`` node-sharded → the same."""
    d = q.shape[-1]
    src, dst = dg.rows("src"), dg.rows("dst")
    v_full = _full(dg, mesh, v)
    scores = torch.einsum(
        "lehd,lehd->leh", _rows.take(_full(dg, mesh, k), src),
        _rows.take(_full(dg, mesh, q), dst)) / math.sqrt(d)
    valid = dg.valid()[..., None]
    scores = torch.where(valid, scores, -1e9)
    m = pmax(mesh, dg.axis, _rows.segment_max(scores.detach(), dst))
    z = torch.where(valid, torch.exp(scores - _rows.take_raw(m, dst.ids)),
                    0.0)
    s = psum(mesh, dg.axis, _rows.segment_sum(z, dst))
    alpha = z / _rows.take(s, dst).clamp(min=1e-30)
    contrib = alpha[..., None] * _rows.take(v_full, src)
    return _scatter_owned(dg, mesh, _rows.segment_sum(contrib, dst))
