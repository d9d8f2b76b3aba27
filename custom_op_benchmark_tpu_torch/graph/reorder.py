"""Node reordering for tile locality (host-side, cold-path preprocessing).

Counterpart of custom_op_benchmark_tpu/graph/reorder.py: renumber nodes so
that densely connected groups (connected components, communities,
attention blocks) land inside single tiles, which collapses the BSR tiling
of the clique batch to its diagonal. Everything is numpy on the host, done
once per graph; node tensors move to the new numbering with
:meth:`Reordering.scatter_nodes` and back with :meth:`Reordering.gather_nodes`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch

from custom_op_benchmark_tpu_torch.graph import native
from custom_op_benchmark_tpu_torch.graph.graph import Graph, from_coo


def _host_edges(g: Graph):
    src = g.src.cpu().numpy()[: g.n_edges].astype(np.int64)
    dst = g.dst.cpu().numpy()[: g.n_edges].astype(np.int64)
    return src, dst


def connected_components(src, dst, n_nodes: int) -> np.ndarray:
    """Weakly connected component label per node (int64): the smallest node
    id of the node's component.

    The native union-find (graphcore) finds the components where the
    library builds, scipy otherwise; either way each component is labelled
    by its smallest id, the label of the JAX package's union-find fallback,
    so :func:`tile_aligned_order` orders the groups as that fallback does
    whichever path runs. (The JAX package's native path labels by the root
    its union by size picks, so its order depends on its build.)
    """
    roots = native.connected_components_native(src, dst, n_nodes)
    if roots is not None:
        # The first node of each root's component in id order is its
        # smallest.
        _, first, inverse = np.unique(roots, return_index=True,
                                      return_inverse=True)
        return first[inverse].astype(np.int64)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    adj = scipy.sparse.coo_matrix(
        (np.ones(len(src), dtype=np.int8), (src, dst)),
        shape=(n_nodes, n_nodes))
    n_comp, comp = scipy.sparse.csgraph.connected_components(
        adj, directed=True, connection="weak")
    roots = np.full(n_comp, n_nodes, dtype=np.int64)
    np.minimum.at(roots, comp, np.arange(n_nodes, dtype=np.int64))
    return roots[comp]


@dataclasses.dataclass(frozen=True)
class Reordering:
    """A node renumbering old → new (possibly with padding gaps).

    ``perm[i]`` is node ``i``'s new id; new ids not hit by any old node are
    padding slots (isolated in the reordered graph).
    """

    perm: np.ndarray          # (n_old,) int32, injective into [0, n_new)
    n_new: int
    n_old: int

    def _index(self, device) -> torch.Tensor:
        return torch.from_numpy(self.perm.astype(np.int64)).to(device)

    def scatter_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """(n_old, ...) → (n_new, ...) in the new numbering (pads zero)."""
        out = x.new_zeros((self.n_new,) + tuple(x.shape[1:]))
        return out.index_copy(0, self._index(x.device), x)

    def gather_nodes(self, y: torch.Tensor) -> torch.Tensor:
        """(n_new, ...) → (n_old, ...) back in the original numbering."""
        return y.index_select(0, self._index(y.device))


def tile_aligned_order(g: Graph, block: int = 128,
                       labels: np.ndarray = None) -> Reordering:
    """Renumber nodes so node groups never straddle ``block`` boundaries.

    Groups default to weakly connected components; pass ``labels`` to align
    on any other grouping. Groups larger than ``block`` are laid out
    contiguously (they straddle regardless). First-fit in order of each
    group's label, with padding inserted at block boundaries.
    """
    src, dst = _host_edges(g)
    n = g.n_nodes
    if labels is None:
        labels = connected_components(src, dst, n)
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.flatnonzero(
        np.r_[True, sorted_labels[1:] != sorted_labels[:-1]])
    sizes = np.diff(np.r_[starts, n])
    # First fit: a group that fits in a block but would straddle the next
    # boundary starts at that boundary instead. The cursor depends on every
    # earlier group, so this is one pass over the groups (not the nodes).
    offsets = np.empty(len(starts), dtype=np.int64)
    cursor = 0
    for gi, sz in enumerate(sizes.tolist()):
        if sz <= block and (cursor % block) + sz > block:
            cursor = -(-cursor // block) * block
        offsets[gi] = cursor
        cursor += sz
    group = np.repeat(np.arange(len(starts)), sizes)
    rank = np.arange(n) - starts[group]
    perm = np.empty(n, dtype=np.int32)
    perm[order] = (offsets[group] + rank).astype(np.int32)
    n_new = -(-cursor // block) * block
    return Reordering(perm=perm, n_new=int(n_new), n_old=n)


def degree_balanced_order(g: Graph, num_parts: int) -> Reordering:
    """Renumber nodes so ``num_parts`` contiguous owner ranges get
    near-identical degree distributions: sort by in-degree (out-degree, then
    id, break ties) and deal the nodes serpentine-wise across the parts."""
    src, dst = _host_edges(g)
    n = g.n_nodes
    p = int(num_parts)
    n_per = -(-n // p)
    deg_in = np.bincount(dst, minlength=n)
    deg_out = np.bincount(src, minlength=n)
    order = np.lexsort((np.arange(n), -deg_out, -deg_in))
    ranks = np.arange(n, dtype=np.int64)
    rounds, pos = ranks // p, ranks % p
    shard = np.where(rounds % 2 == 0, pos, p - 1 - pos)
    perm = np.empty(n, dtype=np.int32)
    perm[order] = (shard * n_per + rounds).astype(np.int32)
    return Reordering(perm=perm, n_new=int(p * n_per), n_old=n)


def reorder_graph(g: Graph, ro: Reordering):
    """Apply ``ro`` to ``g``. Returns ``(new_graph, edge_perm)`` where
    ``edge_perm[k]`` is the old canonical edge id of the new graph's k-th
    canonical edge (int32 numpy): permute edge tensors with
    ``edata[edge_perm]``.

    The new graph has ``ro.n_new`` nodes (extra ids are isolated padding
    nodes) and lies on ``g``'s device.
    """
    src, dst = _host_edges(g)
    new_src = ro.perm[src].astype(np.int64)
    new_dst = ro.perm[dst].astype(np.int64)
    edge_perm = np.lexsort((new_dst, new_src)).astype(np.int32)
    g2 = from_coo(new_src, new_dst, n_nodes=ro.n_new,
                  pad_to=g.num_edges_padded if g.has_padding else None,
                  device=g.device)
    return g2, edge_perm
