"""Fanout neighbour sampling on the host into fixed-shape minibatches.

Counterpart of custom_op_benchmark_tpu/data/sampling.py. A batch is the
layered in-neighbourhood of its seeds (``fanouts[h]`` in-edges drawn per
node of hop h), renumbered locally with the seeds first, as a padded
:class:`~custom_op_benchmark_tpu_torch.graph.graph.Graph` on the host, plus
the dense in-neighbour matrix ``in_cols`` (one ELL bucket: every sampled
in-degree is at most ``max(fanouts) + 1``). Every batch of a sampler has
the same shapes.

The native whole-batch sampler (``graphcore_sample_subgraph``, the port's
own csrc/graphcore.cpp) runs where the library builds; the numpy path is
the reference's fall-back. The per-call seeds come from
``np.random.default_rng(seed)`` in the reference's order, so one seed
gives the same batches as the JAX package, native against native and
numpy against numpy (the two paths draw differently).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from custom_op_benchmark_tpu_torch.graph import native as _native
from custom_op_benchmark_tpu_torch.graph.graph import (
    Graph,
    _round_up,
    from_coo,
)


@dataclasses.dataclass
class SampledBatch:
    """One minibatch: a padded local subgraph and the global node ids.

    ``node_ids[i]`` is the global id of local node ``i`` (the padded tail
    repeats node 0 with ``node_mask`` False); the first ``num_seeds``
    local nodes are the seeds. ``in_cols`` ``(max_nodes, W)`` int32 lists
    each node's sampled in-neighbours (pad slot ``max_nodes``).
    """

    graph: Graph
    node_ids: np.ndarray       # (max_nodes,) int32, global ids
    node_mask: np.ndarray      # (max_nodes,) bool
    seed_ids: np.ndarray       # (batch_size,) int32 global seed ids
    seed_mask: np.ndarray      # (batch_size,) bool, False on padded seeds
    in_cols: np.ndarray        # (max_nodes, W) int32
    num_seeds: int


class NeighborSampler:
    """Layered in-neighbour sampler with per-hop fanouts (e.g. [25, 10])."""

    def __init__(self, g: Graph, fanouts: Sequence[int], *, seed: int = 0,
                 n_threads: Optional[int] = None):
        self.fanouts = list(fanouts)
        if n_threads is None:
            n_threads = int(os.environ.get("GRAPHCORE_THREADS",
                                           os.cpu_count() or 1))
        self.n_threads = max(1, n_threads)
        self.n_nodes = g.n_nodes
        # int32-contiguous CSC arrays, the layout the native sampler takes,
        # so no hop re-casts the whole index array.
        self._indptr = np.ascontiguousarray(
            g.indptr_c.cpu().numpy()[: g.n_nodes + 1], np.int32)
        self._indices = np.ascontiguousarray(g.src_csc.cpu().numpy(),
                                             np.int32)
        self._rng = np.random.default_rng(seed)

    def _sample_in_edges(self, seeds: np.ndarray, fanout: int):
        """For each seed, at most ``fanout`` in-edges (u → seed): (src,
        dst) int64."""
        out = _native.sample_in_edges_native(
            self._indptr, self._indices, self.n_nodes, seeds, fanout,
            int(self._rng.integers(0, 2**63 - 1)))
        if out is not None:
            return out[0].astype(np.int64), out[1].astype(np.int64)
        lo = self._indptr[seeds]
        deg = self._indptr[seeds + 1] - lo
        take = np.minimum(deg, fanout)
        total = int(take.sum())
        src = np.empty(total, np.int64)
        dst = np.empty(total, np.int64)
        pos = 0
        for s, l, d, t in zip(seeds, lo, deg, take):
            if t == 0:
                continue
            if d <= fanout:
                sel = self._indices[l: l + d]
            else:
                sel = self._indices[
                    l + self._rng.choice(d, size=t, replace=False)]
            src[pos: pos + t] = sel
            dst[pos: pos + t] = s
            pos += t
        return src[:pos], dst[:pos]

    def max_shapes(self, batch_size: int):
        """The static (max_nodes, max_edges) bound for a seed batch."""
        nodes, edges, frontier = batch_size, 0, batch_size
        for f in self.fanouts:
            edges += frontier * f
            frontier *= f
            nodes += frontier
        edges += nodes     # a self-loop for every node
        return (_round_up(min(nodes, self.n_nodes * 2), 8),
                _round_up(edges, 128))

    def sample(self, seeds: np.ndarray, *,
               add_self_loops: bool = True) -> SampledBatch:
        """Sample the layered in-neighbourhood subgraph of ``seeds``."""
        seeds = np.asarray(seeds, np.int64)
        batch_size = len(seeds)
        max_nodes, max_edges = self.max_shapes(batch_size)
        w = _round_up(max(self.fanouts) + 1, 8)

        nat = _native.sample_subgraph_native(
            self._indptr, self._indices, self.n_nodes, seeds, self.fanouts,
            int(self._rng.integers(0, 2**63 - 1)),
            add_self_loops=add_self_loops, max_nodes=max_nodes,
            max_edges=max_edges, w=w, n_threads=self.n_threads)
        if nat is not None:
            node_ids, n_local, lsrc, ldst, ne, in_cols = nat
            g = from_coo(lsrc[:ne], ldst[:ne], max_nodes, pad_to=max_edges)
            node_mask = np.zeros(max_nodes, bool)
            node_mask[:n_local] = True
            return SampledBatch(graph=g, node_ids=node_ids,
                                node_mask=node_mask,
                                seed_ids=seeds.astype(np.int32),
                                seed_mask=np.ones(batch_size, bool),
                                in_cols=in_cols, num_seeds=batch_size)
        return self._sample_numpy(seeds, max_nodes, max_edges, w,
                                  add_self_loops)

    def _sample_numpy(self, seeds, max_nodes, max_edges, w, add_self_loops):
        # Layered expansion with a visited bitmap: each hop's frontier is
        # the set of sources first reached in that hop, ascending.
        all_src, all_dst = [], []
        seed_bit = np.zeros(self.n_nodes, bool)
        seed_bit[seeds] = True
        visited_bit = seed_bit.copy()
        frontier = np.flatnonzero(seed_bit)
        for f in self.fanouts:
            s, d = self._sample_in_edges(frontier, f)
            all_src.append(s)
            all_dst.append(d)
            newly = np.zeros(self.n_nodes, bool)
            newly[s] = True
            newly &= ~visited_bit
            visited_bit |= newly
            frontier = np.flatnonzero(newly)
        src = np.concatenate(all_src) if all_src else np.empty(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.empty(0, np.int64)

        # Seeds first (their order), then the rest ascending; a batch over
        # the static bound drops the deepest extras (never seeds) and their
        # edges instead of failing.
        rest = np.flatnonzero(visited_bit & ~seed_bit)
        node_ids_real = np.concatenate([seeds, rest])[:max_nodes]
        n_local = len(node_ids_real)
        lookup = np.full(self.n_nodes, -1, np.int64)
        lookup[node_ids_real] = np.arange(n_local)
        lsrc, ldst = lookup[src], lookup[dst]
        keep = (lsrc >= 0) & (ldst >= 0)
        lsrc, ldst = lsrc[keep], ldst[keep]
        if add_self_loops:
            loops = np.arange(n_local)
            lsrc = np.concatenate([lsrc, loops])
            ldst = np.concatenate([ldst, loops])
        lsrc, ldst = lsrc[:max_edges], ldst[:max_edges]
        g = from_coo(lsrc, ldst, max_nodes, pad_to=max_edges)

        # The in-neighbour matrix from the graph's CSC views: the slot of
        # CSC position k is k - indptr_c[dst].
        perm = g.csc_perm.numpy().astype(np.int64)
        dst_csc = g.dst.numpy()[perm].astype(np.int64)
        src_csc = g.src.numpy()[perm]
        indptr_c = g.indptr_c.numpy().astype(np.int64)
        slot = np.arange(len(dst_csc), dtype=np.int64) - indptr_c[dst_csc]
        real = dst_csc < max_nodes
        # sampled_copy_spmm's VJP runs over the batch graph's edges, so a
        # dropped slot would make the gradient disagree with the forward.
        if real.any() and int(slot[real].max()) >= w:
            raise AssertionError(
                f"sampled in-degree {int(slot[real].max()) + 1} exceeds "
                f"the dense-ELL width {w}; sampler invariant broken")
        in_cols = np.full((max_nodes, w), max_nodes, np.int32)
        in_cols[dst_csc[real], slot[real]] = src_csc[real]

        node_ids = np.zeros(max_nodes, np.int32)
        node_ids[:n_local] = node_ids_real
        node_mask = np.zeros(max_nodes, bool)
        node_mask[:n_local] = True
        return SampledBatch(graph=g, node_ids=node_ids, node_mask=node_mask,
                            seed_ids=seeds.astype(np.int32),
                            seed_mask=np.ones(len(seeds), bool),
                            in_cols=in_cols, num_seeds=len(seeds))

    def epoch(self, train_ids: np.ndarray, batch_size: int, *,
              shuffle: bool = True, drop_last: bool = True):
        """Yield SampledBatches covering ``train_ids`` once."""
        ids = np.asarray(train_ids)
        if shuffle:
            ids = self._rng.permutation(ids)
        end = (len(ids) // batch_size) * batch_size if drop_last else len(ids)
        for i in range(0, end, batch_size):
            chunk = ids[i: i + batch_size]
            if len(chunk) < batch_size:
                pad = np.zeros(batch_size - len(chunk), chunk.dtype)
                b = self.sample(np.concatenate([chunk, pad]))
                b.seed_mask[len(chunk):] = False
                yield b
            else:
                yield self.sample(chunk)
