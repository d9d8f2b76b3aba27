"""Locality clustering: BFS-grown balanced partitions (host-side numpy).

Counterpart of custom_op_benchmark_tpu/graph/cluster.py. The halo plan's
communication volume is the partition's edge cut (parallel/halo.py).
Contiguous ownership (``id // n_per``) cuts almost every edge of an
arbitrarily numbered graph; renumbering nodes so that neighbourhoods are
contiguous keeps most edges inside a shard — the METIS role, filled by a
multi-seed BFS growth with no external dependency. Same seeds and the
same steps as the reference, so the same :class:`Reordering`; the
refinement's neighbour counts are one ``bincount`` a sweep instead of
``np.add.at`` (the same integers).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from custom_op_benchmark_tpu_torch.graph.reorder import Reordering


def _refine(part, src, dst, n, num_parts, n_per, iters=10, seed=0):
    """Balanced label-propagation refinement (Kernighan-Lin-lite): each
    sweep moves nodes toward the part holding most of their neighbours,
    greedily by gain, under the per-part capacity ``n_per``."""
    rng = np.random.default_rng(seed)
    for _ in range(iters):
        keys = np.concatenate([src * num_parts + part[dst],
                               dst * num_parts + part[src]])
        counts = np.bincount(keys, minlength=n * num_parts).reshape(
            n, num_parts).astype(np.int32)
        cur_cnt = counts[np.arange(n), part]
        best = np.argmax(counts, axis=1)
        gain = counts[np.arange(n), best] - cur_cnt
        movers = np.nonzero((gain > 0) & (best != part))[0]
        if len(movers) == 0:
            break
        # Greedy by gain (random tie-break), capacity-constrained.
        movers = movers[np.argsort(-(gain[movers] * n
                                     + rng.integers(0, n, len(movers))))]
        size = np.bincount(part, minlength=num_parts)
        moved = 0
        best_l, size_l = best.tolist(), size.tolist()
        for v in movers.tolist():
            b, a = best_l[v], int(part[v])
            if size_l[b] < n_per and size_l[a] > 1:
                size_l[a] -= 1
                size_l[b] += 1
                part[v] = b
                moved += 1
        if moved == 0:
            break
    return part


def cluster_order(g, num_parts: int, *, seed: int = 0,
                  refine_iters: int = 10) -> Reordering:
    """Renumber nodes by BFS-grown, label-propagation-refined balanced
    clusters.

    Phase 1 grows ``num_parts`` equal parts by BFS from high-degree seeds;
    phase 2 refines with capacity-constrained label propagation. New ids
    are sorted by (part, old id), so part ``p`` owns a contiguous id range
    (with ~12 % slack for the refinement's moves; the gaps are isolated
    padding nodes) — the ownership rule of ``parallel.halo.halo_graph``.
    """
    n, e = g.n_nodes, g.n_edges
    src = g.src.cpu().numpy()[:e].astype(np.int64)
    dst = g.dst.cpu().numpy()[:e].astype(np.int64)

    # Undirected CSR adjacency.
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=indptr[1:])
    deg = np.diff(indptr)

    n_per = -(-n // num_parts)
    perm = np.full(n, -1, dtype=np.int32)
    queued = [False] * n
    by_degree = np.argsort(-deg, kind="stable")
    ptr_l, nbr_l, by_deg_l = indptr.tolist(), v.tolist(), by_degree.tolist()
    placed = [False] * n
    next_seed = 0
    assigned = 0
    frontier: deque = deque()
    part_room = n_per

    while assigned < n:
        if not frontier:
            while next_seed < n and placed[by_deg_l[next_seed]]:
                next_seed += 1
            if next_seed >= n:
                break
            frontier.append(by_deg_l[next_seed])
        node = frontier.popleft()            # breadth-first growth
        if placed[node]:
            continue
        placed[node] = True
        perm[node] = assigned
        assigned += 1
        part_room -= 1
        if part_room == 0:
            # Start the next part fresh from a new high-degree seed.
            frontier.clear()
            queued = [False] * n
            part_room = n_per
            continue
        for nb in nbr_l[ptr_l[node]:ptr_l[node + 1]]:
            if not placed[nb] and not queued[nb]:
                queued[nb] = True
                frontier.append(nb)

    part = (perm // n_per).astype(np.int32)
    # Refinement capacity gets ~12 % slack: with exactly full parts no
    # single move is legal.
    cap = n_per + max(1, (12 * n_per) // 100)
    if refine_iters > 0 and e > 0:
        part = _refine(part, src, dst, n, num_parts, cap,
                       iters=refine_iters, seed=seed)
    # New ids sorted by (part, old id); part p owns [p·cap, (p+1)·cap).
    order = np.lexsort((np.arange(n), part))
    sorted_part = part[order]
    starts = np.searchsorted(sorted_part, np.arange(num_parts))
    rank = np.arange(n) - starts[sorted_part]
    perm = np.empty(n, dtype=np.int32)
    perm[order] = (sorted_part.astype(np.int64) * cap + rank).astype(
        np.int32)
    return Reordering(perm=perm, n_new=int(num_parts * cap), n_old=n)
