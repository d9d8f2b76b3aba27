"""Checks of the port's graph views and sampled blocks against the edges
the benchmark generated, in plain PyTorch. Each returns a count of
violations, 0 when the view or block is right.
"""

from __future__ import annotations

import torch


def largest_component(src, dst, n: int) -> int:
    """Nodes in the largest weakly connected component (min-label
    propagation with pointer jumping)."""
    lab = torch.arange(n, device=src.device)
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, dst, lab[src], "amin")
        new.scatter_reduce_(0, src, lab[dst], "amin")
        new = new[new]
        if torch.equal(new, lab):
            return int(torch.bincount(lab, minlength=n).max())
        lab = new


def expected_view(src, dst, n: int, max_block: int = 128) -> str:
    """The view a full-graph step should take: ``block`` where every
    component fits a dense block of ``max_block`` nodes, else ``ell``."""
    return "block" if largest_component(src, dst, n) <= max_block else "ell"


def _multiset_mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    """Keys of ``a`` and ``b`` (int64) that do not pair off."""
    if a.numel() != b.numel():
        return abs(a.numel() - b.numel()) + min(a.numel(), b.numel())
    return int((torch.sort(a).values != torch.sort(b).values).sum())


def ell_view_mismatch(rows_cols: list, own, other, n: int) -> int:
    """Slots of an ELL packing that do not pair off with the edges: each
    bucket's ``(owners (R,), cols (R, D))``, pad value ``n`` in both, must
    hold each edge ``other → own`` once, in the row of ``own``."""
    keys = []
    for owners, cols in rows_cols:
        owners, cols = owners.long(), cols.long()
        real = (owners[:, None] < n) & (cols < n)
        keys.append((owners[:, None] * n + cols)[real])
    got = torch.cat(keys) if keys else own.new_zeros(0)
    return _multiset_mismatch(got, own.long() * n + other.long())


def sample_violations(block: dict, graph_keys, in_degree, n: int,
                      fanouts: list, train_mask) -> int:
    """Violations of one sampled block against the graph.

    ``block`` holds the port's batch: ``node_ids`` (N,) global ids, seeds
    first; ``src``/``dst`` its real edges in local ids (a self-loop for
    each node among them); ``in_cols`` (N, W), pad N; ``seeds`` (B,).
    ``graph_keys``: the graph's ``dst·n + src``, sorted; ``in_degree``:
    each node's in-degree. A node of hop k < len(fanouts) must hold
    min(in-degree, fanouts[k]) distinct in-edges of the graph, a node of
    the last hop none, besides its self-loop; the rest of the nodes come
    after the seeds in ascending id; ``in_cols`` must list each node's
    in-edges; every seed is in the train split.
    """
    ids, src, dst = (block[k].long() for k in ("node_ids", "src", "dst"))
    seeds, cols = block["seeds"].long(), block["in_cols"].long()
    b, big_n = seeds.shape[0], ids.shape[0]
    bad = 0
    n_local = int(dst.max()) + 1 if dst.numel() else 0
    bad += int((ids[:b] != seeds).sum())
    rest = ids[b:n_local]
    bad += int((rest[1:] <= rest[:-1]).sum())
    bad += int(torch.isin(rest, seeds).sum())
    bad += int((~train_mask[seeds]).sum())
    loop = src == dst
    loops = torch.bincount(dst[loop], minlength=n_local)
    bad += int((loops != 1).sum())
    gs, gd = ids[src[~loop]], ids[dst[~loop]]
    key = gd * n + gs
    pos = torch.searchsorted(graph_keys, key).clamp(max=graph_keys.numel() - 1)
    bad += int((graph_keys[pos] != key).sum())
    bad += key.numel() - int(torch.unique(key).numel())
    # Hops: the seeds, then each hop's new sources.
    hop = torch.full((n_local,), -1, dtype=torch.long, device=ids.device)
    hop[:b] = 0
    ls, ld = src[~loop], dst[~loop]
    for k in range(len(fanouts)):
        into = ls[hop[ld] == k]
        fresh = into[hop[into] < 0]
        hop[fresh] = k + 1
    bad += int((hop < 0).sum())
    want = torch.zeros(n_local, dtype=torch.long, device=ids.device)
    for k, f in enumerate(fanouts):
        at = hop == k
        want[at] = in_degree[ids[:n_local][at]].long().clamp(max=f)
    got = torch.bincount(ld, minlength=n_local)
    bad += int((got != want).sum())
    # in_cols against the edges.
    real = cols < big_n
    rows = torch.arange(big_n, device=ids.device)[:, None].expand_as(cols)
    bad += int((rows[real] >= n_local).sum())
    bad += _multiset_mismatch(rows[real] * big_n + cols[real],
                              dst * big_n + src)
    return bad
