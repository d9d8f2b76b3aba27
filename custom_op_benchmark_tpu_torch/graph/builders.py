"""Synthetic graph builders (host-side fixtures and benchmark workloads)."""

from __future__ import annotations

import numpy as np

from custom_op_benchmark_tpu_torch.graph.graph import Graph, from_coo


def clique_batch(batch_size: int = 512, length: int = 30, **kw) -> Graph:
    """``batch_size`` disjoint ``length``-node cliques with self-loops.

    The block-diagonal mask of batched dense self-attention; 512×30 gives
    n=15,360 nodes and e=460,800 edges.
    """
    l, b = length, batch_size
    base = np.arange(b, dtype=np.int64)[:, None, None] * l
    x = np.arange(l, dtype=np.int64)[None, :, None]
    y = np.arange(l, dtype=np.int64)[None, None, :]
    src = (base + x + 0 * y).reshape(-1)
    dst = (base + 0 * x + y).reshape(-1)
    return from_coo(src, dst, n_nodes=b * l, **kw)


def random_graph(n_nodes: int, n_edges: int, *, seed: int = 0,
                 power_law: bool = False, self_loops: bool = True,
                 **kw) -> Graph:
    """A random directed multigraph (uniform or Zipf-skewed sources).

    Draws from ``np.random.default_rng(seed)`` in the same order as the JAX
    package's builder, so one seed gives the same graph in both.
    """
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 / np.arange(1, n_nodes + 1) ** 0.75
        w /= w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=w)
        dst = rng.integers(0, n_nodes, size=n_edges)
    else:
        src = rng.integers(0, n_nodes, size=n_edges)
        dst = rng.integers(0, n_nodes, size=n_edges)
    if self_loops:
        loops = np.arange(n_nodes, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    return from_coo(src, dst, n_nodes=n_nodes, **kw)


def grid_graph(rows: int, cols: int, **kw) -> Graph:
    """A 4-neighbour 2-D grid with self-loops."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    edges = [(idx.ravel(), idx.ravel()),
             (idx[:-1, :].ravel(), idx[1:, :].ravel()),
             (idx[1:, :].ravel(), idx[:-1, :].ravel()),
             (idx[:, :-1].ravel(), idx[:, 1:].ravel()),
             (idx[:, 1:].ravel(), idx[:, :-1].ravel())]
    src = np.concatenate([a for a, _ in edges])
    dst = np.concatenate([b for _, b in edges])
    return from_coo(src, dst, n_nodes=rows * cols, **kw)


def _edges(g: Graph):
    """The real (unpadded) edges of ``g`` as int64 host arrays."""
    src = g.src.cpu().numpy()[: g.n_edges].astype(np.int64)
    dst = g.dst.cpu().numpy()[: g.n_edges].astype(np.int64)
    return src, dst


def add_self_loops(g: Graph, **kw) -> Graph:
    """``g`` with one self-loop at every node that has none (Â = A + I for
    GCN-style models; existing loops are not doubled). ``kw`` goes to
    :func:`from_coo`."""
    src, dst = _edges(g)
    has_loop = np.zeros(g.n_nodes, dtype=bool)
    has_loop[src[src == dst]] = True
    need = np.flatnonzero(~has_loop)
    return from_coo(np.concatenate([src, need]), np.concatenate([dst, need]),
                    n_nodes=g.n_nodes, **kw)


def remove_duplicate_edges(g: Graph, **kw) -> Graph:
    """``g`` with its multi-edges collapsed to one (simple-graph
    semantics, which the dense-block view needs; the segment and ELL paths
    keep multigraph semantics). ``kw`` goes to :func:`from_coo`."""
    src, dst = _edges(g)
    uniq = np.unique(src * g.n_nodes + dst)
    return from_coo(uniq // g.n_nodes, uniq % g.n_nodes, n_nodes=g.n_nodes,
                    **kw)
