"""The port's node reordering (graph/reorder.py) against the JAX package's.

The JAX package labels components with its native union-find when
libgraphcore is built (union by size: the root is any member) and with its
Python fallback otherwise (the root is the smallest id); the group order of
``tile_aligned_order`` follows the labels. The port labels by the smallest
id, so its ``perm`` equals the fallback's bit for bit on every graph, and
the native path's where both roots agree (cliques, the grid). The cases of
tests/test_reorder.py that need no ELL or dense blocks are ported here
too, run through the port's segment and tiled ops.
"""

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.graph import grid_graph as jax_grid_graph
from custom_op_benchmark_tpu.graph import native as jax_native
from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.graph import reorder as jax_reorder
from custom_op_benchmark_tpu_torch.graph import (
    clique_batch,
    connected_components,
    degree_balanced_order,
    grid_graph,
    random_graph,
    reorder_graph,
    tile_aligned_order,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops import sddmm, tiled_spmm, vector_spmm

TOL = dict(rtol=1e-5, atol=1e-5)

GRAPHS = {
    "random": (lambda: jax_random_graph(300, 200, seed=0, self_loops=False),
               lambda: random_graph(300, 200, seed=0, self_loops=False)),
    "power_law": (lambda: jax_random_graph(500, 400, seed=3, power_law=True,
                                           self_loops=False),
                  lambda: random_graph(500, 400, seed=3, power_law=True,
                                       self_loops=False)),
    "cliques": (lambda: jax_clique_batch(13, 30), lambda: clique_batch(13, 30)),
    "grid": (lambda: jax_grid_graph(24, 24), lambda: grid_graph(24, 24)),
}


def _edges(g):
    return np.asarray(g.src)[: g.n_edges], np.asarray(g.dst)[: g.n_edges]


@pytest.fixture
def jax_fallback(monkeypatch):
    """The JAX package's pure-Python union-find (no native library)."""
    monkeypatch.setattr(jax_native, "connected_components_native",
                        lambda *a: None)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_labels_and_perm_match_the_fallback(name, jax_fallback):
    jg, g = GRAPHS[name][0](), GRAPHS[name][1]()
    src, dst = _edges(jg)
    np.testing.assert_array_equal(connected_components(src, dst, g.n_nodes),
                                  jax_reorder.connected_components(
                                      src, dst, jg.n_nodes))
    for block in (16, 128):
        want = jax_reorder.tile_aligned_order(jg, block)
        got = tile_aligned_order(g, block)
        np.testing.assert_array_equal(got.perm, want.perm)
        assert (got.n_new, got.n_old) == (want.n_new, want.n_old)
        jg2, jeperm = jax_reorder.reorder_graph(jg, want)
        g2, eperm = reorder_graph(g, got)
        np.testing.assert_array_equal(eperm, jeperm)
        np.testing.assert_array_equal(g2.src.numpy(), np.asarray(jg2.src))
        np.testing.assert_array_equal(g2.dst.numpy(), np.asarray(jg2.dst))
        assert g2.n_nodes == jg2.n_nodes


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_components_match_the_native_partition(name):
    """Whatever roots the native union-find picks, the components agree;
    where its roots are the smallest ids, so does perm."""
    jg, g = GRAPHS[name][0](), GRAPHS[name][1]()
    src, dst = _edges(jg)
    ours = connected_components(src, dst, g.n_nodes)
    theirs = jax_reorder.connected_components(src, dst, jg.n_nodes)
    # Same partition: one-to-one between the two labellings.
    pairs = set(zip(ours.tolist(), theirs.tolist()))
    assert len(pairs) == len(set(ours.tolist())) == len(set(theirs.tolist()))
    if name in ("cliques", "grid"):
        np.testing.assert_array_equal(
            tile_aligned_order(g, 128).perm,
            jax_reorder.tile_aligned_order(jg, 128).perm)


def test_connected_components_cliques():
    g = clique_batch(5, 4)
    labels = connected_components(*_edges(g), 20)
    assert len(np.unique(labels)) == 5
    for c in range(5):
        assert len(np.unique(labels[c * 4: (c + 1) * 4])) == 1


def test_aligned_order_no_straddle():
    g = clique_batch(13, 30)
    ro = tile_aligned_order(g, block=128)
    labels = connected_components(*_edges(g), g.n_nodes)
    for lab in np.unique(labels):
        new_ids = ro.perm[labels == lab]
        assert new_ids.min() // 128 == new_ids.max() // 128
    assert len(np.unique(ro.perm)) == g.n_nodes
    assert ro.n_new % 128 == 0


def test_aligned_tiling_is_diagonal():
    g = clique_batch(16, 30)
    g2, _ = reorder_graph(g, tile_aligned_order(g, block=128))
    tg = tile_graph(g2, 128, 128)
    assert tg.num_tiles == tg.num_row_blocks
    assert torch.equal(tg.tile_rows, tg.tile_cols)


def test_scatter_gather_nodes_round_trip():
    g = clique_batch(5, 30)
    ro = tile_aligned_order(g, block=128)
    x = torch.randn(g.n_nodes, 2, 3, generator=torch.Generator().manual_seed(0))
    y = ro.scatter_nodes(x)
    assert y.shape == (ro.n_new, 2, 3)
    assert torch.equal(ro.gather_nodes(y), x)
    pad = torch.ones(ro.n_new, dtype=torch.bool)
    pad[torch.from_numpy(ro.perm.astype(np.int64))] = False
    assert not y[pad].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_reordered_ops_match(seed):
    rng = np.random.default_rng(seed)
    g = random_graph(60, 400, seed=seed)
    ro = tile_aligned_order(g, block=16)
    g2, eperm = reorder_graph(g, ro)
    assert g2.n_edges == g.n_edges
    eperm = torch.from_numpy(eperm.astype(np.int64))
    d = 8
    x = torch.from_numpy(rng.normal(size=(g.n_nodes, d)).astype(np.float32))
    edata = torch.from_numpy(rng.uniform(size=g.n_edges).astype(np.float32))
    y = vector_spmm(g, edata, x, impl="xla")
    y2 = vector_spmm(g2, edata[eperm], ro.scatter_nodes(x), impl="xla")
    np.testing.assert_allclose(ro.gather_nodes(y2).numpy(), y.numpy(), **TOL)
    A = torch.from_numpy(rng.normal(size=(g.n_nodes, d)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(g.n_nodes, d)).astype(np.float32))
    s = sddmm(g, A, B, impl="xla")
    s2 = sddmm(g2, ro.scatter_nodes(A), ro.scatter_nodes(B), impl="xla")
    np.testing.assert_allclose(s2.numpy(), s[eperm].numpy(), **TOL)


def test_reordered_tiled_spmm_matches_xla():
    g = clique_batch(6, 30)
    ro = tile_aligned_order(g, block=128)
    g2, eperm = reorder_graph(g, ro)
    tg = tile_graph(g2, 128, 128)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(g.n_nodes, 32)).astype(np.float32))
    edata = torch.from_numpy(rng.uniform(size=g.n_edges).astype(np.float32))
    y_ref = vector_spmm(g, edata, x, impl="xla")
    vals = tg.scatter_edges(edata[torch.from_numpy(eperm.astype(np.int64))])
    y2 = tiled_spmm(tg, vals[: tg.num_tiles], ro.scatter_nodes(x))
    np.testing.assert_allclose(ro.gather_nodes(y2).numpy(), y_ref.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_degree_balanced_order_matches_jax():
    """perm equals JAX's bit for bit, and ops on the reordered graph match
    the original (a pure relabel)."""
    jg = jax_random_graph(2048, 40_000, seed=0, power_law=True)
    g = random_graph(2048, 40_000, seed=0, power_law=True)
    want = jax_reorder.degree_balanced_order(jg, 8)
    ro = degree_balanced_order(g, 8)
    np.testing.assert_array_equal(ro.perm, want.perm)
    assert ro.n_new == want.n_new
    assert len(np.unique(ro.perm)) == g.n_nodes
    g2, eperm = reorder_graph(g, ro)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(g.n_nodes, 4)).astype(np.float32))
    ed = torch.from_numpy(
        rng.uniform(size=g.num_edges_padded).astype(np.float32))
    y_ref = vector_spmm(g.reverse(), ed[g.csc_perm.long()], x, impl="xla")
    ed2 = ed[torch.from_numpy(eperm.astype(np.int64))]
    y2 = vector_spmm(g2.reverse(), ed2[g2.csc_perm.long()],
                     ro.scatter_nodes(x), impl="xla")
    np.testing.assert_allclose(ro.gather_nodes(y2).numpy(), y_ref.numpy(),
                               rtol=1e-4, atol=1e-4)
