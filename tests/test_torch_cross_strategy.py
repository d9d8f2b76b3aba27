"""Cross-strategy fuzz and the strategy advisor, against the JAX package.

The cases of tests/test_cross_strategy.py (every strategy of the port —
segment, ELL, 16×16 tiles, one dense block — agrees on random simple
graphs, and with JAX's segment oracle) and of tests/test_summary.py
(``describe`` on cliques, a power-law graph and a grid, field for field
equal to JAX's summary).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu import ops as jops
from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu.graph import grid_graph as jax_grid_graph
from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.utils.summary import describe as jax_describe
from custom_op_benchmark_tpu_torch import ops as tops
from custom_op_benchmark_tpu_torch.graph import (
    block_graph,
    clique_batch,
    from_coo,
    grid_graph,
    random_graph,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.utils.summary import describe

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", range(5))
def test_all_strategies_agree(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 120))
    e = int(rng.integers(n, 6 * n))
    pairs = np.unique(np.stack([rng.integers(0, n, e),
                                rng.integers(0, n, e)], 1), axis=0)
    src, dst = pairs[:, 0], pairs[:, 1]
    g, jg = from_coo(src, dst, n_nodes=n), jax_from_coo(src, dst, n_nodes=n)
    e = g.n_edges
    d = int(rng.choice([4, 8, 16]))
    A = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.normal(size=(n, d)).astype(np.float32)
    ed = rng.uniform(size=g.num_edges_padded).astype(np.float32)
    tA, tB, ted = map(torch.from_numpy, (A, B, ed))

    se, de = tops.ell_dual(g)
    tg = tile_graph(g, 16, 16)
    bg = block_graph(g, max_block=n)   # one big block is always legal
    assert bg is not None

    with jax.default_matmul_precision("highest"):
        s_ref = np.asarray(jops.sddmm(jg, jnp.asarray(A), jnp.asarray(B)))
        y_ref = np.asarray(jops.vector_spmm(jg, jnp.asarray(ed),
                                            jnp.asarray(A)))
        sm_ref = {by: np.asarray(jops.edge_softmax(jg, jnp.asarray(s_ref),
                                                   by=by))
                  for by in ("src", "dst")}

    s_seg = tops.sddmm(g, tA, tB, impl="xla")
    for s in (s_seg, tops.ell_sddmm(se, de, tA, tB),
              tg.gather_edges(tops.tiled_sddmm(tg, tA, tB)),
              bg.gather_edges(tops.block_sddmm(bg, bg.scatter_nodes(tA),
                                               bg.scatter_nodes(tB)))):
        np.testing.assert_allclose(s.numpy()[:e], s_ref[:e], **TOL)

    ts = torch.tensor(s_ref)
    for by, ell in (("src", se), ("dst", de)):
        np.testing.assert_allclose(tops.ell_softmax(ell, ts).numpy()[:e],
                                   sm_ref[by][:e], **TOL)
        np.testing.assert_allclose(
            bg.gather_edges(tops.block_softmax(
                bg, bg.scatter_edges(ts), by=by)).numpy()[:e],
            sm_ref[by][:e], **TOL)

    vals = tg.scatter_edges(ted)[: tg.num_tiles]
    for y in (tops.vector_spmm(g, ted, tA, impl="xla"),
              tops.ell_spmm(se, de, ted, tA),
              tops.tiled_spmm(tg, vals, tA),
              bg.gather_nodes(tops.block_spmm(bg, bg.scatter_edges(ted),
                                              bg.scatter_nodes(tA)))):
        np.testing.assert_allclose(y.numpy(), y_ref, **TOL)


def _same_summary(s, js):
    for f in dataclasses.fields(js):
        a, b = getattr(s, f.name), getattr(js, f.name)
        if isinstance(b, float):
            assert a == pytest.approx(b), f.name
        else:
            assert a == b, f.name


def test_describe_clique():
    s = describe(clique_batch(8, 10))
    assert s.n_nodes == 80 and s.n_edges == 800
    assert s.num_components == 8 and s.max_component == 10
    assert s.recommended == "dense_block"
    assert "dense_block" in str(s)
    _same_summary(s, jax_describe(jax_clique_batch(8, 10)))


def test_describe_powerlaw():
    s = describe(random_graph(5000, 20000, seed=0, power_law=True))
    assert s.max_out_degree >= 50
    assert s.recommended == "ell"
    _same_summary(s, jax_describe(jax_random_graph(5000, 20000, seed=0,
                                                   power_law=True)))


def test_describe_grid_recommends_tiled():
    s = describe(grid_graph(64, 64))
    assert s.recommended.startswith("tiled"), s.recommended
    _same_summary(s, jax_describe(jax_grid_graph(64, 64)))
