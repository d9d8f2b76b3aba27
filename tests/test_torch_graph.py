"""The port's Graph and tile view against the JAX package's: every index
array must be equal, bit for bit."""

import numpy as np
import jax
import pytest
import torch

import custom_op_benchmark_tpu.graph as jgraph
from custom_op_benchmark_tpu.graph.tiled import tile_graph as jax_tile_graph
import custom_op_benchmark_tpu_torch.graph as tgraph

BUILDERS = {
    "clique": lambda m, **kw: m.clique_batch(8, 30, **kw),
    "powerlaw": lambda m, **kw: m.random_graph(200, 1500, seed=3,
                                               power_law=True, **kw),
    "grid": lambda m, **kw: m.grid_graph(12, 9, **kw),
}
GRAPH_FIELDS = ("src", "dst", "indptr_r", "csc_perm", "csc_perm_inv",
                "indptr_c")
TILE_FIELDS = ("tile_rows", "tile_cols", "tile_ptr", "tile_perm_c",
               "tile_ptr_c", "mask", "edge_tile", "edge_r", "edge_c")
TILE_STATIC = ("n_nodes", "n_edges", "tile_r", "tile_c", "num_row_blocks",
               "num_col_blocks", "num_tiles", "max_tiles_per_row",
               "max_tiles_per_col")


def _same(jax_obj, port_obj, tensors, static=()):
    for name in tensors:
        want = np.asarray(jax.device_get(getattr(jax_obj, name)))
        got = getattr(port_obj, name)
        assert isinstance(got, torch.Tensor), name
        assert got.dtype == (torch.bool if want.dtype == bool
                             else torch.int32), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name in static:
        assert getattr(port_obj, name) == getattr(jax_obj, name), name


@pytest.mark.parametrize("pad", [None, 256])
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_graph_matches_jax(kind, pad):
    jg = BUILDERS[kind](jgraph, pad_multiple=pad)
    g = BUILDERS[kind](tgraph, pad_multiple=pad)
    _same(jg, g, GRAPH_FIELDS, ("n_nodes", "n_edges"))
    _same(jg.reverse(), g.reverse(), GRAPH_FIELDS)
    np.testing.assert_array_equal(g.edge_mask.numpy(),
                                  np.asarray(jg.edge_mask))
    np.testing.assert_array_equal(g.in_degrees().numpy(),
                                  np.asarray(jg.in_degrees()))
    np.testing.assert_array_equal(g.out_degrees().numpy(),
                                  np.asarray(jg.out_degrees()))


@pytest.mark.parametrize("tile", [(8, 8), (16, 32)])
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_tile_view_and_transpose_match_jax(kind, tile):
    jt = jax_tile_graph(BUILDERS[kind](jgraph, pad_multiple=128), *tile)
    tg = tgraph.tile_graph(BUILDERS[kind](tgraph, pad_multiple=128), *tile)
    _same(jt, tg, TILE_FIELDS, TILE_STATIC)
    _same(jt.transpose(), tg.transpose(), TILE_FIELDS, TILE_STATIC)
    _same(jt.transpose().transpose(), tg.transpose().transpose(),
          TILE_FIELDS, TILE_STATIC)


def test_transpose_is_built_once():
    tg = tgraph.tile_graph(tgraph.clique_batch(4, 10), 16, 16)
    t = tg.transpose()
    assert tg.transpose() is t
    assert t.transpose() is tg


def _simple_powerlaw(m, **kw):
    """The power-law graph without its multi-edges: scatter_edges keeps one
    value per (tile, row, col) slot."""
    g = tgraph.random_graph(200, 1500, seed=3, power_law=True)
    pairs = np.unique(np.stack([g.src.numpy(), g.dst.numpy()], 1), axis=0)
    return m.from_coo(pairs[:, 0], pairs[:, 1], 200, **kw)


@pytest.mark.parametrize("kind", ["clique", "grid", "powerlaw"])
def test_scatter_gather_edges_match_jax(kind):
    build = _simple_powerlaw if kind == "powerlaw" else BUILDERS[kind]
    jt = jax_tile_graph(build(jgraph, pad_multiple=128), 16, 16)
    tg = tgraph.tile_graph(build(tgraph, pad_multiple=128), 16, 16)
    vals = np.random.default_rng(0).normal(
        size=(tg.edge_tile.shape[0], 3)).astype(np.float32)
    for jv, pv in ((jt, tg), (jt.transpose(), tg.transpose())):
        want = np.asarray(jv.scatter_edges(vals))
        got = pv.scatter_edges(torch.from_numpy(vals))
        np.testing.assert_array_equal(got.numpy(), want)
        back = pv.gather_edges(got[: pv.num_tiles])
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jv.gather_edges(want[: jv.num_tiles])))
        np.testing.assert_array_equal(back[: tg.n_edges].numpy(),
                                      vals[: tg.n_edges])


def test_from_coo_rejects_bad_input():
    with pytest.raises(ValueError):
        tgraph.from_coo([0, 1], [1], 3)
    with pytest.raises(ValueError):
        tgraph.from_coo([0, 3], [1, 1], 3)
    with pytest.raises(ValueError):
        tgraph.from_coo([0, 1], [1, 1], 3, pad_to=1)
