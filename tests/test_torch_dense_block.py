"""The port's dense-block layout and ops against the JAX package's.

The cases of tests/test_dense_block.py, each run through both packages on
the same numpy inputs: ``block_graph`` and the node/edge scatter and
gather (with their gather-only VJPs), and every block op, forward and the
VJP of one random cotangent, to 1e-5 (both are f32 products summed in
other orders; the reference runs at "highest" matmul precision). The
port's block ops are also held to its own segment oracle, as the
reference's tests hold JAX's (their bf16 case is in
tests/test_torch_dtypes.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu import ops as jops
from custom_op_benchmark_tpu.graph import block_graph as jax_block_graph
from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu_torch import ops as tops
from custom_op_benchmark_tpu_torch.graph import (
    block_graph,
    clique_batch,
    from_coo,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    g, jg = clique_batch(7, 9), jax_clique_batch(7, 9)
    bg, jbg = block_graph(g), jax_block_graph(jg)
    assert bg is not None and jbg is not None
    return g, jg, bg, jbg


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(jfn, tfn, args, *, tol=TOL, cot_seed=99):
    """Forward and the VJP of one random cotangent, both packages."""
    with jax.default_matmul_precision("highest"):
        jout, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
        cot = _normal(cot_seed, *jout.shape)
        jgrads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*ts)
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **tol)
    for t, j in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **tol)


def test_block_graph_detects():
    g = clique_batch(4, 5)
    bg = block_graph(g)
    assert bg is not None
    assert bg.num_blocks == 4 and bg.block_len == 5
    assert int(bg.adj.sum()) == g.n_edges
    assert block_graph(g, max_block=4) is None


def test_block_graph_arrays_equal_jax(setup):
    g, jg, bg, jbg = setup
    for name in ("node_slot", "slot_node", "adj", "edge_slot", "slot_edge",
                 "node_mask"):
        np.testing.assert_array_equal(getattr(bg, name).numpy(),
                                      np.asarray(getattr(jbg, name)),
                                      err_msg=name)
    assert (bg.num_blocks, bg.block_len) == (jbg.num_blocks, jbg.block_len)


def test_block_graph_irregular_components():
    """Two components of different sizes (path 0-1-2 and edge 3-4) and an
    isolated node."""
    src = np.array([0, 1, 1, 2, 3, 4])
    dst = np.array([1, 0, 2, 1, 4, 3])
    g, jg = from_coo(src, dst, n_nodes=6), jax_from_coo(src, dst, n_nodes=6)
    bg, jbg = block_graph(g), jax_block_graph(jg)
    assert bg is not None and bg.block_len == 3
    ed = np.arange(g.n_edges, dtype=np.float32) + 1.0
    x = _normal(3, 6, 4)
    _check(lambda e, v: jbg.gather_nodes(jops.block_spmm(
               jbg, jbg.scatter_edges(e), jbg.scatter_nodes(v))),
           lambda e, v: bg.gather_nodes(tops.block_spmm(
               bg, bg.scatter_edges(e), bg.scatter_nodes(v))),
           [ed, x])
    y = bg.gather_nodes(tops.block_spmm(bg, bg.scatter_edges(
        torch.from_numpy(ed)), bg.scatter_nodes(torch.from_numpy(x))))
    y_seg = tops.vector_spmm(g, torch.from_numpy(ed), torch.from_numpy(x),
                             impl="xla")
    torch.testing.assert_close(y, y_seg, **TOL)


def test_block_graph_refuses_a_multigraph():
    g = from_coo(np.array([0, 0, 1]), np.array([1, 1, 0]), n_nodes=2)
    assert block_graph(g) is None


def test_scatter_gather_roundtrip(setup):
    g, _, bg, _ = setup
    x = torch.from_numpy(_normal(0, g.n_nodes, 5))
    assert torch.equal(bg.gather_nodes(bg.scatter_nodes(x)), x)
    ed = torch.from_numpy(_normal(1, g.num_edges_padded))
    assert torch.equal(bg.gather_edges(bg.scatter_edges(ed)), ed)


@pytest.mark.parametrize("which", ["nodes", "edges"])
def test_layout_conversions_match_jax_with_their_vjps(setup, which):
    g, _, bg, jbg = setup
    if which == "nodes":
        x = _normal(2, g.n_nodes, 2, 3)
        _check(lambda v: jbg.gather_nodes(jbg.scatter_nodes(v) * 2.0),
               lambda v: bg.gather_nodes(bg.scatter_nodes(v) * 2.0), [x])
        _check(lambda v: jbg.scatter_nodes(v), lambda v: bg.scatter_nodes(v),
               [x])
    else:
        ed = _normal(4, g.num_edges_padded, 3)
        _check(lambda e: jbg.gather_edges(jbg.scatter_edges(e) * 2.0),
               lambda e: bg.gather_edges(bg.scatter_edges(e) * 2.0), [ed])
        _check(lambda e: jbg.scatter_edges(e), lambda e: bg.scatter_edges(e),
               [ed])


@pytest.mark.parametrize("multihead", [False, True])
def test_block_sddmm(setup, multihead):
    g, _, bg, jbg = setup
    shape = (g.n_nodes, 2, 6) if multihead else (g.n_nodes, 6)
    _check(lambda a, b: jbg.gather_edges(jops.block_sddmm(
               jbg, jbg.scatter_nodes(a), jbg.scatter_nodes(b))),
           lambda a, b: bg.gather_edges(tops.block_sddmm(
               bg, bg.scatter_nodes(a), bg.scatter_nodes(b))),
           [_normal(5, *shape), _normal(6, *shape)])


def test_block_node_mul_edge(setup):
    g, _, bg, jbg = setup
    _check(lambda a, b: jbg.gather_edges(jops.block_node_mul_edge(
               jbg, jbg.scatter_nodes(a), jbg.scatter_edges(b))),
           lambda a, b: bg.gather_edges(tops.block_node_mul_edge(
               bg, bg.scatter_nodes(a), bg.scatter_edges(b))),
           [_normal(7, g.n_nodes, 2, 6), _normal(8, g.n_edges, 6)])


@pytest.mark.parametrize("by", ["src", "dst"])
@pytest.mark.parametrize("multihead", [False, True])
def test_block_softmax(setup, by, multihead):
    g, _, bg, jbg = setup
    shape = (g.n_edges, 3) if multihead else (g.n_edges,)
    _check(lambda s: jbg.gather_edges(jops.block_softmax(
               jbg, jbg.scatter_edges(s), by=by)),
           lambda s: bg.gather_edges(tops.block_softmax(
               bg, bg.scatter_edges(s), by=by)),
           [_normal(9, *shape)])
    s = torch.from_numpy(_normal(9, *shape))
    torch.testing.assert_close(
        bg.gather_edges(tops.block_softmax(bg, bg.scatter_edges(s), by=by)),
        tops.edge_softmax(g, s, by=by, impl="xla"), **TOL)


@pytest.mark.parametrize("multihead", [False, True])
def test_block_spmm_fwd_bwd(setup, multihead):
    g, _, bg, jbg = setup
    if multihead:
        args = [_normal(10, g.n_edges, 2), _normal(11, g.n_nodes, 2, 6)]
    else:
        args = [_normal(10, g.n_edges), _normal(11, g.n_nodes, 6)]
    _check(lambda e, x: jbg.gather_nodes(jops.block_spmm(
               jbg, jbg.scatter_edges(e), jbg.scatter_nodes(x))),
           lambda e, x: bg.gather_nodes(tops.block_spmm(
               bg, bg.scatter_edges(e), bg.scatter_nodes(x))), args)


@pytest.mark.parametrize("normalize", ["src", "dst"])
@pytest.mark.parametrize("multihead", [False, True])
def test_block_attention(setup, normalize, multihead):
    g, _, bg, jbg = setup
    shape = (g.n_nodes, 2, 8) if multihead else (g.n_nodes, 8)
    _check(lambda q, k, v: jbg.gather_nodes(jops.block_attention(
               jbg, jbg.scatter_nodes(q), jbg.scatter_nodes(k),
               jbg.scatter_nodes(v), normalize=normalize)),
           lambda q, k, v: bg.gather_nodes(tops.block_attention(
               bg, bg.scatter_nodes(q), bg.scatter_nodes(k),
               bg.scatter_nodes(v), normalize=normalize)),
           [_normal(12 + i, *shape) for i in range(3)])


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_block_copy_spmm(setup, reduce):
    g, _, bg, jbg = setup
    _check(lambda x: jbg.gather_nodes(jops.block_copy_spmm(
               jbg, jbg.scatter_nodes(x), reduce=reduce)),
           lambda x: bg.gather_nodes(tops.block_copy_spmm(
               bg, bg.scatter_nodes(x), reduce=reduce)),
           [_normal(15, g.n_nodes, 6)])


def test_block_gat_attention(setup):
    g, _, bg, jbg = setup
    _check(lambda al, ar, z: jbg.gather_nodes(jops.block_gat_attention(
               jbg, al, ar, jbg.scatter_nodes(z))),
           lambda al, ar, z: bg.gather_nodes(tops.block_gat_attention(
               bg, al, ar, bg.scatter_nodes(z))),
           [_normal(16, 2, 6), _normal(17, 2, 6),
            _normal(18, g.n_nodes, 2, 6)])
