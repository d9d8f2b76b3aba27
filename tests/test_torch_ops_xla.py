"""The port's segment oracle and public op API against the JAX package's.

Same numpy inputs and cotangents go through JAX's ops at ``impl="xla"``
and the port's; forward outputs and every gradient must agree to
rtol/atol 1e-5 (both are f32 gathers and sums taken in other orders). The
cases of tests/test_ops_xla.py are ported as cases of these tests. The
port's tiled strategy (the CUDA kernels' plain versions here) is also held
to its own segment oracle through the public API.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu import ops as jops
from custom_op_benchmark_tpu_torch import ops as tops
from custom_op_benchmark_tpu_torch.graph import clique_batch, from_coo
from custom_op_benchmark_tpu_torch.ops import dispatch

TOL = dict(rtol=1e-5, atol=1e-5)


def make_graphs(n=13, p=0.4, seed=0, pad_multiple=None):
    """The JAX suite's random simple digraph (every node has a self-loop),
    built by both packages."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, True)
    src, dst = np.nonzero(mask)
    return (jax_from_coo(src, dst, n, pad_multiple=pad_multiple),
            from_coo(src, dst, n, pad_multiple=pad_multiple))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(jfn, tfn, args, *, cot_seed=99, tol=TOL):
    """Forward and the VJP of one random cotangent, both packages."""
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    cot = _normal(cot_seed, *jout.shape)
    jgrads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*ts)
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **tol)
    for t, j in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("heads", [None, 4])
@pytest.mark.parametrize("pad", [None, 64])
def test_sddmm(heads, pad):
    jg, g = make_graphs(seed=1, pad_multiple=pad)
    shape = (g.n_nodes, 8) if heads is None else (g.n_nodes, heads, 8)
    e = g.n_edges
    _check(lambda a, b: jops.sddmm(jg, a, b, impl="xla")[:e],
           lambda a, b: tops.sddmm(g, a, b, impl="xla")[:e],
           [_normal(0, *shape), _normal(1, *shape)])


@pytest.mark.parametrize("heads", [None, 3])
def test_node_mul_edge(heads):
    jg, g = make_graphs(seed=2, pad_multiple=32)
    shape = (g.n_nodes, 8) if heads is None else (g.n_nodes, heads, 8)
    e = g.n_edges
    _check(lambda a, b: jops.node_mul_edge(jg, a, b, impl="xla")[:e],
           lambda a, b: tops.node_mul_edge(g, a, b, impl="xla")[:e],
           [_normal(2, *shape), _normal(3, g.num_edges_padded, 8)])


@pytest.mark.parametrize("by", ["src", "dst"])
@pytest.mark.parametrize("heads", [None, 2])
def test_edge_softmax(by, heads):
    jg, g = make_graphs(seed=3, pad_multiple=32)
    shape = ((g.num_edges_padded,) if heads is None
             else (g.num_edges_padded, heads))
    e = g.n_edges
    _check(lambda x: jops.edge_softmax(jg, x, by=by, impl="xla")[:e],
           lambda x: tops.edge_softmax(g, x, by=by, impl="xla")[:e],
           [_normal(4, *shape) * 3])


@pytest.mark.parametrize("heads", [None, 4])
@pytest.mark.parametrize("pad", [None, 128])
def test_vector_spmm(heads, pad):
    jg, g = make_graphs(seed=6, pad_multiple=pad)
    E = g.num_edges_padded
    eshape = (E,) if heads is None else (E, heads)
    xshape = (g.n_nodes, 8) if heads is None else (g.n_nodes, heads, 8)
    _check(lambda ed, x: jops.vector_spmm(jg, ed, x, impl="xla"),
           lambda ed, x: tops.vector_spmm(g, ed, x, impl="xla"),
           [_normal(5, *eshape), _normal(6, *xshape)])


def test_attention_layer_composition():
    jg, g = make_graphs(seed=8, pad_multiple=64)
    n, h, d = g.n_nodes, 2, 8

    def layer(ops, gr, mask_fn):
        def f(q, k, v):
            scores = ops.sddmm(gr, q, k, impl="xla")
            alpha = ops.edge_softmax(gr, scores, by="src", impl="xla")
            return ops.vector_spmm(gr, mask_fn(gr, alpha), v, impl="xla")
        return f

    _check(layer(jops, jg, lambda gr, a: jnp.where(gr.edge_mask[:, None],
                                                   a, 0.0)),
           layer(tops, g, lambda gr, a: torch.where(gr.edge_mask[:, None],
                                                    a, 0.0)),
           [_normal(10 + i, n, h, d) for i in range(3)])


@pytest.mark.parametrize("heads", [None, 2])
def test_attention_and_softmax_aggregate(heads):
    jg, g = make_graphs(seed=12, pad_multiple=32)
    shape = (g.n_nodes, 8) if heads is None else (g.n_nodes, heads, 8)
    _check(lambda q, k, v: jops.attention(jg, q, k, v, impl="xla"),
           lambda q, k, v: tops.attention(g, q, k, v, impl="xla"),
           [_normal(20 + i, *shape) for i in range(3)])
    sshape = (g.num_edges_padded,) + (() if heads is None else (heads,))
    _check(lambda s, x: jops.softmax_aggregate_dst(jg, s, x),
           lambda s, x: tops.softmax_aggregate_dst(g, s, x),
           [_normal(23, *sshape), _normal(24, *shape)])


def test_attention_with_edge_bias():
    jg, g = make_graphs(seed=13, pad_multiple=32)
    shape = (g.n_nodes, 2, 8)
    _check(lambda q, k, v, b: jops.attention(jg, q, k, v, edge_bias=b,
                                             impl="xla"),
           lambda q, k, v, b: tops.attention(g, q, k, v, edge_bias=b,
                                             impl="xla"),
           [_normal(30 + i, *shape) for i in range(3)]
           + [_normal(33, g.num_edges_padded, 8)])


def test_gat_attention():
    jg, g = make_graphs(seed=14, pad_multiple=32)
    _check(lambda al, ar, z: jops.gat_attention(jg, al, ar, z, impl="xla"),
           lambda al, ar, z: tops.gat_attention(g, al, ar, z, impl="xla"),
           [_normal(40, 2, 8), _normal(41, 2, 8),
            _normal(42, g.n_nodes, 2, 8)])


@pytest.mark.parametrize("to", ["src", "dst"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_gspmm(reduce, to):
    jg, g = make_graphs(seed=9, pad_multiple=32)
    x = _normal(50, g.n_nodes, 4)
    ed = _normal(51, g.num_edges_padded, 4)
    want = jops.gspmm(jg, "mul", reduce, jnp.asarray(ed), jnp.asarray(x),
                      lhs_target="e", rhs_target="v", to=to)
    got = tops.gspmm(g, "mul", reduce, torch.from_numpy(ed),
                     torch.from_numpy(x), lhs_target="e", rhs_target="v",
                     to=to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("op", ["dot", "add", "copy_lhs"])
def test_gsddmm(op):
    jg, g = make_graphs(seed=11)
    a, b = _normal(60, g.n_nodes, 8), _normal(61, g.n_nodes, 8)
    want = jops.gsddmm(jg, op, jnp.asarray(a), jnp.asarray(b))
    got = tops.gsddmm(g, op, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gspmm_copy_sum_is_adjacency_product():
    rng = np.random.default_rng(9)
    mask = rng.random((13, 13)) < 0.4
    np.fill_diagonal(mask, True)
    g = from_coo(*np.nonzero(mask), 13)
    x = torch.from_numpy(_normal(62, 13, 8))
    out = tops.gspmm(g, "copy_rhs", "sum", rhs=x, rhs_target="v", to="src")
    np.testing.assert_allclose(out.numpy(), mask.astype(np.float32) @
                               x.numpy(), rtol=1e-4, atol=1e-4)


def test_sddmm_clique_matches_bmm():
    b, l, d = 4, 6, 16
    g = clique_batch(b, l)
    A, B = _normal(70, b * l, d), _normal(71, b * l, d)
    y = tops.sddmm(g, torch.from_numpy(A), torch.from_numpy(B))
    want = np.einsum("bxd,byd->bxy", A.reshape(b, l, d),
                     B.reshape(b, l, d)).reshape(-1)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)


def test_edge_softmax_clique_matches_reference_protocol():
    b, l = 3, 7
    g = clique_batch(b, l)
    x = torch.from_numpy(_normal(72, g.n_edges))
    for by, axis in (("src", -1), ("dst", -2)):
        want = torch.softmax(x.reshape(b, l, l), axis).reshape(-1)
        np.testing.assert_allclose(tops.edge_softmax(g, x, by=by).numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-6)


def test_edge_softmax_sums_to_one_and_is_stable():
    _, g = make_graphs(seed=4)
    x = torch.from_numpy(_normal(73, g.n_edges, 2)) * 10.0
    y = tops.edge_softmax(g, x, by="dst")
    sums = torch.zeros(g.n_nodes, 2).index_add_(0, g.dst.long(), y)
    np.testing.assert_allclose(sums.numpy(), 1.0, atol=1e-5)
    y = tops.edge_softmax(g, torch.full((g.n_edges,), 1e4), by="dst")
    assert torch.isfinite(y).all()


def test_empty_segments_and_isolated_nodes():
    """Zero-edge rows give zeros (sum) and -1e9 (max), as in the reference."""
    g = from_coo(np.array([0, 0]), np.array([1, 2]), 5, pad_multiple=8)
    jg = jax_from_coo(np.array([0, 0]), np.array([1, 2]), 5, pad_multiple=8)
    x = _normal(74, 5, 3)
    ed = _normal(75, g.num_edges_padded)
    y = tops.vector_spmm(g, torch.from_numpy(ed), torch.from_numpy(x))
    assert not y[1:].any()
    mx = tops.gspmm(g, "copy_rhs", "max", rhs=torch.from_numpy(x), to="src")
    np.testing.assert_allclose(
        mx.numpy(), np.asarray(jops.gspmm(jg, "copy_rhs", "max",
                                          rhs=jnp.asarray(x), to="src")))
    assert (mx[1:] == -1e9).all()


def test_public_api_validation_errors():
    g = clique_batch(2, 4)
    n, e = g.n_nodes, g.num_edges_padded
    A = torch.ones(n, 8)
    with pytest.raises(ValueError):
        tops.edge_softmax(g, torch.ones(e), by="nope")
    with pytest.raises(ValueError):
        tops.sddmm(g, A, torch.ones(n + 3, 8))
    with pytest.raises(ValueError):
        tops.vector_spmm(g, torch.ones(e + 5), A)
    with pytest.raises(ValueError):
        tops.vector_spmm(g, torch.ones(e, 2), A)          # head ranks differ
    with pytest.raises(ValueError):
        tops.gspmm(g, "copy_lhs", "prod", lhs=A, lhs_target="u", to="dst")
    with pytest.raises(ValueError):
        tops.gspmm(g, "copy_lhs", "sum", lhs=A, lhs_target="u", to="sideways")
    with pytest.raises(ValueError):
        tops.gat_attention(g, torch.ones(2, 8), torch.ones(2, 8), A)


# ---------------------------------------------------------------------------
# impl= dispatch: the tiled strategy (M3) against the segment oracle (M2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blocky():
    """Cliques of 30 (tile-aligned into diagonal tiles) with padded edges,
    and a random graph whose tiles straddle."""
    rng = np.random.default_rng(5)
    mask = rng.random((150, 150)) < 0.05
    np.fill_diagonal(mask, True)
    return {"cliques": clique_batch(9, 30, pad_multiple=512),
            "random": from_coo(*np.nonzero(mask), 150)}


@pytest.mark.parametrize("name", ["cliques", "random"])
@pytest.mark.parametrize("heads", [None, 2])
@pytest.mark.parametrize("op", ["sddmm", "vector_spmm", "edge_softmax_src",
                                "edge_softmax_dst", "attention"])
@pytest.mark.parametrize("impl", ["tiled", "pallas"])
def test_tiled_strategy_matches_segment_oracle(blocky, name, heads, op,
                                               impl):
    g = blocky[name]
    e = g.n_edges
    hs = () if heads is None else (heads,)
    node = (g.n_nodes,) + hs + (8,)
    edge = (g.num_edges_padded,) + hs
    if op == "sddmm":
        fn, args = (lambda i: lambda a, b: tops.sddmm(g, a, b, impl=i)[:e],
                    [_normal(80, *node), _normal(81, *node)])
    elif op == "vector_spmm":
        fn, args = (lambda i: lambda ed, x: tops.vector_spmm(g, ed, x,
                                                             impl=i),
                    [_normal(82, *edge), _normal(83, *node)])
    elif op.startswith("edge_softmax"):
        by = op.rsplit("_", 1)[1]
        fn, args = (lambda i: lambda x: tops.edge_softmax(
            g, x, by=by, impl=i)[:e], [_normal(84, *edge)])
    else:
        fn, args = (lambda i: lambda q, k, v: tops.attention(g, q, k, v,
                                                             impl=i),
                    [_normal(85 + j, *node) for j in range(3)])
    cot_shape = fn("xla")(*map(torch.from_numpy, args)).shape
    cot = torch.from_numpy(_normal(89, *cot_shape))
    outs = []
    for i in ("xla", impl):
        ts = [torch.tensor(a, requires_grad=True) for a in args]
        y = fn(i)(*ts)
        y.backward(cot)
        outs.append([y.detach()] + [t.grad for t in ts])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_dispatch_caches_the_tiled_view(blocky):
    g = blocky["cliques"]
    assert dispatch.get_tiled(g) is dispatch.get_tiled(g)
    ro, tg, eperm, eperm_inv = dispatch.get_tiled(g)
    assert tg.num_tiles == tg.num_row_blocks           # diagonal tiles
    assert eperm.shape == (tg.edge_tile.shape[0],)
    assert eperm_inv.shape == (g.num_edges_padded,)


@pytest.mark.parametrize("impl", ["dense_block", "cuda"])
def test_dispatch_refuses_what_is_not_ported(impl):
    """An unknown impl raises. ``dense_block`` is ported: on a clique
    batch it gives the segment oracle's scores."""
    g = clique_batch(2, 4)
    x = torch.rand(g.n_nodes, 4)
    if impl == "dense_block":
        torch.testing.assert_close(tops.sddmm(g, x, x, impl=impl),
                                   tops.sddmm(g, x, x, impl="xla"))
        return
    with pytest.raises(ValueError):
        tops.sddmm(g, x, x, impl=impl)


def test_auto_uses_the_oracle_on_small_graphs_only():
    small = clique_batch(2, 4)
    assert dispatch.resolve(small, "auto") == "xla"
    big = clique_batch(30, 30)       # 27,000 edges: the advisor decides
    assert dispatch.resolve(big, "auto") == "dense_block"
    # The tiled strategy has no kernel for these two; they route to ELL,
    # as in the reference.
    g = clique_batch(2, 4)
    A, Be = torch.rand(8, 4), torch.rand(g.n_edges, 4)
    torch.testing.assert_close(tops.node_mul_edge(g, A, Be, impl="tiled"),
                               tops.node_mul_edge(g, A, Be, impl="xla"))
    a_l, a_r, z = torch.rand(2, 4), torch.rand(2, 4), torch.rand(8, 2, 4)
    torch.testing.assert_close(
        tops.gat_attention(g, a_l, a_r, z, impl="pallas"),
        tops.gat_attention(g, a_l, a_r, z, impl="xla"))
    assert dispatch.resolve(g, "ell") == "ell"

