"""``impl=`` dispatch of the port's public ops against the JAX package's.

The cases of tests/test_dispatch.py: every strategy (``dense_block``,
``ell``, ``pallas``) through the public op API gives the forward and the
gradients of the JAX package's segment oracle, on the same numpy inputs;
the whole op × impl matrix has no holes; ``impl="auto"`` stays on the
oracle below the edge threshold and follows ``describe`` above it. Where
the reference checks that ``impl="pallas"`` lowers to a ``pallas_call``,
the port checks that the call reaches its kernel wrappers (on the CPU the
wrappers run their plain versions; ``chip_smoke.py`` checks their launch
counters on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu import ops as jops
from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu_torch import ops as tops
from custom_op_benchmark_tpu_torch.graph import clique_batch, random_graph
from custom_op_benchmark_tpu_torch.ops import dispatch
from custom_op_benchmark_tpu_torch.ops import tiled as tiled_module

STRATEGIES = ["dense_block", "ell", "pallas"]


@pytest.fixture(scope="module")
def blocky():
    return clique_batch(6, 10), jax_clique_batch(6, 10)   # n=60, e=600


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _against_jax(jfn, tfn, args, n_rows, *, fwd_tol, grad_tol):
    """The port at some impl against JAX at impl="xla": forward rows
    ``:n_rows`` and the gradient of sum(sin(y[:n_rows]))."""
    def jloss(*a):
        return jnp.sum(jnp.sin(jfn(*a)[:n_rows]))

    with jax.default_matmul_precision("highest"):
        jy = jfn(*map(jnp.asarray, args))
        jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(
            *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y = tfn(*ts)
    torch.sin(y[:n_rows]).sum().backward()
    np.testing.assert_allclose(y.detach().numpy()[:n_rows],
                               np.asarray(jy)[:n_rows], **fwd_tol)
    for t, j in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy()[: j.shape[0]],
                                   np.asarray(j), **grad_tol)


@pytest.mark.parametrize("impl", STRATEGIES)
@pytest.mark.parametrize("multi", [False, True])
def test_sddmm_strategies(blocky, impl, multi):
    g, jg = blocky
    shape = (g.n_nodes, 2, 8) if multi else (g.n_nodes, 8)
    _against_jax(lambda a, b: jops.sddmm(jg, a, b, impl="xla"),
                 lambda a, b: tops.sddmm(g, a, b, impl=impl),
                 [_normal(0, *shape), _normal(1, *shape)], g.n_edges,
                 fwd_tol=dict(rtol=1e-5, atol=1e-5),
                 grad_tol=dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("impl", STRATEGIES)
@pytest.mark.parametrize("multi", [False, True])
def test_vector_spmm_strategies(blocky, impl, multi):
    g, jg = blocky
    e = g.num_edges_padded
    if multi:
        args = [_uniform(2, e, 2), _normal(3, g.n_nodes, 2, 8)]
    else:
        args = [_uniform(2, e), _normal(3, g.n_nodes, 8)]
    _against_jax(lambda ed, x: jops.vector_spmm(jg, ed, x, impl="xla"),
                 lambda ed, x: tops.vector_spmm(g, ed, x, impl=impl),
                 args, g.n_nodes, fwd_tol=dict(rtol=1e-5, atol=1e-5),
                 grad_tol=dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("impl", STRATEGIES)
@pytest.mark.parametrize("by", ["src", "dst"])
@pytest.mark.parametrize("heads", [None, 3])
def test_edge_softmax_strategies(blocky, impl, by, heads):
    g, jg = blocky
    shape = ((g.num_edges_padded,) if heads is None
             else (g.num_edges_padded, heads))
    _against_jax(lambda x: jops.edge_softmax(jg, x, by=by, impl="xla"),
                 lambda x: tops.edge_softmax(g, x, by=by, impl=impl),
                 [_normal(4, *shape)], g.n_edges,
                 fwd_tol=dict(rtol=1e-5, atol=1e-6),
                 grad_tol=dict(rtol=1e-3, atol=1e-6))


@pytest.mark.parametrize("impl", ["dense_block", "ell", "pallas", "tiled"])
@pytest.mark.parametrize("heads", [None, 2])
def test_node_mul_edge_strategies(blocky, impl, heads):
    """The tiled family routes to ELL, as in the reference."""
    g, jg = blocky
    shape = (g.n_nodes, 8) if heads is None else (g.n_nodes, heads, 8)
    _against_jax(lambda a, b: jops.node_mul_edge(jg, a, b, impl="xla"),
                 lambda a, b: tops.node_mul_edge(g, a, b, impl=impl),
                 [_normal(5, *shape), _normal(6, g.num_edges_padded, 8)],
                 g.n_edges, fwd_tol=dict(rtol=1e-5, atol=1e-5),
                 grad_tol=dict(rtol=1e-4, atol=1e-5))


def test_full_op_impl_matrix_no_holes(blocky):
    """Every public op under every impl returns and matches JAX's oracle
    (tiled-family → ELL for node_mul_edge, gat and edge-bias attention)."""
    g, jg = blocky
    n, e = g.n_nodes, g.num_edges_padded
    A, B = _normal(7, n, 2, 8), _normal(8, n, 2, 8)
    Be, xe = _normal(9, e, 8), _normal(10, e, 2)
    a_l, a_r = _normal(11, 2, 8) * 0.1, _normal(12, 2, 8) * 0.1
    cases = {
        "sddmm": (lambda m, gg, imp: m.sddmm(gg, A, B, impl=imp), True),
        "vector_spmm": (lambda m, gg, imp: m.vector_spmm(gg, xe, A, impl=imp),
                        False),
        "edge_softmax": (lambda m, gg, imp: m.edge_softmax(
            gg, xe, by="dst", impl=imp), True),
        "node_mul_edge": (lambda m, gg, imp: m.node_mul_edge(
            gg, A, Be, impl=imp), True),
        "attention": (lambda m, gg, imp: m.attention(gg, A, B, A, impl=imp),
                      False),
        "attention_eb": (lambda m, gg, imp: m.attention(
            gg, A, B, A, edge_bias=Be, impl=imp), False),
        "gat_attention": (lambda m, gg, imp: m.gat_attention(
            gg, a_l, a_r, A, impl=imp), False),
    }
    for name, (fn, edge_valued) in cases.items():
        with jax.default_matmul_precision("highest"):
            want = np.asarray(fn(_JaxOps, jg, "xla"))
        rows = g.n_edges if edge_valued else n
        for impl in ("auto", "pallas", "tiled", "dense_block", "ell", "xla"):
            got = fn(_TorchOps, g, impl).numpy()
            np.testing.assert_allclose(got[:rows], want[:rows], rtol=2e-3,
                                       atol=2e-3, err_msg=f"{name} {impl}")


class _Jax:
    """JAX's public ops on numpy inputs."""

    def __getattr__(self, name):
        fn = getattr(jops, name)
        return lambda g, *a, **k: fn(
            g, *(jnp.asarray(x) for x in a),
            **{key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for key, v in k.items()})


class _Torch:
    """The port's public ops on numpy inputs."""

    def __getattr__(self, name):
        fn = getattr(tops, name)
        return lambda g, *a, **k: fn(
            g, *(torch.from_numpy(x) for x in a),
            **{key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for key, v in k.items()})


_JaxOps, _TorchOps = _Jax(), _Torch()


@pytest.mark.parametrize("op", ["sddmm", "vector_spmm"])
def test_pallas_impl_reaches_the_tile_kernels(blocky, monkeypatch, op):
    """The reference's jaxpr check for a ``pallas_call``: here, the call
    reaches the kernel wrapper (its plain version on the CPU), and
    ``impl="xla"`` does not."""
    g, _ = blocky
    name = "sddmm_tiles" if op == "sddmm" else "spmm_row_sweep"
    calls = []
    real = getattr(tiled_module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tiled_module, name, counted)
    x = torch.from_numpy(_normal(13, g.n_nodes, 8))
    ed = torch.ones(g.num_edges_padded)
    run = ((lambda imp: tops.sddmm(g, x, x, impl=imp)) if op == "sddmm"
           else (lambda imp: tops.vector_spmm(g, ed, x, impl=imp)))
    run("xla")
    assert calls == []
    run("pallas")
    assert calls == [1]


def test_auto_resolution_threshold():
    small = random_graph(64, 500, seed=3)
    assert dispatch.resolve(small, "auto") == "xla"
    big = clique_batch(100, 16)         # e = 25,600 >= AUTO_MIN_EDGES
    assert big.n_edges >= dispatch.AUTO_MIN_EDGES
    assert dispatch.resolve(big, "auto") == "dense_block"
    assert dispatch.resolve(clique_batch(512, 30), "auto") == "dense_block"


@pytest.mark.parametrize("maker, want", [
    ("grid", "tiled"), ("powerlaw", "ell")])
def test_auto_follows_describe_on_large_graphs(maker, want):
    from custom_op_benchmark_tpu_torch.graph import grid_graph

    g = (grid_graph(80, 80) if maker == "grid"
         else random_graph(21000, 30000, seed=5, power_law=True))
    assert g.n_edges >= dispatch.AUTO_MIN_EDGES
    assert dispatch.resolve(g, "auto") == want
    assert dispatch.summary(g) is dispatch.summary(g)


def test_auto_runs_dense_block_end_to_end():
    g, jg = clique_batch(100, 16), jax_clique_batch(100, 16)
    x, ed = _normal(14, g.n_nodes, 4), _uniform(15, g.num_edges_padded)
    y_auto = tops.vector_spmm(g, torch.from_numpy(ed), torch.from_numpy(x),
                              impl="auto")
    y_ref = jops.vector_spmm(jg, jnp.asarray(ed), jnp.asarray(x), impl="xla")
    np.testing.assert_allclose(y_auto.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    assert dispatch.resolve(g, "auto") == "dense_block"


def test_auto_on_a_large_power_law_graph_matches_jax():
    g = random_graph(21000, 30000, seed=5, power_law=True)
    jg = jax_random_graph(21000, 30000, seed=5, power_law=True)
    ed, x = np.ones(g.num_edges_padded, np.float32), _normal(16, g.n_nodes, 8)
    y = tops.vector_spmm(g, torch.from_numpy(ed), torch.from_numpy(x))
    y_ref = jops.vector_spmm(jg, jnp.asarray(ed), jnp.asarray(x), impl="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)


def test_strategy_views_cached(blocky):
    g, _ = blocky
    assert dispatch.get_ell(g) is dispatch.get_ell(g)
    assert dispatch.get_block(g) is dispatch.get_block(g)
    assert dispatch.get_block(g) is not None
    assert dispatch.get_block(random_graph(300, 3000, seed=1)) is None


def test_bad_impl_rejected():
    g = random_graph(64, 500, seed=3)
    x = torch.zeros(g.n_nodes, 4)
    with pytest.raises(ValueError):
        tops.sddmm(g, x, x, impl="cuda")


def test_dense_block_refuses_a_graph_that_is_not_blocky():
    g = random_graph(300, 3000, seed=1)
    x = torch.zeros(g.n_nodes, 4)
    with pytest.raises(ValueError, match="not blocky"):
        tops.sddmm(g, x, x, impl="dense_block")


@pytest.mark.parametrize("which", ["clique", "powerlaw"])
def test_fused_attention_dispatch_all_strategies(which):
    """ops.attention and ops.gat_attention, every strategy, outputs and
    input gradients against JAX's composed segment path."""
    if which == "clique":
        g, jg = clique_batch(5, 9), jax_clique_batch(5, 9)
        impls = ("xla", "dense_block", "ell", "pallas")
    else:
        g = random_graph(120, 900, seed=1, power_law=True)
        jg = jax_random_graph(120, 900, seed=1, power_law=True)
        impls = ("xla", "ell")
    n, h, d = g.n_nodes, 2, 8
    rng = np.random.default_rng(0)
    q = rng.normal(size=(n, h, d)).astype(np.float32)
    a_l = rng.normal(size=(h, d)).astype(np.float32)
    a_r = rng.normal(size=(h, d)).astype(np.float32)
    tol, gtol = dict(rtol=2e-3, atol=2e-3), dict(rtol=5e-3, atol=5e-3)
    with jax.default_matmul_precision("highest"):
        jq = jnp.asarray(q)
        y_ref = jops.attention(jg, jq, jq, jq, impl="xla")
        gy_ref = jax.grad(lambda q: (jops.attention(
            jg, q, q, q, impl="xla") ** 2).sum())(jq)
        z_ref = jops.gat_attention(jg, jnp.asarray(a_l), jnp.asarray(a_r), jq,
                                   impl="xla")
        gz_ref = jax.grad(lambda q: (jops.gat_attention(
            jg, jnp.asarray(a_l), jnp.asarray(a_r), q,
            impl="xla") ** 2).sum())(jq)
    for impl in impls:
        tq = torch.tensor(q, requires_grad=True)
        y = tops.attention(g, tq, tq, tq, impl=impl)
        (y ** 2).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                                   err_msg=f"attention {impl}", **tol)
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gy_ref),
                                   err_msg=f"attention grad {impl}", **gtol)
        tq = torch.tensor(q, requires_grad=True)
        z = tops.gat_attention(g, torch.from_numpy(a_l),
                               torch.from_numpy(a_r), tq, impl=impl)
        (z ** 2).sum().backward()
        np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_ref),
                                   err_msg=f"gat {impl}", **tol)
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gz_ref),
                                   err_msg=f"gat grad {impl}", **gtol)


@pytest.mark.parametrize("impl", ["dense_block", "ell", "pallas"])
def test_fused_attention_edge_bias_dispatch(impl):
    g, jg = clique_batch(5, 9), jax_clique_batch(5, 9)
    rng = np.random.default_rng(1)
    n, h, d = g.n_nodes, 2, 8
    q = rng.normal(size=(n, h, d)).astype(np.float32)
    be = rng.normal(size=(g.n_edges, d)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jq, jbe = jnp.asarray(q), jnp.asarray(be)
        y_ref = jops.attention(jg, jq, jq, jq, edge_bias=jbe, impl="xla")
        g_ref = jax.grad(lambda q, be: (jops.attention(
            jg, q, q, q, edge_bias=be, impl="xla") ** 2).sum(),
            argnums=(0, 1))(jq, jbe)
    tq = torch.tensor(q, requires_grad=True)
    tbe = torch.tensor(be, requires_grad=True)
    y = tops.attention(g, tq, tq, tq, edge_bias=tbe, impl=impl)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=2e-3, atol=2e-3)
    for t, want in zip((tq, tbe), g_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=5e-3, atol=5e-3)
