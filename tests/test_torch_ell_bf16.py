"""The port's ELL ops in bfloat16 against the JAX package's.

The JAX ops take bf16 operands, form their products and sums in f32
(``preferred_element_type=float32``) and round to the input's dtype at
their outputs; the port does the same with explicit f32 arithmetic. Both
packages get the same numpy inputs, rounded to bf16, on
``random_graph(2000, 20000, seed=0, power_law=True)`` at h = 4, d = 32,
and each op's output and its cotangents for a fixed random output
cotangent must agree per element within

    |port − JAX| ≤ 2⁻⁷·|JAX| + 1e-3·max|JAX|

(one bf16 rounding, over a floor for outputs that cancel to near 0: the
two packages sum in other orders, so where a sum lands on a rounding
boundary they round to neighbouring bf16 values). The fused attentions
keep α and the scores in f32 as the reference does, so their error
against the f32 result of the same bf16 inputs is at most 1.1 times
JAX's (before this policy the port computed them in bf16, with about
twice JAX's error on ``ell_gat_attention``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.ops import ell as J
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.ops import ell as T

N, E, H, D = 2000, 20000, 4, 32
BF16_RTOL = 2.0 ** -7
FLOOR = 1e-3          # of max|JAX|


@pytest.fixture(scope="module")
def graphs():
    g = random_graph(N, E, seed=0, power_law=True)
    jg = jax_random_graph(N, E, seed=0, power_law=True)
    return dict(g=g, ell=T.ell_dual(g), jell=J.ell_dual(jg))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = BF16_RTOL * np.abs(want) + FLOOR * np.abs(want).max()
    worst = float((np.abs(got - want) - tol).max())
    assert worst <= 0, f"{what}: exceeds the bf16 tolerance by {worst:.3e}"


def _run_port(fn, arrays, ct):
    ts = [torch.from_numpy(a).bfloat16().requires_grad_() for a in arrays]
    out = fn(*ts)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(ct).bfloat16())
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


def _run_jax(fn, arrays, ct):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a, jnp.bfloat16) for a in arrays])
    assert out.dtype == jnp.bfloat16
    grads = vjp(jnp.asarray(ct, jnp.bfloat16))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(gr.astype(jnp.float32)) for gr in grads])


def _packed_pair(c, w, pack_fn):
    """Canonical f32 weights ``w`` → per-bucket numpy arrays of both
    packings, src copy first (the two packages' packings are equal)."""
    pw = pack_fn(torch.from_numpy(w))
    return [t.numpy() for t in pw.src + pw.dst], len(pw.src)


def _cases(c, rng):
    """name → (inputs, port fn, JAX fn); each fn takes the inputs."""
    ell, jell = c["ell"], c["jell"]
    se, de = ell
    jse, jde = jell
    e_pad = c["g"].num_edges_padded
    x1, x4 = _rand(rng, N, D), _rand(rng, N, H, D)
    w1, w4 = _rand(rng, e_pad), _rand(rng, e_pad, H)
    q, k, v = (_rand(rng, N, H, D, scale=0.4) for _ in range(3))
    be = _rand(rng, e_pad, D, scale=0.4)
    a_l, a_r = _rand(rng, H, D, scale=0.3), _rand(rng, H, D, scale=0.3)
    s4 = _rand(rng, e_pad, H)
    cases = {
        "spmm h=1": ([w1, x1], lambda w, x: T.ell_spmm(se, de, w, x),
                     lambda w, x: J.ell_spmm(jse, jde, w, x)),
        "spmm h=4": ([w4, x4], lambda w, x: T.ell_spmm(se, de, w, x),
                     lambda w, x: J.ell_spmm(jse, jde, w, x)),
        "sddmm h=1": ([x1, x1[::-1].copy()],
                      lambda a, b: T.ell_sddmm(se, de, a, b),
                      lambda a, b: J.ell_sddmm(jse, jde, a, b)),
        "sddmm h=4": ([x4, q], lambda a, b: T.ell_sddmm(se, de, a, b),
                      lambda a, b: J.ell_sddmm(jse, jde, a, b)),
        "softmax h=4": ([s4], lambda s: T.ell_softmax(de, s),
                        lambda s: J.ell_softmax(jde, s)),
        "attention": ([q, k, v],
                      lambda *a: T.ell_attention(de, se, *a),
                      lambda *a: J.ell_attention(jde, jse, *a)),
        "edge-bias attention": (
            [q, k, v, be],
            lambda *a: T.ell_edge_bias_attention(de, se, *a),
            lambda *a: J.ell_edge_bias_attention(jde, jse, *a)),
        "node_mul_edge h=4": (
            [x4, _rand(rng, e_pad, D)],
            lambda a, b: T.ell_node_mul_edge(se, de, a, b),
            lambda a, b: J.ell_node_mul_edge(jse, jde, a, b)),
        "gat": ([a_l, a_r, x4],
                lambda *a: T.ell_gat_attention(de, se, *a),
                lambda *a: J.ell_gat_attention(jde, jse, *a)),
        "copy_spmm sum": ([x4], lambda x: T.ell_copy_spmm(de, se, x),
                          lambda x: J.ell_copy_spmm(jde, jse, x)),
        "copy_spmm mean": (
            [x1], lambda x: T.ell_copy_spmm(de, se, x, reduce="mean"),
            lambda x: J.ell_copy_spmm(jde, jse, x, reduce="mean")),
    }
    # Packed weights: the forward sweep, and the backward's fused
    # spmm+sddmm passes (_spmm_sddmm_fused) for both cotangent copies.
    wp, n_src = _packed_pair(c, w4, lambda w: T.ell_pack_weights(se, de, w))
    cases["spmm packed h=4"] = (
        wp + [x4],
        lambda *a: T.ell_spmm(se, de, T.PackedEdgeWeights(
            src=list(a[:n_src]), dst=list(a[n_src:-1])), a[-1]),
        lambda *a: J.ell_spmm(jse, jde, J.PackedEdgeWeights(
            src=list(a[:n_src]), dst=list(a[n_src:-1])), a[-1]))
    bp, nb = _packed_pair(c, be, lambda w: T.ell_pack_weights(se, de, w))
    cases["edge-bias attention packed"] = (
        [q, k, v] + bp,
        lambda q, k, v, *w: T.ell_edge_bias_attention(
            de, se, q, k, v, T.PackedEdgeWeights(src=list(w[:nb]),
                                                 dst=list(w[nb:]))),
        lambda q, k, v, *w: J.ell_edge_bias_attention(
            jde, jse, q, k, v, J.PackedEdgeWeights(src=list(w[:nb]),
                                                   dst=list(w[nb:]))))
    return cases


CASES = ["spmm h=1", "spmm h=4", "spmm packed h=4", "sddmm h=1", "sddmm h=4",
         "softmax h=4", "attention", "edge-bias attention",
         "edge-bias attention packed", "node_mul_edge h=4", "gat",
         "copy_spmm sum", "copy_spmm mean"]


@pytest.mark.parametrize("name", CASES)
def test_bf16_op_matches_jax(graphs, name):
    """Forward and every cotangent, bf16 in both packages."""
    rng = np.random.default_rng(CASES.index(name))
    arrays, port_fn, jax_fn = _cases(graphs, rng)[name]
    out_shape = jax.eval_shape(
        jax_fn, *[jnp.asarray(a, jnp.bfloat16) for a in arrays]).shape
    ct = _rand(rng, *out_shape)
    out, grads = _run_port(port_fn, arrays, ct)
    jout, jgrads = _run_jax(jax_fn, arrays, ct)
    _close(out, jout, f"{name} forward")
    for i, (got, want) in enumerate(zip(grads, jgrads)):
        _close(got, want, f"{name} cotangent {i}")


@pytest.mark.parametrize("name", ["attention", "gat"])
def test_bf16_error_against_f32_is_jaxs(graphs, name):
    """The port's bf16 fused attention errs against the f32 result of the
    same (bf16-rounded) inputs by at most 1.1 times JAX's bf16 op, in the
    largest and in the mean absolute error."""
    rng = np.random.default_rng(50 + CASES.index(name))
    arrays, port_fn, jax_fn = _cases(graphs, rng)[name]
    rounded = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in arrays]
    want = np.asarray(jax_fn(*map(jnp.asarray, rounded)))
    port = port_fn(*[torch.from_numpy(a).bfloat16() for a in arrays])
    jax16 = jax_fn(*[jnp.asarray(a, jnp.bfloat16) for a in arrays])
    err = np.abs(port.float().numpy() - want)
    jerr = np.abs(np.asarray(jax16.astype(jnp.float32)) - want)
    assert err.max() <= 1.1 * jerr.max(), (err.max(), jerr.max())
    assert err.mean() <= 1.1 * jerr.mean(), (err.mean(), jerr.mean())
