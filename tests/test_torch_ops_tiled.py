"""The port's tiled ops against the JAX package's, forward and gradient.

JAX runs its Pallas kernels in interpret mode on the CPU; the port runs its
kernels' plain versions under the same hand VJPs. Same numpy inputs and
cotangents for both, f32, rtol/atol 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from custom_op_benchmark_tpu.graph import from_coo as jax_from_coo
from custom_op_benchmark_tpu.graph.tiled import tile_graph as jax_tile_graph
from custom_op_benchmark_tpu.ops import tiled as jops
from custom_op_benchmark_tpu_torch.graph import from_coo, tile_graph
from custom_op_benchmark_tpu_torch.ops import tiled as tops

TOL = dict(rtol=1e-4, atol=1e-4)
N, D = 30, 16


@pytest.fixture(scope="module")
def graphs():
    """The JAX package's own tiled-op fixture: 30 nodes, 8x8 tiles."""
    rng = np.random.default_rng(0)
    mask = rng.random((N, N)) < 0.25
    np.fill_diagonal(mask, True)
    src, dst = np.nonzero(mask)
    return (jax_tile_graph(jax_from_coo(src, dst, N), 8, 8),
            tile_graph(from_coo(src, dst, N), 8, 8))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_vjp(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(jfn, tfn, args, cot):
    jout, jgrads = _jax_vjp(jfn, args, cot)
    tout, tgrads = _torch_vjp(tfn, args, cot)
    np.testing.assert_allclose(tout, jout, **TOL)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, j, **TOL)


def test_tiled_sddmm(graphs):
    jt, tg = graphs
    args = [_normal(0, N, D), _normal(1, N, D)]
    cot = _normal(2, tg.num_tiles, 8, 8)
    _check(lambda a, b: jops.tiled_sddmm(jt, a, b),
           lambda a, b: tops.tiled_sddmm(tg, a, b), args, cot)


def test_tiled_spmm(graphs):
    jt, tg = graphs
    args = [_normal(3, tg.num_tiles, 8, 8), _normal(4, N, D)]
    cot = _normal(5, N, D)
    _check(lambda v, x: jops.tiled_spmm(jt, v, x),
           lambda v, x: tops.tiled_spmm(tg, v, x), args, cot)


@pytest.mark.parametrize("by", ["src", "dst"])
def test_tiled_softmax(graphs, by):
    jt, tg = graphs
    args = [_normal(6, tg.num_tiles, 8, 8)]
    cot = _normal(7, tg.num_tiles, 8, 8)
    _check(lambda s: jops.tiled_softmax(jt, s, by=by),
           lambda s: tops.tiled_softmax(tg, s, by=by), args, cot)


@pytest.mark.parametrize("heads", [None, 3])
@pytest.mark.parametrize("normalize", ["src", "dst"])
def test_tiled_attention(graphs, normalize, heads):
    jt, tg = graphs
    shape = (N, D) if heads is None else (N, heads, D // 2)
    args = [_normal(8 + i, *shape) for i in range(3)]
    cot = _normal(11, *shape)
    _check(lambda q, k, v: jops.tiled_attention(jt, q, k, v,
                                                normalize=normalize),
           lambda q, k, v: tops.tiled_attention(tg, q, k, v,
                                                normalize=normalize),
           args, cot)


def test_tiled_attention_rejects_bad_normalize(graphs):
    _, tg = graphs
    x = torch.zeros(N, D)
    with pytest.raises(ValueError):
        tops.tiled_attention(tg, x, x, x, normalize="both")
    with pytest.raises(ValueError):
        tops.tiled_softmax(tg, torch.zeros(tg.num_tiles, 8, 8), by="both")
