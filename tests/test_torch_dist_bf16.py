"""bf16 on the port's halo path against the JAX package's
(tests/test_dist_bf16.py).

The mixed-precision policy on the distributed path: bf16 q, k, v, so the
forward exchange and the reverse dk‖dv exchange carry bf16, sums in f32,
the landing in f32. Each case runs on the reference's graphs (power-law
and cliques, P = 4, the ``"auto"`` hub plan) and gates every element, not
a tolerance scaled by the largest value:

- the port's bf16 against JAX's bf16 on the same inputs: within one bf16
  rounding, ``|port − JAX| ≤ 2⁻⁷·|JAX| + 1e-3`` (the 1e-3 floor covers
  values near zero, where f32 sums of the same products in another order
  may round the other way);
- the port's bf16 against the port's f32 from the same (rounded) inputs:
  ``|bf16 − f32| ≤ 6e-2·|f32| + floor`` with the floor 5e-2 for outputs
  and 0.1 for gradients (bf16 keeps 8 bits: a product of two rounded
  O(1) operands is off by up to 2⁻⁸ of its size, and a row's sum of such
  terms can cancel to a small value whose absolute error stays that of
  the terms).

``fit_edge_partitioned(dtype=torch.bfloat16)`` trains GAT and transformer
with f32 parameters and finite metrics, as the reference asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.parallel import halo as jhalo
from custom_op_benchmark_tpu.parallel import make_mesh as jax_make_mesh
from custom_op_benchmark_tpu_torch.graph import clique_batch, random_graph
from custom_op_benchmark_tpu_torch.parallel import halo, make_mesh
from tests.test_torch_determinism import one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7
JAX_FLOOR = 1e-3
F32_RTOL = 6e-2
F32_FLOOR = {"out": 5e-2, "grad": 0.1}

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module", params=["power_law", "clique"])
def setup(request):
    if request.param == "power_law":
        g = random_graph(96, 800, seed=2, power_law=True)
        jg = jax_random_graph(96, 800, seed=2, power_law=True)
    else:
        g, jg = clique_batch(8, 11), jax_clique_batch(8, 11)
    mesh = make_mesh((4,), ("edge",), device="cpu")
    jmesh = jax_make_mesh((4,), ("edge",))
    hg = halo.halo_graph(g, mesh, hub_threshold="auto")
    jhg = jhalo.halo_graph(jg, jmesh, hub_threshold="auto")
    return dict(g=g, mesh=mesh, jmesh=jmesh, hg=hg, jhg=jhg,
                he=halo.halo_ell(hg, mesh), jhe=jhalo.halo_ell(jhg, jmesh),
                rng=np.random.default_rng(0))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _gate(got, want, rtol, floor, what):
    got, want = _f32(got), _f32(want)
    bad = np.abs(got - want) > rtol * np.abs(want) + floor
    assert not bad.any(), (what, int(bad.sum()), float(
        np.abs(got - want)[bad].max()))


def _qkv(s, n, h, d):
    """bf16-representable inputs (rounded once), as port f32, port bf16
    and JAX bf16 node-sharded arrays."""
    arrs = [torch.from_numpy(s["rng"].normal(size=(n, h, d)).astype(
        np.float32)).bfloat16().float().numpy() for _ in range(3)]
    f32 = [halo.shard_halo_nodes(s["hg"], s["mesh"], a).requires_grad_()
           for a in arrs]
    b16 = [t.detach().bfloat16().requires_grad_() for t in f32]
    j16 = [jhalo.shard_halo_nodes(s["jhg"], s["jmesh"], a).astype(
        jnp.bfloat16) for a in arrs]
    return f32, b16, j16


def _attn(s):
    return lambda q, k, v: halo.halo_attention_ell(s["hg"], s["he"],
                                                   s["mesh"], q, k, v)


def _jattn(s):
    return lambda q, k, v: jhalo.halo_attention_ell(s["jhg"], s["jhe"],
                                                    s["jmesh"], q, k, v)


def test_halo_attention_bf16_forward(setup):
    s = setup
    f32, b16, j16 = _qkv(s, s["g"].n_nodes, 2, 8)
    y16 = _attn(s)(*b16)
    assert y16.dtype == torch.bfloat16
    _gate(y16, jax.jit(_jattn(s))(*j16), BF16_ULP, JAX_FLOOR, "y vs JAX")
    _gate(y16, _attn(s)(*f32), F32_RTOL, F32_FLOOR["out"], "y vs f32")


def test_halo_attention_bf16_grads(setup):
    """The hand VJP with bf16 operands: dq, dk, dv in bf16, equal to JAX's
    within one rounding and close to the f32 VJP; this runs the bf16 wire
    both ways (the forward k‖v exchange and the reverse dk‖dv exchange
    with its hub return)."""
    s = setup
    f32, b16, j16 = _qkv(s, s["g"].n_nodes, 2, 8)

    def grads(fn, ts):
        return torch.autograd.grad((fn(*ts).float() ** 2).sum(), ts)

    g16, g32 = grads(_attn(s), b16), grads(_attn(s), f32)
    jg16 = jax.jit(jax.grad(lambda q, k, v: (_jattn(s)(q, k, v).astype(
        jnp.float32) ** 2).sum(), argnums=(0, 1, 2)))(*j16)
    for a16, a32, ja, name in zip(g16, g32, jg16, "qkv"):
        assert a16.dtype == torch.bfloat16, name
        _gate(a16, ja, BF16_ULP, JAX_FLOOR, f"d{name} vs JAX")
        _gate(a16, a32, F32_RTOL, F32_FLOOR["grad"], f"d{name} vs f32")


def test_halo_spmm_bf16_grads(setup):
    s = setup
    n = s["g"].n_nodes
    x = torch.from_numpy(s["rng"].normal(size=(n, 8)).astype(
        np.float32)).bfloat16().float().numpy()
    ed = s["rng"].uniform(size=s["g"].num_edges_padded).astype(np.float32)
    x32 = halo.shard_halo_nodes(s["hg"], s["mesh"], x).requires_grad_()
    x16 = x32.detach().bfloat16().requires_grad_()
    e32 = halo.halo_edge_data(s["hg"], s["mesh"], ed).requires_grad_()
    e16 = e32.detach().clone().requires_grad_()
    jx = jhalo.shard_halo_nodes(s["jhg"], s["jmesh"], x).astype(jnp.bfloat16)
    je = jhalo.halo_edge_data(s["jhg"], s["jmesh"], ed)

    def loss(e, x):
        y = halo.halo_spmm_ell(s["hg"], s["he"], s["mesh"], e, x)
        return (y.float() ** 2).sum()

    de32, dx32 = torch.autograd.grad(loss(e32, x32), (e32, x32))
    de16, dx16 = torch.autograd.grad(loss(e16, x16), (e16, x16))
    assert dx16.dtype == torch.bfloat16
    jde, jdx = jax.jit(jax.grad(lambda e, x: (jhalo.halo_spmm_ell(
        s["jhg"], s["jhe"], s["jmesh"], e, x).astype(jnp.float32) ** 2)
        .sum(), argnums=(0, 1)))(je, jx)
    _gate(dx16, jdx, BF16_ULP, JAX_FLOOR, "dx vs JAX")
    _gate(de16, jde, BF16_ULP, JAX_FLOOR, "dedata vs JAX")
    _gate(dx16, dx32, F32_RTOL, F32_FLOOR["grad"], "dx vs f32")
    _gate(de16, de32, F32_RTOL, F32_FLOOR["grad"], "dedata vs f32")


@pytest.mark.parametrize("arch", ["gat", "transformer"])
def test_fit_edge_partitioned_bf16(arch):
    """Training with dtype=bf16: f32 parameters, finite metrics, and the
    training set learned."""
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.parallel import fit_edge_partitioned

    ds = planted_partition(nodes_per_class=48, num_classes=3, feat_dim=16,
                           avg_degree=6, seed=0)
    mesh = make_mesh((4,), ("edge",), device="cpu")
    params, metrics = fit_edge_partitioned(
        ds, mesh, hidden=16, num_heads=2, num_layers=2, epochs=8,
        arch=arch, dtype=torch.bfloat16)
    assert np.isfinite(metrics["loss"])
    assert metrics["train_acc"] >= 0.5, metrics
    assert all(p.dtype == torch.float32 for p in params.parameters())
