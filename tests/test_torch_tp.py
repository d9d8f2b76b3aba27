"""Head parallelism of the port (``parallel/tp.py``) against the JAX package.

Counterpart of tests/test_tp.py: q, k, v split over a ``("head",)`` mesh
of 4 (the port's local mesh on the CPU; JAX's fake CPU devices), on the
reference's power-law graph. The head-sharded ops agree with JAX's and
with the port's single-device ELL ops within the reference's tolerances,
gradients too, and heads that do not divide by the axis are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.ops import ell_dual as jax_ell_dual
from custom_op_benchmark_tpu.parallel import make_mesh as jax_make_mesh
from custom_op_benchmark_tpu.parallel import tp as jtp
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.ops import (
    ell_attention,
    ell_dual,
    ell_gat_attention,
)
from custom_op_benchmark_tpu_torch.parallel import make_mesh
from custom_op_benchmark_tpu_torch.parallel.tp import (
    shard_heads,
    tp_attention,
    tp_gat_attention,
    tp_transformer_block,
)
from tests.test_torch_determinism import one_thread  # noqa: F401

N, H, D = 200, 4, 8

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def setup():
    g = random_graph(N, 1500, seed=0, power_law=True)
    jg = jax_random_graph(N, 1500, seed=0, power_law=True)
    return dict(views=ell_dual(g), jviews=jax_ell_dual(jg),
                mesh=make_mesh((4,), ("head",), device="cpu"),
                jmesh=jax_make_mesh((4,), ("head",)),
                rng=np.random.default_rng(0))


def _np(x):
    return np.asarray(jax.device_get(x))


def test_tp_attention_matches_single_device(setup):
    se, de = setup["views"]
    jse, jde = setup["jviews"]
    mesh, jmesh = setup["mesh"], setup["jmesh"]
    arrs = [setup["rng"].normal(size=(N, H, D)).astype(np.float32)
            for _ in range(3)]
    q, k, v = (shard_heads(mesh, a) for a in arrs)
    jq, jk, jv = (jtp.shard_heads(jmesh, a) for a in arrs)
    qg = q.clone().requires_grad_()
    y = tp_attention(de, se, mesh, qg, k, v)
    np.testing.assert_allclose(y.detach().numpy(),
                               ell_attention(de, se, q, k, v).numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        y.detach().numpy(), _np(jtp.tp_attention(jde, jse, jmesh, jq, jk,
                                                 jv)), rtol=2e-5, atol=2e-5)
    (gq,) = torch.autograd.grad((y ** 2).sum(), (qg,))
    q1 = q.clone().requires_grad_()
    (gq_ref,) = torch.autograd.grad(
        (ell_attention(de, se, q1, k, v) ** 2).sum(), (q1,))
    jgq = jax.jit(jax.grad(lambda q: (jtp.tp_attention(
        jde, jse, jmesh, q, jk, jv) ** 2).sum()))(jq)
    np.testing.assert_allclose(gq.numpy(), gq_ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gq.numpy(), _np(jgq), rtol=1e-4, atol=1e-4)


def test_tp_gat_matches_single_device(setup):
    se, de = setup["views"]
    jse, jde = setup["jviews"]
    rng = setup["rng"]
    a_l, a_r = (rng.normal(size=(H, D)).astype(np.float32) for _ in range(2))
    z = rng.normal(size=(N, H, D)).astype(np.float32)
    y = tp_gat_attention(de, se, setup["mesh"], torch.from_numpy(a_l),
                         torch.from_numpy(a_r),
                         shard_heads(setup["mesh"], z))
    want = ell_gat_attention(de, se, torch.from_numpy(a_l),
                             torch.from_numpy(a_r), torch.from_numpy(z))
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    jy = jtp.tp_gat_attention(jde, jse, setup["jmesh"], jnp.asarray(a_l),
                              jnp.asarray(a_r),
                              jtp.shard_heads(setup["jmesh"], z))
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=2e-5, atol=2e-5)


def test_tp_transformer_block(setup):
    se, de = setup["views"]
    jse, jde = setup["jviews"]
    rng = setup["rng"]
    f = 16
    shapes = [("wq", (f, H, D)), ("wk", (f, H, D)), ("wv", (f, H, D)),
              ("wo", (H, D, f))]
    raw = {k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in shapes}
    x = rng.normal(size=(N, f)).astype(np.float32)
    params = {k: torch.from_numpy(v) for k, v in raw.items()}
    y = tp_transformer_block(de, se, setup["mesh"], params,
                             torch.from_numpy(x))
    q, k, v = (torch.einsum("nf,fhd->nhd", torch.from_numpy(x), params[w])
               for w in ("wq", "wk", "wv"))
    want = torch.einsum("nhd,hdf->nf", ell_attention(de, se, q, k, v),
                        params["wo"])
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    jy = jtp.tp_transformer_block(jde, jse, setup["jmesh"],
                                  {k: jnp.asarray(v) for k, v in raw.items()},
                                  jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=2e-4, atol=2e-4)


def test_tp_rejects_indivisible_heads(setup):
    se, de = setup["views"]
    q = torch.zeros((10, 3, 8))
    with pytest.raises(ValueError):
        tp_attention(de, se, setup["mesh"], q, q, q)
