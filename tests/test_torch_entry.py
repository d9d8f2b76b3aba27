"""``custom_op_benchmark_tpu_torch.entry.entry`` against the body of the JAX
package's ``entry()`` (``__graft_entry__.py``), run at a small size.

Both build ``random_graph(n, e, seed=0, power_law=True)`` and its dual
ELL packing, draw x, q and the edge features from
``numpy.random.default_rng(0)`` in the same order, and run the remat'd
bf16 GAT on the ELL path and the f32 packed edge-bias attention. The JAX
model's parameters are carried into the port's ``fn``: its logits agree
with JAX's bf16 logits within 2⁻⁶·|JAX| + 2e-2·max|JAX| (bf16
activations), its attention within 1e-4 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import random_graph as jax_random_graph
from custom_op_benchmark_tpu.models import GAT as JaxGAT
from custom_op_benchmark_tpu.ops import (
    ell_dual as jax_ell_dual,
    ell_edge_bias_attention as jax_eb_attention,
    ell_pack_weights as jax_pack_weights,
)
from custom_op_benchmark_tpu_torch.entry import entry
from custom_op_benchmark_tpu_torch.models import flax_to_state_dict

SMALL = dict(n_nodes=600, n_edges=5000, heads=2, head_dim=8, feat_dim=16,
             out_dim=4)


def _jax_entry_body(n_nodes, n_edges, heads, head_dim, feat_dim, out_dim):
    """``__graft_entry__.entry``'s body at these sizes (its sizes are
    fixed there)."""
    n, e, h, d = n_nodes, n_edges, heads, head_dim
    g = jax_random_graph(n, e, seed=0, power_law=True)
    se, de = jax_ell_dual(g)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, feat_dim)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(n, h, d)).astype(np.float32))
    be = jnp.asarray(
        rng.normal(size=(g.num_edges_padded, d)).astype(np.float32))
    be_packed = jax_pack_weights(se, de, be)
    model = JaxGAT(hidden_dim=h * d, out_dim=out_dim, num_layers=2,
                   num_heads=h, remat=True, dtype=jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(1), g, x, ell=(se, de))["params"]

    def fwd(params, x, q, be_packed):
        logits = model.apply({"params": params}, g, x, ell=(se, de))
        attn = jax_eb_attention(de, se, q, q, q, be_packed)
        return logits, attn

    return fwd, (params, x, q, be_packed)


@pytest.fixture(scope="module")
def both():
    return _jax_entry_body(**SMALL), entry(device="cpu", **SMALL)


def test_entry_matches_the_jax_entry_body(both):
    (jfn, jargs), (fn, args) = both
    jlogits, jattn = jfn(*jargs)
    params = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       jargs[0]))
    assert sorted(params) == sorted(args[0])
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(jargs[2]))
    with torch.no_grad():
        logits, attn = fn(params, *args[1:])
    assert logits.dtype == torch.float32 and logits.shape == (
        SMALL["n_nodes"], SMALL["out_dim"])
    assert attn.dtype == torch.float32
    want = np.asarray(jlogits)
    tol = 2.0 ** -6 * np.abs(want) + 2e-2 * np.abs(want).max()
    assert (np.abs(logits.numpy() - want) <= tol).all()
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), rtol=1e-4,
                               atol=1e-4)


def test_entry_backward_through_the_remat_bf16_gat(both):
    _, (fn, args) = both
    params = args[0]
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.values())
    logits, _ = fn(*args)
    logits.sum().backward()
    for name, p in params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        p.grad = None


def test_entry_needs_the_card_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(**SMALL)
