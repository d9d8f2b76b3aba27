"""The port's GraphTransformer and training step against the JAX package.

The JAX model runs its ``tiled=`` path (Pallas in interpret mode on the
CPU); the port loads the same parameters through ``flax_to_state_dict``.
Same numpy inputs for both, f32.
"""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from custom_op_benchmark_tpu.graph import clique_batch as jax_clique
from custom_op_benchmark_tpu.graph.tiled import tile_graph as jax_tile_graph
from custom_op_benchmark_tpu.models import GraphTransformer as JaxTransformer
from custom_op_benchmark_tpu.train.loop import (
    masked_cross_entropy as jax_masked_ce,
)
from custom_op_benchmark_tpu_torch.graph import clique_batch, tile_graph
from custom_op_benchmark_tpu_torch.models import (
    GraphTransformer,
    flax_to_state_dict,
)
from custom_op_benchmark_tpu_torch.models.transformer import (
    GraphTransformerLayer,
)
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    make_train_step,
    masked_cross_entropy,
)

TOL = dict(rtol=1e-4, atol=1e-4)
DIM, HEADS, LAYERS, OUT = 16, 2, 2, 4


@pytest.fixture(scope="module")
def workload():
    g, jg = clique_batch(6, 10), jax_clique(6, 10)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, OUT, size=g.n_nodes).astype(np.int64)
    mask = rng.random(g.n_nodes) < 0.7
    return (g, jg, tile_graph(g, 16, 16), jax_tile_graph(jg, 16, 16), labels,
            mask)


@pytest.mark.parametrize("in_dim", [DIM, 12])
def test_transformer_matches_jax_logits_and_grads(workload, in_dim):
    g, jg, tg, jtg, labels, mask = workload
    x = np.random.default_rng(1).normal(size=(g.n_nodes, in_dim)).astype(
        np.float32)
    jmodel = JaxTransformer(dim=DIM, num_heads=HEADS, num_layers=LAYERS,
                            out_dim=OUT)
    params = jmodel.init(jax.random.PRNGKey(2), jg, jnp.asarray(x),
                         tiled=jtg)["params"]
    # Perturb the zero-initialised biases and unit LayerNorm scales so the
    # conversion of every leaf is exercised.
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
            np.float32), params)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jg, jnp.asarray(x), tiled=jtg)
        return jax_masked_ce(logits, jnp.asarray(labels),
                             jnp.asarray(mask)), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    model = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT, in_dim=in_dim)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    logits = model(g, torch.from_numpy(x), tiled=tg)
    loss = masked_cross_entropy(logits, torch.from_numpy(labels),
                                torch.from_numpy(mask))
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_converter_transposes_dense_kernels():
    params = {"layer0": {"mlp1": {"kernel": np.arange(6.0).reshape(2, 3),
                                  "bias": np.zeros(3)},
                         "ln1": {"scale": np.ones(2), "bias": np.zeros(2)}}}
    sd = flax_to_state_dict(params)
    assert sorted(sd) == ["layers.0.ln1.bias", "layers.0.ln1.weight",
                          "layers.0.mlp1.bias", "layers.0.mlp1.weight"]
    assert sd["layers.0.mlp1.weight"].shape == (3, 2)
    assert sd["layers.0.mlp1.weight"][2, 1] == 5.0


def test_layernorm_eps_and_gelu_follow_flax():
    """flax: LayerNorm eps 1e-6, gelu in its tanh form; torch's defaults
    are 1e-5 and exact. Inputs where the difference shows."""
    layer = GraphTransformerLayer(8, 2, 4, 16)
    assert layer.ln1.eps == layer.ln2.eps == 1e-6
    x = (1e-3 * np.random.default_rng(0).normal(size=(5, 8))).astype(
        np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)}},
        jnp.asarray(x)))
    got = layer.ln1(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    z = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(z)))
    got = torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(z)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_adamw_matches_optax():
    """Three optimizer steps from identical gradients, atol 1e-5."""
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 3), "b": (3,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx = optax.adamw(1e-2, weight_decay=5e-4)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    for gr in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in gr.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in init.items()})
    state = create_train_state(module)
    for gr in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(gr[k])
        state.optimizer.step()
    for k in shapes:
        np.testing.assert_allclose(module[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=0, atol=1e-5)


def test_train_step_takes_finite_steps(workload):
    g, _, tg, _, labels, mask = workload
    gen = torch.Generator().manual_seed(0)
    model = GraphTransformer(DIM, HEADS, LAYERS, out_dim=OUT, generator=gen)
    state = create_train_state(model)
    step = make_train_step(apply_kwargs={"tiled": tg})
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(g.n_nodes, DIM)).astype(np.float32))
    y, m = torch.from_numpy(labels), torch.from_numpy(mask)
    for _ in range(3):
        loss, acc = step(state, g, x, y, m)
        assert torch.isfinite(loss) and 0.0 <= float(acc) <= 1.0
    assert state.step == 3


def test_generator_makes_initialisation_repeatable():
    def build(seed):
        return GraphTransformer(DIM, HEADS, 1, out_dim=OUT,
                                generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.layers[0].attn.Wq.weight,
                           c.layers[0].attn.Wq.weight)


@pytest.mark.parametrize("view", ["segment", "block", "edge_feat"])
def test_unported_paths_raise(workload, view):
    """Without ``ell=`` the transformer has only its tile path; the ELL
    path is held to JAX in tests/test_torch_ell_models.py."""
    g, _, tg, _, _, _ = workload
    model = GraphTransformer(DIM, HEADS, 1)
    x = torch.zeros(g.n_nodes, DIM)
    kwargs = {"segment": {}, "block": {"block": object()},
              "edge_feat": {"tiled": tg}}[view]
    ef = torch.zeros(g.num_edges_padded, 4) if view == "edge_feat" else None
    with pytest.raises(NotImplementedError, match="ROADMAP M"):
        model(g, x, ef, **kwargs)
