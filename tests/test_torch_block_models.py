"""The port's models on the dense-block path, its train step and
``fit_full_graph``, against the JAX package.

- GAT (whole-stack layout), GCN and GraphSAGE with ``block=`` load the JAX
  model's parameters through ``flax_to_state_dict``; logits (1e-4) and
  every gradient (1e-3) are held to JAX's block path, and the port's block
  path to its own segment path (tests/test_models.py:222-302).
- ``make_train_step()`` keeps the reference's ``dropout=False``: one step
  of ``GAT(dropout_rate=0.5)`` on the ELL view takes the ELL route and
  gives JAX's loss and updated parameters (1e-5).
- ``fit_full_graph(strategy="block"/"auto")`` trains the reference's
  clique dataset above 0.9 validation accuracy, and without a device it
  needs the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from custom_op_benchmark_tpu.data import synthetic as jax_synthetic
from custom_op_benchmark_tpu.graph import block_graph as jax_block_graph
from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.models import (
    GAT as JaxGAT,
    GCN as JaxGCN,
    GraphSAGE as JaxSAGE,
)
from custom_op_benchmark_tpu.ops import ell_dual as jax_ell_dual
from custom_op_benchmark_tpu.train import loop as jax_loop
from custom_op_benchmark_tpu_torch.data import synthetic
from custom_op_benchmark_tpu_torch.graph import block_graph, clique_batch
from custom_op_benchmark_tpu_torch.models import (
    GAT,
    GCN,
    GraphSAGE,
    flax_to_state_dict,
)
from custom_op_benchmark_tpu_torch.models import gat as gat_module
from custom_op_benchmark_tpu_torch.ops import dispatch, ell_dual
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    fit_full_graph,
    make_train_step,
)

LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def cliques():
    g, jg = clique_batch(5, 9), jax_clique_batch(5, 9)
    x = np.random.default_rng(0).normal(size=(g.n_nodes, 12)).astype(
        np.float32)
    return dict(g=g, jg=jg, bg=block_graph(g), jbg=jax_block_graph(jg), x=x)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _block_vs_jax(jmodel, model, c):
    jx = jnp.asarray(c["x"])
    params = _perturbed(jmodel.init(jax.random.PRNGKey(1), c["jg"],
                                    jx)["params"], 2)

    def jloss(p):
        y = jmodel.apply({"params": p}, c["jg"], jx, block=c["jbg"])
        return (y ** 2).sum(), y

    with jax.default_matmul_precision("highest"):
        (_, jy), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    x = torch.from_numpy(c["x"])
    y = model(c["g"], x, block=c["bg"])
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **LOGITS_TOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    # The port's block path against its segment path, same weights.
    blk = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    y_seg = model(c["g"], x)
    (y_seg ** 2).sum().backward()
    torch.testing.assert_close(y.detach(), y_seg.detach(), rtol=2e-3,
                               atol=2e-3)
    for a, p in zip(blk, model.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("layers, heads", [(2, 2), (3, 4)])
def test_gat_block_path_matches_jax(cliques, layers, heads):
    _block_vs_jax(JaxGAT(hidden_dim=8, out_dim=5, num_layers=layers,
                         num_heads=heads),
                  GAT(8, 5, num_layers=layers, num_heads=heads, in_dim=12),
                  cliques)


@pytest.mark.parametrize("jcls, cls", [(JaxGCN, GCN), (JaxSAGE, GraphSAGE)])
@pytest.mark.parametrize("layers", [2, 3])
def test_gcn_sage_block_paths_match_jax(cliques, jcls, cls, layers):
    _block_vs_jax(jcls(hidden_dim=8, out_dim=4, num_layers=layers),
                  cls(8, 4, num_layers=layers, in_dim=12), cliques)


def test_gat_leaves_the_block_layout_when_dropout_is_on(cliques,
                                                        monkeypatch):
    """As the reference: with dropout active the stack runs on the segment
    path; in eval mode it takes the block layout."""
    calls = []
    real = gat_module.block_gat_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gat_module, "block_gat_attention", counted)
    model = GAT(8, 5, num_heads=2, dropout_rate=0.5, in_dim=12)
    x = torch.from_numpy(cliques["x"])
    model.train()
    model(cliques["g"], x, block=cliques["bg"])
    assert calls == []
    model.eval()
    model(cliques["g"], x, block=cliques["bg"])
    assert len(calls) == 2


def test_train_step_without_dropout_matches_jax(monkeypatch):
    """F1: ``make_train_step()`` runs the forward deterministically, so a
    GAT with dropout_rate=0.5 stays on the ELL route and its step is
    JAX's step from the same weights."""
    kw = dict(num_classes=3, nodes_per_class=40, feat_dim=12, avg_degree=6,
              seed=3)
    ds, jds = synthetic.planted_partition(**kw), \
        jax_synthetic.planted_partition(**kw)
    jmodel = JaxGAT(hidden_dim=8, out_dim=3, num_layers=2, num_heads=2,
                    dropout_rate=0.5)
    jell = jax_ell_dual(jds.graph, profile="train")
    jx = jnp.asarray(ds.features)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(1), jds.graph,
                                    jx)["params"], 4)
    tx = optax.adamw(1e-2, weight_decay=5e-4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_loop.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=jparams, opt_state=tx.init(jparams),
                                 apply_fn=jmodel.apply, tx=tx)
    jstep = jax_loop.make_train_step(apply_kwargs={"ell": jell})
    with jax.default_matmul_precision("highest"):
        jstate, jl, _ = jstep(jstate, jds.graph, jx,
                              jnp.asarray(ds.labels),
                              jnp.asarray(ds.train_mask))

    calls = []
    real = gat_module.ell_gat_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gat_module, "ell_gat_attention", counted)
    model = GAT(8, 3, num_layers=2, num_heads=2, dropout_rate=0.5,
                in_dim=12)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    state = create_train_state(model, learning_rate=1e-2, weight_decay=5e-4)
    step = make_train_step(apply_kwargs={"ell": ell_dual(ds.graph,
                                                         profile="train")})
    loss, _ = step(state, ds.graph, torch.from_numpy(ds.features),
                   torch.from_numpy(ds.labels),
                   torch.from_numpy(ds.train_mask))
    assert len(calls) == 2          # both layers on the fused ELL path
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_train_step_with_dropout_runs_in_train_mode():
    ds = synthetic.planted_partition(num_classes=2, nodes_per_class=10,
                                     feat_dim=4, seed=1)
    model = GAT(4, 2, num_heads=2, dropout_rate=0.5, in_dim=4)
    seen = []
    model.register_forward_pre_hook(lambda m, a: seen.append(m.training))
    state = create_train_state(model)
    args = (ds.graph, torch.from_numpy(ds.features),
            torch.from_numpy(ds.labels), torch.from_numpy(ds.train_mask))
    make_train_step()(state, *args)
    make_train_step(dropout=True)(state, *args)
    assert seen == [False, True]


def _clique_dataset():
    """The reference's blocky dataset (tests/test_models.py:276-302)."""
    rng = np.random.default_rng(0)
    g = clique_batch(24, 12)
    n, c = g.n_nodes, 4
    labels = (np.arange(n) // 12 % c).astype(np.int32)
    feats = (np.eye(c, dtype=np.float32)[labels] * 2.0
             + rng.normal(size=(n, c)).astype(np.float32) * 0.3)
    tr = rng.random(n) < 0.6
    return synthetic.NodeClassificationDataset(
        graph=g, features=feats, labels=labels, train_mask=tr,
        val_mask=~tr, test_mask=np.zeros(n, bool), num_classes=c,
        name="cliques")


@pytest.mark.parametrize("strategy", ["block", "auto"])
def test_fit_full_graph_block_strategy_end_to_end(strategy, monkeypatch):
    """``auto`` reaches the dense blocks on this dataset; the whole-stack
    GAT trains to separation either way."""
    calls = []
    real = gat_module.block_gat_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gat_module, "block_gat_attention", counted)
    assert dispatch.resolve(clique_batch(512, 30), "auto") == "dense_block"
    model = GAT(hidden_dim=16, out_dim=4, num_layers=2, num_heads=2,
                in_dim=4)
    _, metrics = fit_full_graph(model, _clique_dataset(), epochs=40,
                                strategy=strategy, device="cpu")
    assert metrics["val_acc"] > 0.9, metrics
    assert len(calls) == 2 * 41      # 40 steps and the final evaluation


def test_fit_full_graph_block_refuses_a_graph_that_is_not_blocky():
    ds = synthetic.planted_partition(num_classes=2, nodes_per_class=100,
                                     feat_dim=4)
    with pytest.raises(ValueError, match="too large"):
        fit_full_graph(GCN(4, 2, in_dim=4), ds, epochs=1, strategy="block",
                       device="cpu")


def test_fit_full_graph_needs_the_card_unless_given_a_device(monkeypatch):
    """F5: no device and no card is an error, never a CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = synthetic.planted_partition(num_classes=2, nodes_per_class=8,
                                     feat_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_full_graph(GCN(4, 2, in_dim=4), ds, epochs=1)
    _, metrics = fit_full_graph(GCN(4, 2, in_dim=4), ds, epochs=1,
                                device="cpu")
    assert np.isfinite(metrics["val_loss"])
