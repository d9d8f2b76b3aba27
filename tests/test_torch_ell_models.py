"""The port's models on the ELL path, its synthetic datasets, full-graph
training and the power-law suite, against the JAX package.

GAT, GCN, GraphSAGE and the transformer's ``ell=`` path (with and without
edge features) load the JAX model's parameters through
``flax_to_state_dict``; both run their ELL path on the same numpy inputs,
and the port's logits (1e-4) and every parameter's gradient (1e-3) are
held to JAX's. ``planted_partition`` equals JAX's array for array.
Dropout is 0 where the two packages are compared: their random streams
differ.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.data import synthetic as jax_synthetic
from custom_op_benchmark_tpu.models import (
    GAT as JaxGAT,
    GCN as JaxGCN,
    GraphSAGE as JaxSAGE,
    GraphTransformer as JaxTransformer,
)
from custom_op_benchmark_tpu.ops import ell_dual as jax_ell_dual
from custom_op_benchmark_tpu.train.loop import (
    masked_cross_entropy as jax_masked_ce,
)
from custom_op_benchmark_tpu_torch.data import synthetic
from custom_op_benchmark_tpu_torch.models import (
    GAT,
    GCN,
    GraphSAGE,
    GraphTransformer,
    flax_to_state_dict,
)
from custom_op_benchmark_tpu_torch.models import gat as gat_module
from custom_op_benchmark_tpu_torch.ops import ell_dual
from custom_op_benchmark_tpu_torch.train import (
    fit_full_graph,
    masked_cross_entropy,
)
from custom_op_benchmark_tpu_torch.utils import bench_suite

LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
DATA = dict(num_classes=3, nodes_per_class=40, feat_dim=12, avg_degree=6,
            seed=3)


@pytest.fixture(scope="module")
def data():
    ds = synthetic.planted_partition(**DATA)
    jds = jax_synthetic.planted_partition(**DATA)
    return dict(ds=ds, jds=jds, ell=ell_dual(ds.graph, profile="train"),
                jell=jax_ell_dual(jds.graph, profile="train"))


def _perturbed(params, seed):
    """Perturb zero biases and unit scales, so every leaf's conversion
    shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
            np.float32), params)


def _compare(jmodel, model, data, x, *extra):
    """Logits, loss and every gradient of the two models' ELL paths."""
    ds, jds = data["ds"], data["jds"]
    jx = jnp.asarray(x)
    jextra = tuple(jnp.asarray(a) for a in extra)
    params = jmodel.init(jax.random.PRNGKey(1), jds.graph, jx,
                         *jextra)["params"]
    params = _perturbed(params, 4)
    labels, mask = ds.labels, ds.train_mask

    def jloss(p):
        logits = jmodel.apply({"params": p}, jds.graph, jx, *jextra,
                              ell=data["jell"])
        return jax_masked_ce(logits, jnp.asarray(labels),
                             jnp.asarray(mask)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    logits = model(ds.graph, torch.from_numpy(x),
                   *map(torch.from_numpy, extra), ell=data["ell"])
    loss = masked_cross_entropy(logits, torch.from_numpy(labels),
                                torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGITS_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **LOGITS_TOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def _features(data, width):
    return np.random.default_rng(5).normal(
        size=(data["ds"].graph.n_nodes, width)).astype(np.float32)


@pytest.mark.parametrize("layers, heads", [(2, 2), (3, 4)])
def test_gat_ell_path_matches_jax(data, layers, heads):
    x = _features(data, 12)
    _compare(JaxGAT(hidden_dim=8, out_dim=3, num_layers=layers,
                    num_heads=heads),
             GAT(hidden_dim=8, out_dim=3, num_layers=layers, num_heads=heads,
                 in_dim=12), data, x)


@pytest.mark.parametrize("jcls, cls", [(JaxGCN, GCN), (JaxSAGE, GraphSAGE)])
@pytest.mark.parametrize("layers", [2, 3])
def test_gcn_sage_ell_paths_match_jax(data, jcls, cls, layers):
    x = _features(data, 12)
    _compare(jcls(hidden_dim=8, out_dim=3, num_layers=layers),
             cls(hidden_dim=8, out_dim=3, num_layers=layers, in_dim=12),
             data, x)


@pytest.mark.parametrize("edge_feat", [False, True])
def test_transformer_ell_path_matches_jax(data, edge_feat):
    x = _features(data, 16)
    extra = ()
    if edge_feat:
        extra = (np.random.default_rng(6).normal(
            size=(data["ds"].graph.num_edges_padded, 8)).astype(np.float32),)
    _compare(JaxTransformer(dim=16, num_heads=2, num_layers=2, out_dim=3),
             GraphTransformer(16, 2, 2, out_dim=3), data, x, *extra)


def test_gat_layer_with_a_residual_projection_matches_jax(data):
    """A lone residual layer whose input width differs from h·d has a
    ``W_res`` projection (GAT stacks never do): it converts too."""
    from custom_op_benchmark_tpu.models.gat import GATLayer as JaxGATLayer
    from custom_op_benchmark_tpu_torch.models import GATLayer

    ds, jds = data["ds"], data["jds"]
    x = _features(data, 12)
    jlayer = JaxGATLayer(out_dim=8, num_heads=2, residual=True)
    params = _perturbed(jlayer.init(jax.random.PRNGKey(2), jds.graph,
                                    jnp.asarray(x))["params"], 7)
    want = jlayer.apply({"params": params}, jds.graph, jnp.asarray(x),
                        ell=data["jell"])
    layer = GATLayer(12, 8, num_heads=2, residual=True)
    layer.load_state_dict(flax_to_state_dict(params), strict=True)
    assert layer.W_res is not None
    got = layer(ds.graph, torch.from_numpy(x), ell=data["ell"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGITS_TOL)


def test_segment_and_ell_paths_agree(data):
    """Without a reference: the port's two GAT paths from one set of
    weights, logits and gradients."""
    ds = data["ds"]
    x = torch.from_numpy(_features(data, 12))
    model = GAT(8, 3, num_heads=2, in_dim=12,
                generator=torch.Generator().manual_seed(0))
    outs = {}
    for path, views in (("segment", {}), ("ell", {"ell": data["ell"]})):
        model.zero_grad()
        y = model(ds.graph, x, **views)
        (y ** 2).sum().backward()
        outs[path] = (y.detach(), [p.grad.clone() for p in
                                   model.parameters()])
    torch.testing.assert_close(outs["ell"][0], outs["segment"][0],
                               **LOGITS_TOL)
    for a, b in zip(outs["ell"][1], outs["segment"][1]):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_gat_takes_the_ell_path_only_without_dropout(data, monkeypatch):
    """The reference's routing: ELL when dropout_rate == 0 or the module is
    in eval mode (its ``deterministic``)."""
    calls = []
    real = gat_module.ell_gat_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gat_module, "ell_gat_attention", counted)
    ds, ell = data["ds"], data["ell"]
    x = torch.from_numpy(_features(data, 12))
    model = GAT(8, 3, num_heads=2, dropout_rate=0.5, in_dim=12)
    model.train()
    model(ds.graph, x, ell=ell)
    # Only the output layer (no dropout of its own) took the ELL path.
    assert len(calls) == 1
    model.eval()
    model(ds.graph, x, ell=ell)
    assert len(calls) == 3


def test_gat_remat_gives_the_same_gradients(data):
    ds = data["ds"]
    x = torch.from_numpy(_features(data, 12))
    grads = []
    for remat in (False, True):
        model = GAT(8, 3, num_layers=3, num_heads=2, remat=remat, in_dim=12,
                    generator=torch.Generator().manual_seed(1))
        (model(ds.graph, x, ell=data["ell"]) ** 2).sum().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["gat_block", "gat_dtype", "gcn_block",
                                  "sage_block", "sage_in_cols"])
def test_unported_model_options_raise(data, case):
    ds = data["ds"]
    x = torch.zeros(ds.graph.n_nodes, 12)
    with pytest.raises(NotImplementedError, match="ROADMAP M"):
        if case == "gat_dtype":
            GAT(8, 3, dtype=torch.bfloat16, in_dim=12)
        elif case == "gat_block":
            GAT(8, 3, in_dim=12)(ds.graph, x, block=object())
        elif case == "gcn_block":
            GCN(8, 3, in_dim=12)(ds.graph, x, block=object())
        elif case == "sage_block":
            GraphSAGE(8, 3, in_dim=12)(ds.graph, x, block=object())
        else:
            GraphSAGE(8, 3, in_dim=12)(ds.graph, x, in_cols=object())


@pytest.mark.parametrize("maker", ["planted_partition", "cora_like",
                                   "arxiv_like"])
def test_datasets_equal_jax(maker):
    kw = DATA if maker == "planted_partition" else (
        dict(nodes_per_class=30) if maker == "arxiv_like" else {})
    ds = getattr(synthetic, maker)(**kw)
    jds = getattr(jax_synthetic, maker)(**kw)
    assert (ds.num_classes, ds.name) == (jds.num_classes, jds.name)
    for field in ("features", "labels", "train_mask", "val_mask",
                  "test_mask"):
        a, b = getattr(ds, field), getattr(jds, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in ("src", "dst", "indptr_r", "csc_perm", "indptr_c"):
        np.testing.assert_array_equal(getattr(ds.graph, field).numpy(),
                                      np.asarray(getattr(jds.graph, field)),
                                      err_msg=field)


def test_fit_full_graph_gat_reaches_val_acc():
    """The verify recipe's training story: a 2-layer GAT on a planted
    partition, full graph on the ELL path, above 0.75 validation
    accuracy."""
    ds = synthetic.planted_partition(num_classes=4, nodes_per_class=100,
                                     feat_dim=16, seed=2)
    model = GAT(16, 4, num_heads=2, in_dim=16)
    _, metrics = fit_full_graph(model, ds, epochs=30, learning_rate=1e-2,
                                strategy="ell", log_every=10)
    assert metrics["val_acc"] > 0.75, metrics
    assert [h["epoch"] for h in metrics["history"]] == [10, 20, 30]


def test_fit_full_graph_stops_at_the_target():
    ds = synthetic.planted_partition(num_classes=3, nodes_per_class=30,
                                     feat_dim=16, seed=1)
    _, metrics = fit_full_graph(GCN(16, 3, in_dim=16), ds, epochs=200,
                                strategy="ell", log_every=1,
                                target_val_acc=0.9)
    assert len(metrics["history"]) < 200
    assert metrics["history"][-1]["val_acc"] >= 0.9


@pytest.mark.parametrize("strategy, err", [("auto", NotImplementedError),
                                           ("block", NotImplementedError),
                                           ("csr", ValueError)])
def test_fit_full_graph_refuses_other_strategies(strategy, err):
    ds = synthetic.planted_partition(num_classes=2, nodes_per_class=8,
                                     feat_dim=4)
    with pytest.raises(err):
        fit_full_graph(GCN(4, 2, in_dim=4), ds, epochs=1, strategy=strategy)


def test_powerlaw_case_matches_the_reference_inputs():
    from custom_op_benchmark_tpu.graph import random_graph as jax_rg

    case = bench_suite.powerlaw_case(2048, 16384, 32, device="cpu")
    jg = jax_rg(2048, 16384, seed=0, power_law=True)
    np.testing.assert_array_equal(case.g.src.numpy(), np.asarray(jg.src))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        case.q.numpy(), rng.normal(size=(2048, 32)).astype(np.float32))
    assert case.qh4.shape == (2048, 4, 8) and case.a_l.shape == (4, 8)


def test_powerlaw_suite_small_is_ok(capsys):
    assert bench_suite.main(["--powerlaw", "--small", "--device",
                             "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"suite_ok": True, "checks": 7, "benches": 23}
