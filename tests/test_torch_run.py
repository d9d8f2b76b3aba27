"""The port's command line (``train/run.py``) against the JAX package's.

- each ported configuration trains two epochs on the CPU at a small
  ``--scale`` and prints one JSON line with a finite validation loss;
  ``cora_gat`` reports ``layer_allclose_ok`` (config 1's gate: rtol 1e-3,
  atol 1e-4);
- one train step of each ported configuration's model, on datasets equal
  to JAX's and with JAX's weights (``flax_to_state_dict``), on the
  configuration's strategy: the loss within 1e-4 relative of JAX's, and
  each gradient within 1e-3 of that tensor's largest JAX value;
- ``reddit_sage`` (``fit_sampled``) reports a finite final loss and its
  step, sampling and evaluation times; ``--data`` trains on the committed
  OGB fixture;
- the distributed configurations, which waited for ROADMAP item M12, now
  train: each at a tiny ``--scale`` on a local mesh of its shard count on
  the CPU, with the reference's JSON keys (``loss``, ``train_acc``,
  ``val_acc``, ``num_devices``) and the plan's numbers; the table names
  every reference configuration with the reference's default epochs;
- ``utils/config.py``'s dataclasses have the reference's fields and
  defaults.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.data import synthetic as jax_synthetic
from custom_op_benchmark_tpu.models import GAT as JaxGAT
from custom_op_benchmark_tpu.models import GraphSAGE as JaxSAGE
from custom_op_benchmark_tpu.models import GraphTransformer as JaxTransformer
from custom_op_benchmark_tpu.ops import ell_dual as jax_ell_dual
from custom_op_benchmark_tpu.train import run as jax_run
from custom_op_benchmark_tpu.train.loop import (
    masked_cross_entropy as jax_masked_ce,
)
from custom_op_benchmark_tpu_torch.models import flax_to_state_dict
from custom_op_benchmark_tpu_torch.ops import ell_dual
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from custom_op_benchmark_tpu_torch.train import run
from tests.test_torch_determinism import one_thread  # noqa: F401

SCALE = 0.005
LOSS_RTOL = 1e-4
GRAD_SHARE = 1e-3


@pytest.mark.parametrize("config", sorted(run.SETUPS))
def test_ported_config_trains_on_the_cpu(config, capsys):
    assert run.main(["--config", config, "--scale", str(SCALE), "--epochs",
                     "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rec = json.loads(lines[-1])
    assert (rec["config"], rec["scale"], rec["data"]) == (config, SCALE,
                                                          None)
    loss = rec["final_loss" if config == "reddit_sage" else "val_loss"]
    assert np.isfinite(loss) and 0.0 <= rec["val_acc"] <= 1.0
    if config == "cora_gat":
        assert rec["layer_allclose_ok"] is True


def test_layer_validation_catches_a_wrong_layer(monkeypatch):
    g = run.cora_dataset(SCALE).graph
    assert run.layer_allclose(g, torch.device("cpu"))
    from custom_op_benchmark_tpu_torch import ops

    real = ops.edge_softmax
    monkeypatch.setattr(ops, "edge_softmax",
                        lambda g, s, by: real(g, s, by="dst"))
    assert not run.layer_allclose(g, torch.device("cpu"))


JAX_MODELS = {
    "cora_gat": lambda c: JaxGAT(hidden_dim=64, out_dim=c, num_layers=2,
                                 num_heads=8),
    "arxiv_gat": lambda c: JaxGAT(hidden_dim=128, out_dim=c, num_layers=3,
                                  num_heads=4),
    "arxiv_transformer": lambda c: JaxTransformer(dim=128, num_heads=4,
                                                  num_layers=3, out_dim=c),
    "reddit_sage": lambda c: JaxSAGE(hidden_dim=128, out_dim=c,
                                     num_layers=2),
}
JAX_DATA = {
    "cora_gat": dict(num_classes=7, nodes_per_class=8, feat_dim=64,
                     name="cora-like"),
    "arxiv_gat": dict(num_classes=40, nodes_per_class=20, feat_dim=128,
                      avg_degree=13, name="arxiv-like"),
}
JAX_DATA["arxiv_transformer"] = JAX_DATA["arxiv_gat"]
JAX_DATA["reddit_sage"] = dict(num_classes=41, nodes_per_class=28,
                               feat_dim=64, avg_degree=15,
                               name="reddit-like")


@pytest.mark.parametrize("config", sorted(run.SETUPS))
def test_one_train_step_matches_jax(config):
    setup = run.SETUPS[config]
    ds = setup.dataset(SCALE)
    jds = jax_synthetic.planted_partition(**JAX_DATA[config])
    np.testing.assert_array_equal(ds.features, jds.features)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    views, jviews = {}, {}
    if setup.strategy == "ell":
        views = {"ell": ell_dual(ds.graph, profile="train")}
        jviews = {"ell": jax_ell_dual(jds.graph, profile="train")}
    jmodel = JAX_MODELS[config](jds.num_classes)
    jx = jnp.asarray(jds.features)
    params = jmodel.init(jax.random.PRNGKey(0), jds.graph, jx)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jds.graph, jx, **jviews)
        return jax_masked_ce(logits, jnp.asarray(jds.labels),
                             jnp.asarray(jds.train_mask))

    jl, jgrads = jax.value_and_grad(jloss)(params)
    model = setup.model(ds)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    state = create_train_state(model, learning_rate=setup.learning_rate)
    loss, _ = make_train_step(apply_kwargs=views)(
        state, ds.graph, torch.from_numpy(ds.features),
        torch.from_numpy(ds.labels), torch.from_numpy(ds.train_mask))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= GRAD_SHARE * float(w.abs().max()) + 1e-12, (name, err)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("config, item", [
    ("products_gat_dist", "M12"), ("products_transformer_dist", "M12"),
    ("papers100m_gat_dist", "M12")])
def test_unported_configs_name_their_roadmap_item(config, item, capsys):
    """The configurations of ROADMAP ``item`` (done) train on the CPU at a
    tiny scale: one JSON line with the reference's keys, a finite loss,
    the shard count of the reference's configuration."""
    assert item == "M12"
    assert run.main(["--config", config, "--scale", "0.01", "--epochs",
                     "2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    jax_keys = ("config", "scale", "data", "loss", "train_acc", "val_acc",
                "num_devices")
    assert list(rec)[: len(jax_keys)] == list(jax_keys)
    assert rec["config"] == config and np.isfinite(rec["loss"])
    assert rec["num_devices"] == (16 if config.startswith("papers") else 8)
    assert 0.0 <= rec["val_acc"] <= 1.0
    plan = rec["plan"]
    assert plan["plan"] == "halo" and plan["order"] == "auto"
    assert plan["num_parts"] == rec["num_devices"]
    assert plan["order_details"]["picked"] in ("cluster", "balanced")


def test_reddit_sage_reports_its_times(capsys):
    """reddit_sage at a tiny scale: steps taken, the median sampling and
    evaluation times on the host; ``step_ms`` is a device time, so on the
    CPU it is null."""
    assert run.main(["--config", "reddit_sage", "--scale", "0.01",
                     "--epochs", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(rec)[:3] == ["config", "scale", "data"]
    assert rec["steps"] > 0 and np.isfinite(rec["final_loss"])
    assert rec["sample_ms"] > 0 and rec["eval_ms"] > 0
    assert rec["step_ms"] is None and "losses" not in rec


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ogb_toy")


@pytest.mark.parametrize("config", ["cora_gat", "arxiv_gat"])
def test_data_trains_on_the_fixture(config, capsys):
    assert run.main(["--config", config, "--data", FIXTURE, "--epochs",
                     "2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert (rec["config"], rec["data"]) == (config, FIXTURE)
    assert np.isfinite(rec["val_loss"])


def test_configs_match_the_reference():
    from custom_op_benchmark_tpu.utils import config as jax_config
    from custom_op_benchmark_tpu_torch.utils import config

    for name in ("GraphConfig", "ModelConfig", "TrainConfig", "BenchConfig"):
        ours = dataclasses.fields(getattr(config, name))
        theirs = dataclasses.fields(getattr(jax_config, name))
        assert [(f.name, f.default) for f in ours] == \
            [(f.name, f.default) for f in theirs], name
    for arch in ("gat", "gcn", "gin", "sage", "transformer"):
        model = config.ModelConfig(arch=arch, hidden_dim=8, out_dim=3,
                                   num_heads=2).build(in_dim=4)
        assert sum(p.numel() for p in model.parameters()) > 0
    assert config.GraphConfig(kind="random", n_nodes=30,
                              n_edges=90).build().n_nodes == 30


def test_the_table_names_every_reference_config():
    assert sorted(run.CONFIGS) == sorted(jax_run.CONFIGS)
    for name, (_, epochs) in run.CONFIGS.items():
        assert epochs == jax_run.CONFIGS[name][1], name


def test_cpu_runs_only_below_full_scale(capsys):
    assert run.main(["--config", "cora_gat", "--device", "cpu"]) == 1
    assert "CUDA device only" in capsys.readouterr().err


def test_run_needs_a_cuda_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would train")
    assert run.main(["--config", "cora_gat", "--scale", "0.01"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
