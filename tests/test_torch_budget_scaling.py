"""The per-shard budget (``parallel/budget.py``), the shard-count sweeps
(``utils/bench_scaling.py``) and ``dryrun_multichip`` of the port.

- ``shard_budget`` on a host plan's numbers equals the JAX package's,
  field by field (the same arithmetic; the port has no TPU capacity
  table, and ``fits`` takes the card's memory or a given capacity);
- ``bench_scaling --small --device cpu`` runs every sweep once on the CPU
  with the times null (not measured there) and the exchange accounting of
  each plan;
- ``dryrun_multichip(8)`` takes one step of every plan with finite
  losses.
"""

import json

import numpy as np
import pytest

from custom_op_benchmark_tpu.parallel import budget as jbudget
from custom_op_benchmark_tpu.parallel import halo as jhalo
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.parallel import budget, halo
from tests.test_torch_determinism import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def stats():
    g = random_graph(2048, 20000, seed=1, power_law=True)
    src, dst = g.src.numpy()[: g.n_edges], g.dst.numpy()[: g.n_edges]
    args = (src, dst, g.n_nodes, g.n_edges, 4, -(-g.n_nodes // 4),
            g.num_edges_padded)
    return (halo.plan_stats(*args, hub_threshold="auto"),
            jhalo.plan_stats(*args, hub_threshold="auto"))


def test_plan_stats_equal_jax(stats):
    ours, theirs = stats
    for f in ("num_parts", "n_per", "halo", "n_hub", "edges_per_part",
              "pack_slots", "interior_frac"):
        assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("remat", [True, False])
def test_shard_budget_equals_jax(stats, dtype_bytes, remat):
    ours, theirs = stats
    kw = dict(feat_dim=128, heads=4, head_dim=16, num_layers=2,
              dtype_bytes=dtype_bytes, remat=remat)
    a, b = budget.shard_budget(ours, **kw), jbudget.shard_budget(theirs,
                                                                 **kw)
    for f in ("features", "layer_live", "alpha_residual", "ell_indices",
              "params_opt", "total"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.fits(a.total * 2) and not a.fits(a.total)


def test_budget_table_with_a_given_capacity(stats):
    rows = budget.budget_table({4: stats[0]}, feat_dim=128, heads=4,
                               head_dim=16, capacity_bytes=80e9)
    assert len(rows) == 4 and all(r["fits_card"] for r in rows)
    assert {r["dtype"] for r in rows} == {"bf16", "f32"}


def test_bench_scaling_small_on_the_cpu(capsys):
    from custom_op_benchmark_tpu_torch.utils import bench_scaling

    assert bench_scaling.main(["--small", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["device"].startswith("cpu")
    assert [r["shards"] for r in rec["scaling"]] == [1, 2, 4, 8, 16]
    for r in rec["scaling"] + rec["hub_scaling"]:
        assert r["fwd_ms"] is None and r["grad_ms"] is None
        assert r["layout"].startswith("P shards on one card")
        assert r["comm_rows_real"] <= r["comm_rows_padded"]
    assert rec["scaling"][0]["comm_rows_real"] == 0   # one shard: no halo
    assert all(r["step_ms"] is None for r in rec["dp_scaling"])


def test_dryrun_multichip_on_the_cpu():
    from custom_op_benchmark_tpu_torch.entry import dryrun_multichip

    losses = dryrun_multichip(8, device="cpu")
    assert set(losses) == {"plans", "tp", "edge_x_head", "hub",
                           "transformer"}
    assert all(np.isfinite(v) for v in losses.values())
