"""The port's measurement drivers against the JAX package's scripts.

``experiments/exp_bwd_accounting.py``'s pass 1, twin hop and pass 2 are
held to ``scripts/exp_bwd_accounting.py``'s ``pass1`` / ``pass2`` (JAX) on
the same small power-law graph and the same numpy inputs at 1e-4, and to
the port's own ``_attn_bwd`` bit for bit. ``experiments/exp_balance.py``'s
and ``exp_pack_private.py``'s ``plan_stats`` figures equal the JAX scripts'
at P ∈ {1, 2, 4} on the same graphs.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import (
    cluster_order as jax_cluster_order,
    degree_balanced_order as jax_degree_balanced_order,
    random_graph as jax_random_graph,
    reorder_graph as jax_reorder_graph,
)
from custom_op_benchmark_tpu.ops import ell_dual as jax_ell_dual
from custom_op_benchmark_tpu.ops.ell import (
    _attn_fwd_impl as jax_attn_fwd_impl,
    ell_cross_packed as jax_ell_cross_packed,
)
from custom_op_benchmark_tpu_torch.experiments import (
    exp_balance,
    exp_bwd_accounting,
    exp_pack_private,
)
from custom_op_benchmark_tpu_torch.graph import (
    degree_balanced_order,
    random_graph,
    reorder_graph,
)
from custom_op_benchmark_tpu_torch.ops import ell_dual
from custom_op_benchmark_tpu_torch.ops.ell import _attn_bwd, _attn_fwd

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
TOL = dict(rtol=1e-4, atol=1e-4)
DEVICES = (1, 2, 4)
PLAN_GRAPH = (3000, 24_000)     # nodes, edges of the plan probes' graph


def jax_script(name):
    """``scripts/<name>.py`` as a module, its ``honor_platform_env`` call
    a no-op (conftest has set the CPU platform already)."""
    from custom_op_benchmark_tpu.utils import platform

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "honor_platform_env", lambda: None)
        spec = importlib.util.spec_from_file_location(
            f"jax_scripts_{name}", SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def test_bwd_passes_match_the_jax_script():
    ref = jax_script("exp_bwd_accounting")
    n, e, d = 300, 3000, 16
    rng = np.random.default_rng(3)
    q, k, v, dy = (rng.standard_normal((n, d), dtype=np.float32)
                   for _ in range(4))
    sc = 1.0 / np.sqrt(d)

    jse, jde = jax_ell_dual(jax_random_graph(n, e, seed=5, power_law=True))
    jq, jk, jv, jdy = map(jnp.asarray, (q, k, v, dy))
    alphas = jax_attn_fwd_impl(jde, jq, jk, jv, sc, True)[1]
    jdq, both = ref.pass1(jde, jk, jv, jdy, alphas, sc)
    jdk, jdv = ref.pass2(jde, jse, jq, jdy,
                         jax_ell_cross_packed(jde, jse, both))

    se, de = ell_dual(random_graph(n, e, seed=5, power_law=True))
    q3, k3, v3, dy3 = (torch.from_numpy(t)[:, None] for t in (q, k, v, dy))
    talphas = _attn_fwd(de, q3, k3, v3, sc)[1]
    got = exp_bwd_accounting.passes(de, se, q3, k3, v3, dy3, talphas, sc)
    for g, want in zip(got, (jdq, jdk, jdv)):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(want), **TOL)
    both_t = exp_bwd_accounting.pass1(de, k3, v3, dy3, talphas, sc)[1]
    for a, b in zip(both_t, both, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    want = _attn_bwd(de, se, q3, k3, v3, sc, talphas, dy3)[:3]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_exp_balance_matches_the_jax_script():
    ref = jax_script("exp_balance")
    n, e = PLAN_GRAPH
    parts = max(DEVICES)
    got = exp_balance.analyze(random_graph(n, e, seed=0, power_law=True),
                              DEVICES, parts)
    g0 = jax_random_graph(n, e, seed=0, power_law=True)
    for label, order_fn in (("cluster", jax_cluster_order),
                            ("balanced", jax_degree_balanced_order)):
        g, _ = jax_reorder_graph(g0, order_fn(g0, parts))
        base = ref.stats_for(g, 1).pack_slots
        assert got[label]["pack_slots_p1"] == base, label
        for p in DEVICES:
            st = ref.stats_for(g, p)
            mine = got[label]["per_p"][p]
            assert (mine["pack_slots"], mine["halo"], mine["n_hub"]) == (
                st.pack_slots, st.halo, st.n_hub), (label, p)
            assert mine["halo_fraction"] == pytest.approx(st.halo_fraction)
            assert round(mine["waste"], 3) == round(
                st.pack_slots * p / base, 3)


def test_exp_pack_private_matches_the_jax_script():
    ref = jax_script("exp_pack_private")
    n, e = PLAN_GRAPH
    want = ref.analyze("small", n, e, DEVICES)
    g = random_graph(n, e, seed=0, power_law=True)
    g, _ = reorder_graph(g, degree_balanced_order(g, max(DEVICES)))
    got = exp_pack_private.analyze(g, DEVICES)
    assert (got["n"], got["e"]) == (want["n"], want["e"])
    assert got["p1_slots"] == want["p1_slots"]
    for mine, theirs in zip(got["per_p"], want["per_p"], strict=True):
        for key, val in theirs.items():
            if key.startswith("waste"):
                assert round(mine[key], 3) == val, key
            else:
                assert mine[key] == val, key
