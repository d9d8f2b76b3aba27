"""The port's grid suite (utils/bench_suite.py) against the JAX package's.

The port's grid case is held to the inputs ``run_grid_suite`` makes (the
tile-aligned grid, seed-0 features and edge values) bit for bit, and its
gated results — tiled SpMM, tiled dst attention, the composed segment
attention and the attention's q-gradient — to the JAX package's on the
same inputs at the suite's own gate, rtol/atol 2e-3, on a 48×48 grid at
d = 32 (the suite's ``--small``). JAX's tiled ops run their Pallas kernels
in interpret mode; the port's wrappers run their plain versions. On the
CPU the suite's timed rows are recorded as not measured.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu.graph import grid_graph as jax_grid_graph
from custom_op_benchmark_tpu.graph.reorder import (
    reorder_graph as jax_reorder_graph,
    tile_aligned_order as jax_tile_aligned_order,
)
from custom_op_benchmark_tpu.graph.tiled import tile_graph as jax_tile_graph
from custom_op_benchmark_tpu.ops import (
    edge_softmax as jax_edge_softmax,
    sddmm as jax_sddmm,
    vector_spmm as jax_vector_spmm,
)
from custom_op_benchmark_tpu.ops.tiled import (
    tiled_attention as jax_tiled_attention,
    tiled_spmm as jax_tiled_spmm,
)
from custom_op_benchmark_tpu_torch.utils import bench_suite, benchlib

SIDE, D = 48, 32
GATE = dict(rtol=bench_suite.RTOL, atol=bench_suite.ATOL)


@pytest.fixture(scope="module")
def cases():
    """(JAX's grid-suite objects, the port's GridCase) on the same grid."""
    g = jax_grid_graph(SIDE, SIDE)
    ro = jax_tile_aligned_order(g, block=128)
    g_al, eperm = jax_reorder_graph(g, ro)
    tg = jax_tile_graph(g_al, 128, 128)
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(g.n_nodes, D)).astype(np.float32))
    ed = jnp.asarray(rng.uniform(size=g.num_edges_padded).astype(np.float32))
    vals = tg.scatter_edges(ed[jnp.asarray(eperm)])[: tg.num_tiles]
    jax_case = dict(g=g, ro=ro, tg=tg, q=q, ed=ed, vals=vals,
                    q_al=ro.scatter_nodes(q))
    return jax_case, bench_suite.grid_case(SIDE, SIDE, D, device="cpu")


def test_grid_case_matches_the_reference_inputs(cases):
    j, case = cases
    np.testing.assert_array_equal(case.ro.perm, j["ro"].perm)
    np.testing.assert_array_equal(case.tg.tile_ptr.numpy(),
                                  np.asarray(j["tg"].tile_ptr))
    np.testing.assert_array_equal(case.tg.mask.numpy(),
                                  np.asarray(j["tg"].mask))
    np.testing.assert_array_equal(case.q.numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(case.ed.numpy(), np.asarray(j["ed"]))
    np.testing.assert_array_equal(case.vals.numpy(), np.asarray(j["vals"]))
    np.testing.assert_array_equal(case.q_al.numpy(), np.asarray(j["q_al"]))


def test_grid_spmm_matches_jax(cases):
    j, case = cases
    want = jax_tiled_spmm(j["tg"], j["vals"], j["q_al"])
    got = bench_suite.tiled_spmm(case.tg, case.vals, case.q_al)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATE)
    seg = jax_vector_spmm(j["g"], j["ed"], j["q"], impl="xla")
    got = bench_suite.vector_spmm(case.g, case.ed, case.q, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(seg), **GATE)


def test_grid_attention_and_grad_match_jax(cases):
    j, case = cases
    g = j["g"]

    def jax_seg(q):
        s = jax_sddmm(g, q, q, impl="xla") / jnp.sqrt(float(D))
        a = jax_edge_softmax(g, s, by="dst", impl="xla")
        return jax_vector_spmm(g.reverse(), a[g.csc_perm], q, impl="xla")

    def jax_til(q):
        return jax_tiled_attention(j["tg"], q, q, q, normalize="dst")

    np.testing.assert_allclose(
        bench_suite.segment_attention(case, case.q).numpy(),
        np.asarray(jax_seg(j["q"])), **GATE)
    want = jax_til(j["q_al"])
    q_al = case.q_al.clone().requires_grad_()
    got = bench_suite.tiled_grid_attention(case, q_al)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **GATE)
    (got ** 2).sum().backward()
    want_grad = jax.grad(lambda q: (jax_til(q) ** 2).sum())(j["q_al"])
    np.testing.assert_allclose(q_al.grad.numpy(), np.asarray(want_grad),
                               **GATE)


def test_run_grid_suite_small_on_the_cpu(cases):
    _, case = cases
    records, ok = bench_suite.run_grid_suite(SIDE, SIDE, D, device="cpu",
                                             case=case)
    assert ok
    checks = [r for r in records if "check" in r]
    assert [r["check"] for r in checks] == [
        "grid spmm tiled vs segment", "grid attention tiled vs composed",
        "grid attention grad tiled vs composed"]
    assert all(r["ok"] and r["max_diff"] < 2e-3 for r in checks)
    benches = [r for r in records if "bench" in r]
    assert len(benches) == 5 and all(r["time_s"] is None for r in benches)


def test_byte_models_are_the_reference_formulas(cases):
    _, case = cases
    n, e, d = case.n, case.e, case.d
    m = bench_suite.byte_models(case)
    assert m["spmm"]["refetch"] == (e * d + n * d + e) * 4.0
    assert m["attn_bwd"]["unique"] == 8 * n * d * 4.0
    assert math.isclose(m["attn"]["refetch"], (2 * e * d + 2 * n * d) * 4.0)


def test_main_small_prints_suite_ok():
    proc = subprocess.run(
        [sys.executable, "-m", "custom_op_benchmark_tpu_torch.utils.bench_suite",
         "--grid", "--small", "--device", "cpu"], capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"suite_ok": true' in proc.stdout.splitlines()[-1]


@pytest.mark.parametrize("suite", ["--grid", "--powerlaw"])
def test_main_needs_a_cuda_device_unless_asked_for_the_cpu(suite, capsys):
    """With no card the suites stop, naming the missing device, instead of
    carrying on on the CPU; only ``--device cpu`` runs them there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the suite would run")
    assert bench_suite.main([suite, "--small"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err


@pytest.mark.parametrize("suite", ["--grid", "--powerlaw"])
def test_main_runs_only_the_small_suites_on_the_cpu(suite, capsys):
    assert bench_suite.main([suite, "--device", "cpu"]) == 1
    assert "CUDA device only" in capsys.readouterr().err


@pytest.mark.parametrize("fn", ["run_grid_suite", "run_powerlaw_suite",
                                "grid_case", "powerlaw_case"])
def test_suites_take_the_cuda_device_by_default(fn):
    """Given no device (and no case), the runners and case builders ask
    ``cuda_device()`` for the card, which raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the suite would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(bench_suite, fn)(48, 48, 32)


def test_timing_needs_a_cuda_device():
    """A CPU run gives no device time: the bench library refuses it."""
    with pytest.raises(RuntimeError, match="CUDA"):
        benchlib.bench_fn(lambda x: x + 1, (torch.zeros(4),))
    with pytest.raises(ValueError):
        benchlib.bench_fn(lambda: None, ())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing refuses here")
    with pytest.raises(RuntimeError, match="CUDA"):
        benchlib.hbm_bandwidth_bytes()


@pytest.mark.parametrize("module", ["exp_grid_dma", "exp_grid_bisect"])
def test_experiments_need_a_cuda_device(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the experiment would run")
    import importlib

    mod = importlib.import_module(
        f"custom_op_benchmark_tpu_torch.experiments.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


@pytest.mark.parametrize("module, rows", [
    ("exp_grid_dma", {"spmm_shipped", "spmm_dma_f32", "spmm_dma_v2",
                      "spmm_dma_bf16", "spmm_dma_v2_bf16"}),
    ("exp_grid_bisect", {"spmm_f32", "spmm_dotonly_f32", "spmm_bf16",
                         "attn_fwd_f32", "attn_fwd_noexp", "attn_fwd_nomask",
                         "attn_fwd_bf16", "attn_bwd_f32"})])
def test_experiment_rows_run_their_calls(module, rows, monkeypatch):
    """Each experiment's rows, f32 and bf16, on a small grid on the CPU
    (plain versions; bench_fn replaced by one call, since a CPU run has no
    device time): every row's call runs and a bf16 row returns bf16."""
    import importlib

    mod = importlib.import_module(
        f"custom_op_benchmark_tpu_torch.experiments.{module}")
    dtypes = {}

    def one_call(fn, args, *, name, **kw):
        y = fn(*args)
        dtypes[name] = (y[0] if isinstance(y, tuple) else y).dtype
        return benchlib.BenchRecord(name=name, time_s=0.001, times=[0.001],
                                    edges=kw.get("edges"))

    monkeypatch.setattr(benchlib, "bench_fn", one_call)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    out = mod.run(bench_suite.grid_case(32, 32, 16, device="cpu"))
    assert rows <= set(out)
    assert all(dtypes[r] == (torch.bfloat16 if r.endswith("bf16")
                             else torch.float32) for r in rows)
    assert out.get("allclose", True) and out.get("allclose_v2", True)


def test_bench_ms_stores_ms_and_roofline_fractions(monkeypatch, capsys):
    """The one row helper of the suite and the experiments: the median ms
    goes into the caller's dict and each byte model's fraction of the peak
    into the record (bench_fn replaced, as a CPU run has no device time)."""
    seen = {}

    def fake_bench_fn(fn, args, *, name, **kw):
        seen.update(kw, args=args)
        return benchlib.BenchRecord(name=name, time_s=0.002, times=[0.002],
                                    edges=kw.get("edges"))

    monkeypatch.setattr(benchlib, "bench_fn", fake_bench_fn)
    out = {}
    rec = benchlib.bench_ms(out, "row", None, 1, 2, edges=4000,
                            bytes_models={"unique": 1e6, "refetch": 4e6},
                            peak=1e9, warmup=1, iters=3, repeats=3)
    assert out == {"row": 2.0}
    assert seen == dict(edges=4000, warmup=1, iters=3, repeats=3,
                        args=(1, 2))
    assert rec.extra == {"roofline_frac_unique": 0.5,
                         "roofline_frac_refetch": 2.0}
    line = capsys.readouterr().out
    assert "2.000 ms" in line and "2.0 Medges/s" in line
    assert "roofline 0.5000/2.0000 (unique/refetch)" in line


def test_bench_record_accounting():
    rec = benchlib.BenchRecord(name="x", time_s=0.5, times=[0.5],
                               bytes_moved=1e9, edges=100)
    assert rec.edges_per_s == 200
    assert rec.achieved_bw == 2e9
    assert rec.roofline_fraction(4e9) == 0.5
