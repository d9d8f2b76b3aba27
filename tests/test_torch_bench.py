"""The port's headline bench (``custom_op_benchmark_tpu_torch.bench``) and
``experiments/bench_models.py`` on the CPU.

``bench --device cpu`` prints one JSON line with the reference's keys
(bench.py:264-278, ``pallas_parity_ok`` renamed ``kernel_parity_ok``) and
null device numbers; ``impl="auto"`` resolves 512×30 cliques to the dense
blocks in both packages; the timed dense-block form equals the segment
SpMM (1e-5, f32 sums in another order) and moves the bytes the reference
counts; the checks raise when they fail. ``bench_models --device cpu``
runs every row's forward and train step and holds the GAT's block and ELL
outputs to its segment output at the 2e-3 gate.
"""

import json

import pytest
import torch

from custom_op_benchmark_tpu.graph import clique_batch as jax_clique_batch
from custom_op_benchmark_tpu.ops import dispatch as jax_dispatch
from custom_op_benchmark_tpu_torch import bench
from custom_op_benchmark_tpu_torch.experiments import bench_models
from custom_op_benchmark_tpu_torch.graph import clique_batch
from custom_op_benchmark_tpu_torch.ops import dispatch, vector_spmm

REFERENCE_KEYS = ["metric", "value", "unit", "vs_baseline", "edges_per_s",
                  "time_s", "impl", "auto_impl", "kernel_parity_ok",
                  "device", "peak_gb_s"]


def test_bench_on_the_cpu_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec)[: len(REFERENCE_KEYS)] == REFERENCE_KEYS
    assert rec["metric"] == "spmm_hbm_roofline_frac"
    assert rec["unit"] == "fraction_of_hbm_roofline"
    assert (rec["impl"], rec["auto_impl"], rec["device"]) == (
        "xla", "dense_block", "cpu")
    assert (rec["n"], rec["e"], rec["d"]) == (32 * 30, 32 * 900, 128)
    for key in ("value", "vs_baseline", "edges_per_s", "time_s",
                "kernel_parity_ok", "peak_gb_s"):
        assert rec[key] is None, key     # a CPU run measures no device


def test_auto_picks_the_dense_blocks_for_the_headline_cliques():
    assert dispatch.resolve(clique_batch(*bench.FULL[:2]), "auto") == \
        "dense_block"
    assert jax_dispatch.resolve(jax_clique_batch(*bench.FULL[:2]),
                                "auto") == "dense_block"


def test_dense_block_form_is_the_spmm_and_counts_its_bytes():
    g, edata, x = bench.spmm_workload(8, 30, 16, "cpu")
    bg, fn, args, nbytes = bench.dense_block_form(g, edata, x)
    vals, xb = args
    assert vals.shape == (8, 30, 30) and xb.shape == (8, 30, 16)
    assert nbytes == (2 * 8 * 30 * 16 + 8 * 30 * 30) * 4
    torch.testing.assert_close(bg.gather_nodes(fn(*args)),
                               vector_spmm(g, edata, x, impl="xla"),
                               rtol=1e-5, atol=1e-5)
    assert bench.check_auto(g, edata, x, bg.gather_nodes(fn(*args))) in (
        "xla", "dense_block")


def test_check_auto_raises_when_the_forms_disagree():
    g, edata, x = bench.spmm_workload(32, 30, 8, "cpu")
    y = vector_spmm(g, edata, x, impl="xla")
    with pytest.raises(AssertionError):
        bench.check_auto(g, edata, x, y + 0.1)


def test_kernel_parity_oracle_agrees_with_the_plain_k1():
    assert bench.kernel_parity(torch.device("cpu"))


def test_bench_needs_a_cuda_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run")
    assert bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_bench_models_runs_every_row_and_the_gate(capsys):
    assert bench_models.main(["--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])[
        "bench_models"]
    assert list(rec["rows"]) == [
        "transformer/block whole_stack=False",
        "transformer/block whole_stack=True", "transformer/tiled (K4)",
        "gat/segment", "gat/ell", "gat/block"]
    assert rec["ok"] and rec["gate"] == 2e-3
    assert rec["gat_block_vs_segment_max_err"] <= 2e-3
    assert rec["gat_ell_vs_segment_max_err"] <= 2e-3
    assert all(r == {"fwd_ms": None, "step_ms": None}
               for r in rec["rows"].values())
