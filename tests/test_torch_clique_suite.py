"""The clique suite (``bench_suite.run_suite``, the default suite) on the
CPU.

Every bench row and every check of the reference's ``run_suite``
(custom_op_benchmark_tpu/utils/bench_suite.py:68-445) is here under its
name, in its order, and every check passes at the suite's gate
(``bench_suite.RTOL = ATOL = 2e-3``) at the reference's ``--small`` size and
on 30-cliques that straddle 128-row tiles. On the CPU the kernels' plain
versions stand in and no row is timed. The reference's TPU-only check of its
compiled fused-attention kernel runs on the card only (as "fused attention
kernel (compiled) vs dense").
"""

import json

import pytest
import torch

from custom_op_benchmark_tpu_torch.utils import bench_suite

BENCHES = [
    "maskedmm/dense_bmm", "maskedmm/xla_segment", "maskedmm/pallas_tiled",
    "maskedmm/dense_block",
    "maskedmm_bwd/dense_bmm", "maskedmm_bwd/xla_segment",
    "maskedmm_bwd/pallas_tiled",
    "softmax_scatter/dense_view", "softmax_scatter/xla_segment",
    "softmax_scatter/pallas_tiled", "softmax_scatter/dense_block",
    "softmax_gather/xla_segment",
    "softmax_bwd/pallas_tiled", "softmax_bwd/xla_segment",
    "spmm/dense_bmm", "spmm/xla_segment", "spmm/pallas_tiled",
    "spmm/pallas_tiled_aligned", "spmm/dense_block",
    "softmax_bwd/dense_view", "softmax_bwd/xla_segment",
    "spmm_bwd/dense_bmm", "spmm_bwd/xla_segment", "spmm_bwd/dense_block",
    "attention_fused/pallas", "attention_composed/xla",
    "node_mul_edge/xla_segment", "maskedmm_multihead/xla_segment",
    "softmax_multihead/xla_segment", "spmm_multihead/xla_segment",
    "spmm_multihead/dense_block", "attention_fused_multihead/pallas",
    "attention_multihead/dense_block", "gat_fused/dense_block",
    "gat_composed/xla",
]

CHECKS = [
    "maskedmm fwd xla vs bmm", "maskedmm fwd tiled vs bmm",
    "maskedmm fwd block vs bmm",
    "maskedmm dA xla vs bmm", "maskedmm dB xla vs bmm",
    "maskedmm dA tiled vs bmm", "maskedmm dB tiled vs bmm",
    "softmax scatter xla", "softmax scatter tiled", "softmax scatter block",
    "softmax gather xla", "softmax bwd tiled vs segment",
    "spmm fwd tiled_aligned vs bmm", "spmm fwd xla vs bmm",
    "spmm fwd tiled vs bmm", "spmm fwd block vs bmm",
    "softmax grad xla vs dense",
    "spmm dedata xla vs bmm", "spmm dx xla vs bmm",
    "spmm dedata block vs bmm", "spmm dx block vs bmm",
    "fused attention vs composed",
    "node_mul_edge fwd", "maskedmm multihead fwd", "softmax multihead",
    "spmm multihead fwd", "spmm multihead block",
    "attention multihead block vs tiled", "gat fused block vs composed",
]


@pytest.mark.parametrize("size", [bench_suite.SMALL_CLIQUES,
                                  (6, 30, 48, 2, 16)],
                         ids=["reference_small", "straddling_tiles"])
def test_run_suite_passes_every_check_under_the_reference_names(size):
    records, ok = bench_suite.run_suite(*size, device="cpu")
    checks = [r for r in records if "check" in r]
    benches = [r for r in records if "bench" in r]
    failed = [(r["check"], r["max_diff"]) for r in checks if not r["ok"]]
    assert ok and not failed, failed
    assert [r["check"] for r in checks] == CHECKS
    assert [r["bench"] for r in benches] == BENCHES
    assert all(r["time_s"] is None for r in benches)


def test_main_runs_the_clique_suite_by_default(capsys):
    assert bench_suite.main(["--small", "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last == {"suite_ok": True, "checks": len(CHECKS),
                    "benches": len(BENCHES)}


def test_main_needs_a_cuda_device_for_the_clique_suite(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the suite would run")
    assert bench_suite.main(["--small"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err


def test_main_runs_the_full_clique_suite_only_on_the_card(capsys):
    assert bench_suite.main(["--device", "cpu"]) == 1
    assert "CUDA device only" in capsys.readouterr().err


def test_main_takes_one_suite_at_a_time():
    with pytest.raises(SystemExit):
        bench_suite.main(["--powerlaw", "--grid", "--small"])
