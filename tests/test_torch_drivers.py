"""The measurement drivers of ``custom_op_benchmark_tpu_torch.experiments``
on the CPU.

Every driver's ``main(["--device", "cpu"])`` runs all its paths and gates
at its small size, exits 0 and prints exactly one JSON line, under the
driver's name, with its timed rows "not measured" (None). ``bench_sampled``'s
presampled and pipelined runs, from two states drawn from one seed and fed
the same batches, reach the same final loss and weights bit for bit.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu_torch.data import pipeline
from custom_op_benchmark_tpu_torch.experiments import bench_sampled
from custom_op_benchmark_tpu_torch.train import run as cli
from custom_op_benchmark_tpu_torch.train.loop import make_sampled_step

DRIVERS = ("bench_sampled", "exp_bwd_accounting", "bench_attn_bwd",
           "exp_ell_ladder", "bench_epoch", "exp_halo_accounting",
           "bench_dist_transformer", "verify_story", "exp_dtype_width",
           "exp_balance", "exp_pack_private", "papers100m_budget",
           "bench_halo_builder")


# Host-clock figures, measured on the CPU too.
HOST_MS = {"host_sampling_ms", "dual_csr_ms"}


def timed_rows(rec):
    """Every value under a key ``ms`` or ending in ``_ms``, nested (host
    figures left out)."""
    if isinstance(rec, dict):
        for k, v in rec.items():
            if k in HOST_MS:
                continue
            if (k == "ms" or k.endswith("_ms")) and not isinstance(v, dict):
                yield v
            else:
                yield from timed_rows(v)
    elif isinstance(rec, list):
        for v in rec:
            yield from timed_rows(v)


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module(
        f"custom_op_benchmark_tpu_torch.experiments.{name}")
    assert mod.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    records = []
    for line in lines:
        try:
            records.append(json.loads(line))
        except ValueError:
            pass
    assert len(records) == 1 and lines[-1].startswith("{")
    (rec,) = records
    assert list(rec) == [name]
    assert all(v is None for v in timed_rows(rec[name])), rec


def test_card_drivers_refuse_a_missing_card(capsys):
    """Without ``--device cpu`` a card driver stops where there is no
    card: exit 1, no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from custom_op_benchmark_tpu_torch.experiments import exp_bwd_accounting

    assert exp_bwd_accounting.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_bench_sampled_presampled_equals_pipelined():
    dev = torch.device("cpu")
    ds = cli.reddit_dataset(bench_sampled.SCALE["cpu"])
    feats = torch.from_numpy(ds.features)
    labels = torch.from_numpy(ds.labels.astype(np.int64))
    steps = 3
    step = make_sampled_step()
    items = [pipeline.map_tensors(it, lambda t: t.to(dev))
             for it in bench_sampled.batch_source(ds, steps)]
    a = bench_sampled.fresh_state(ds, dev)
    b = bench_sampled.fresh_state(ds, dev)
    loss_a = bench_sampled.presampled_run(a, step, feats, labels, items)
    loss_b = bench_sampled.pipelined_run(
        b, step, feats, labels, bench_sampled.batch_source(ds, steps), dev)
    assert a.step == b.step == steps
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                  b.model.parameters()))
