"""Both cells end to end at a tiny size on the CPU against the reference;
the control and the planted faults come out not correct under the
committed limits; on a card, a short run of each cell."""

import json
import subprocess
import sys

import pytest
import torch

from custom_op_benchmark_tpu_torch.data.sampling import NeighborSampler
from custom_op_benchmark_tpu_torch.models import GAT, GraphSAGE
from custom_op_benchmark_tpu_torch.train import loop
from gnnbench import control, run, spec
from gnnbench.conftest import UNLISTED, tiny_cell

LISTED = [w["name"] for w in spec.benchmark()["workloads"]]
CELLS = LISTED + sorted(UNLISTED)
SEED = 2 ** 31 + 11


def _run(workload, seed=SEED, trace=False):
    return run.run_cell(tiny_cell(workload), seed, 0.3, trace, "cpu",
                        log=lambda line: None)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_correct_on_cpu(workload, trace):
    res = _run(workload, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    """The reference in TF32, and the reference with the half-batch fault,
    put in the program's place fail at least one committed limit on every
    seed; the program fails none."""
    cell = tiny_cell(workload)
    # The window's numbers are AdamW's guarantees, read by a run alone.
    limits = dict(numbers={k: v for k, v in cell.limits["numbers"].items()
                           if not k.startswith("window_")})
    for seed in (3, 4, 5):
        r = control.readings(cell, seed, torch.device("cpu"),
                             ("tf32", "half_batch"))
        ok, _ = run.judge_limits(r["program"], limits)
        assert ok, r["program"]
        for kind in ("tf32", "half_batch"):
            ok, _ = run.judge_limits(dict(r["program"], **r[kind]), limits)
            assert not ok, r[kind]


def _no_step(self, closure=None):
    return None


def _half_batch(logits, labels, mask):
    """The loss over the first half of the batch's labelled rows only."""
    keep = mask.clone()
    rows = torch.nonzero(keep).flatten()
    keep[rows[len(rows) // 2:]] = False
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    m = keep.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def _altered(cls):
    forward = cls.forward

    def wrapped(self, *args, **kw):
        out = forward(self, *args, **kw)
        bump = torch.zeros_like(out)
        bump[0, 0] = 0.05 * float(out.detach().abs().max())
        return out + bump

    return wrapped


def _sample_altered(self, seeds, **kw):
    """A batch whose first seed lists a node that is not its in-neighbour."""
    b = _SAMPLE(self, seeds, **kw)
    b.in_cols[0, 0] = b.in_cols.shape[0] - 1
    return b


_SAMPLE = NeighborSampler.sample
_ADAMW_STEP = torch.optim.AdamW.step


def _small_leaf_lost(self, closure=None):
    """A backward fault confined to the smallest leaves (GAT's last a_l and
    a_r, GraphSAGE's last bias): their gradient never reaches AdamW."""
    params = [p for g in self.param_groups for p in g["params"]]
    least = min(p.numel() for p in params)
    for p in params:
        if p.numel() == least and p.grad is not None:
            p.grad.zero_()
    return _ADAMW_STEP(self, closure)


def _stalls_after(first):
    """A step that returns its state unchanged once the set-up's ``first``
    steps are done, so in the window only."""
    def step(self, closure=None):
        self._calls = getattr(self, "_calls", 0) + 1
        return None if self._calls > first else _ADAMW_STEP(self, closure)
    return step


def _window_stall(mp, workload):
    mix = tiny_cell(workload).mix
    mp.setattr(torch.optim.AdamW, "step",
               _stalls_after(mix["check_steps"] + mix["warmup_steps"]))

FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(torch.optim.AdamW, "step",
                                             _no_step),
    "half_batch": lambda mp: mp.setattr(loop, "masked_cross_entropy",
                                        _half_batch),
    "answer_altered": lambda mp: (mp.setattr(GAT, "forward", _altered(GAT)),
                                  mp.setattr(GraphSAGE, "forward",
                                             _altered(GraphSAGE))),
    "sample_altered": lambda mp: mp.setattr(NeighborSampler, "sample",
                                            _sample_altered),
    "small_leaf_grad_lost": lambda mp: mp.setattr(torch.optim.AdamW, "step",
                                                  _small_leaf_lost),
}


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in CELLS for f in FAULTS
    if f != "sample_altered" or tiny_cell(w).mix["path"] == "sampled"])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_small_leaf_fault_fails_the_worst_leaf(workload, monkeypatch):
    """A lost gradient on the smallest leaves fails the worst leaf's
    limit, whatever the whole gradient's norm reads."""
    FAULTS["small_leaf_grad_lost"](monkeypatch)
    res = _run(workload)
    c = res["checks"]["grad_gap_leaf"]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_stall_in_the_window_is_not_correct(workload, monkeypatch):
    """A step that leaves the state unchanged in the window alone: the
    checked steps are sound, the window's parameters have not moved."""
    _window_stall(monkeypatch, workload)
    res = _run(workload)
    checks = res["checks"]
    assert checks["window_unmoved"]["value"] > 0, checks
    assert not res["correct"]
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if not k.startswith("window_")), checks


@pytest.mark.chip
@pytest.mark.parametrize("workload", LISTED)
def test_cell_on_the_card(workload, cuda):
    """One short run of the committed cell through the command line."""
    out = subprocess.run(
        [sys.executable, "-m", "gnnbench.run", "--workload", workload,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
