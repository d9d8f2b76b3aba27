"""Failure detection and resume (tests/test_resilient.py) on the port:
rolling checkpoints and resume, restores on divergence and the error after
``max_restores``, falling losses under the driver, and a resumed run equal
to the uninterrupted one (``torch.equal`` on every parameter)."""

import math

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu_torch.data.synthetic import planted_partition
from custom_op_benchmark_tpu_torch.models import GCN
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from custom_op_benchmark_tpu_torch.train.resilient import (
    CheckpointManager,
    DivergenceError,
    resilient_steps,
)


@pytest.fixture(scope="module")
def task():
    ds = planted_partition(num_classes=3, nodes_per_class=40, feat_dim=8,
                           avg_degree=5, seed=0)
    t = torch.from_numpy
    g, x, y, mask = ds.graph, t(ds.features), t(ds.labels), t(ds.train_mask)
    train_step = make_train_step()

    def new_state():
        model = GCN(hidden_dim=16, out_dim=3, num_layers=2, in_dim=8,
                    generator=torch.Generator().manual_seed(0))
        return create_train_state(model, learning_rate=1e-2)

    def step(state, _i):
        loss, _ = train_step(state, g, x, y, mask)
        return state, loss

    return new_state, step


def test_checkpoint_every_and_resume(task, tmp_path):
    new_state, step = task
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    events = []
    state1, _ = resilient_steps(step, new_state(), 10, manager=mgr,
                                checkpoint_every=4,
                                on_event=lambda k, s: events.append((k, s)))
    assert mgr.latest_step == 9
    assert ("checkpoint", 3) in events and ("checkpoint", 9) in events
    assert len(mgr._steps()) <= 2

    # A fresh run over the same directory resumes after the last
    # checkpointed step and runs only the remainder.
    events2 = []
    state2, losses2 = resilient_steps(
        step, new_state(), 14, manager=mgr, checkpoint_every=100,
        on_event=lambda k, s: events2.append((k, s)))
    assert ("resume", 9) in events2
    assert len(losses2) == 4
    assert state2.step == state1.step + 4


def test_divergence_restores_then_raises(task, tmp_path):
    new_state, step = task
    mgr = CheckpointManager(str(tmp_path / "ckpt2"), keep=2)

    def bad_step(state, i):
        state, loss = step(state, i)
        return state, (torch.tensor(float("nan")) if i >= 5 else loss)

    events = []
    with pytest.raises(DivergenceError):
        resilient_steps(bad_step, new_state(), 10, manager=mgr,
                        checkpoint_every=2, max_restores=2,
                        on_event=lambda k, s: events.append((k, s)))
    assert sum(1 for k, _ in events if k == "restore") == 2


def test_losses_decrease_under_resilient_driver(task):
    new_state, step = task
    _, losses = resilient_steps(step, new_state(), 30)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_resumed_run_equals_the_uninterrupted_one(task, tmp_path):
    """N steps straight equal k steps with a checkpoint, then a fresh state
    resumed from it for the rest; a divergence without a checkpoint
    restores the state the run started from, so the replay is exact too."""
    new_state, step = task
    n, k = 9, 4
    straight, losses = resilient_steps(step, new_state(), n)

    mgr = CheckpointManager(str(tmp_path / "resume"), keep=1)
    resilient_steps(step, new_state(), k, manager=mgr)
    assert mgr.latest_step == k - 1
    other = new_state()
    with torch.no_grad():
        for p in other.model.parameters():
            p.add_(1.0)                  # the restore must overwrite it
    resumed, rest = resilient_steps(step, other, n, manager=mgr)
    assert rest == losses[k:]
    for a, b in zip(resumed.model.parameters(), straight.model.parameters()):
        assert torch.equal(a, b)

    failed = {"once": True}

    def flaky(state, i):
        state, loss = step(state, i)
        if i == 6 and failed.pop("once", False):
            return state, torch.tensor(math.inf)
        return state, loss

    replayed, again = resilient_steps(flaky, new_state(), n)
    assert again == losses
    for a, b in zip(replayed.model.parameters(),
                    straight.model.parameters()):
        assert torch.equal(a, b)
