"""Checkpoint round trip (tests/test_checkpoint.py) on the port, where a
checkpoint is ``torch.save`` of the step and the model's and optimizer's
state dicts: a restored state equals the saved one, and training resumed
from it continues exactly as the uninterrupted run (``torch.equal`` on
every parameter)."""

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.data import planted_partition
from custom_op_benchmark_tpu_torch.models import GCN
from custom_op_benchmark_tpu_torch.train import (
    create_train_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)


def _task():
    ds = planted_partition(num_classes=3, nodes_per_class=20, feat_dim=8,
                           seed=0)
    t = torch.from_numpy
    return ds.graph, t(ds.features), t(ds.labels), t(ds.train_mask)


def _state(seed):
    model = GCN(hidden_dim=8, out_dim=3, in_dim=8,
                generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, learning_rate=1e-2)


def test_checkpoint_roundtrip(tmp_path):
    g, x, labels, mask = _task()
    state = _state(0)
    step = make_train_step()
    for _ in range(3):
        step(state, g, x, labels, mask)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)

    restored = restore_checkpoint(path, _state(1))
    assert restored.step == state.step == 3
    for a, b in zip(restored.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    step(restored, g, x, labels, mask)
    assert restored.step == state.step + 1


def test_save_restore_continues_bit_for_bit(tmp_path):
    """N steps equal k steps, a save, a restore into a fresh state and
    N - k steps."""
    g, x, labels, mask = _task()
    step = make_train_step()
    n, k = 8, 3
    straight = _state(0)
    losses = [step(straight, g, x, labels, mask)[0].item() for _ in range(n)]

    first = _state(0)
    for _ in range(k):
        step(first, g, x, labels, mask)
    save_checkpoint(str(tmp_path / "k"), first)
    resumed = restore_checkpoint(str(tmp_path / "k"), _state(5))
    rest = [step(resumed, g, x, labels, mask)[0].item()
            for _ in range(n - k)]
    assert rest == losses[k:]
    assert resumed.step == straight.step == n
    for a, b in zip(resumed.model.parameters(), straight.model.parameters()):
        assert torch.equal(a, b)
    assert np.isfinite(losses).all()
