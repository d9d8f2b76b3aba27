"""Failure detection and resume (counterpart of custom_op_benchmark_tpu/
train/resilient.py).

- :class:`CheckpointManager`: rolling ``step_N`` checkpoints in one
  directory. A save is written under a temporary name and renamed, so a
  save cut short never becomes the latest; ``keep`` bounds the count.
- :func:`resilient_steps`: a step driver that resumes after the newest
  checkpoint, restores the last good one (or the state it started from)
  when the loss is not finite and raises :class:`DivergenceError` after
  ``max_restores``, reports steps slower than ``stall_timeout_s``, and
  checkpoints every ``checkpoint_every`` steps.

PyTorch updates a state in place, so the state the run started from is
kept as a copy (``state_payload(clone=True)``) for a restore without a
checkpoint.
"""

from __future__ import annotations

import copy
import math
import os
import re
import shutil
import time
from typing import Any, Callable, Optional

import torch

from custom_op_benchmark_tpu_torch.train.checkpoint import (
    FILE,
    load_payload,
    restore_checkpoint,
    save_checkpoint,
    state_payload,
)


class CheckpointManager:
    """Rolling ``step_N`` checkpoints under one directory."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.isfile(os.path.join(self.directory, name, FILE)):
                out.append(int(m.group(1)))
        return sorted(out)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, state: Any, step: int) -> str:
        path = os.path.join(self.directory, f"step_{step}")
        tmp = f"{path}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        save_checkpoint(tmp, state)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        for old in self._steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{old}"),
                          ignore_errors=True)
        return path

    def restore_latest(self, state: Any) -> tuple:
        """(state, step) from the newest checkpoint, or (state, None)."""
        step = self.latest_step
        if step is None:
            return state, None
        path = os.path.join(self.directory, f"step_{step}")
        return restore_checkpoint(path, state), step


class DivergenceError(RuntimeError):
    """The loss went non-finite more than ``max_restores`` times."""


def resilient_steps(step_fn: Callable, state: Any, num_steps: int, *,
                    manager: Optional[CheckpointManager] = None,
                    checkpoint_every: int = 50,
                    max_restores: int = 3,
                    stall_timeout_s: Optional[float] = None,
                    on_event: Optional[Callable[[str, int], None]] = None):
    """Run ``state, loss = step_fn(state, i)`` for steps ``i`` up to
    ``num_steps``, with resume from ``manager``'s newest checkpoint, a
    restore on a non-finite loss (the newest checkpoint, else the state
    the run started from; :class:`DivergenceError` after
    ``max_restores``), a ``"stall"`` event for a step slower than
    ``stall_timeout_s`` (timed after the device finishes), and a
    checkpoint every ``checkpoint_every`` steps and at the end.

    Returns ``(state, losses)``, one loss a step in step order (a restore
    rewinds them). ``on_event(kind, step)`` receives ``"restore"``,
    ``"checkpoint"``, ``"stall"`` and ``"resume"``.
    """
    notify = on_event or (lambda kind, step: None)
    start = 0
    if manager is not None:
        state, ckpt_step = manager.restore_latest(state)
        if ckpt_step is not None:
            start = ckpt_step + 1
            notify("resume", ckpt_step)
    initial = state_payload(state, clone=True)
    restores = 0
    loss_by_step = {}
    i = start
    while i < num_steps:
        t0 = time.monotonic()
        state, loss = step_fn(state, i)
        loss = float(loss.item() if isinstance(loss, torch.Tensor)
                     else loss)        # waits for the device
        if stall_timeout_s is not None and time.monotonic() - t0 > \
                stall_timeout_s:
            notify("stall", i)
        if not math.isfinite(loss):
            restores += 1
            if restores > max_restores:
                raise DivergenceError(f"non-finite loss at step {i} after "
                                      f"{max_restores} restores")
            if manager is not None and manager.latest_step is not None:
                state, ckpt_step = manager.restore_latest(state)
                i = ckpt_step + 1
            else:
                state, i = load_payload(state, copy.deepcopy(initial)), start
            loss_by_step = {s: v for s, v in loss_by_step.items() if s < i}
            notify("restore", i)
            continue
        loss_by_step[i] = loss
        if manager is not None and (i + 1) % checkpoint_every == 0:
            manager.save(state, i)
            notify("checkpoint", i)
        i += 1
    if manager is not None and num_steps > start:
        manager.save(state, num_steps - 1)
        notify("checkpoint", num_steps - 1)
    return state, [loss_by_step[s] for s in sorted(loss_by_step)]
