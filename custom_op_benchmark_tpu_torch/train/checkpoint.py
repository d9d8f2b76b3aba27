"""Checkpoints of a train state (counterpart of custom_op_benchmark_tpu/
train/checkpoint.py, where orbax saves the pytree).

A checkpoint is a directory holding ``state.pt``: ``torch.save`` of the
step and the model's and the optimizer's ``state_dict``s. It is written to
a temporary file and renamed into place, so a save cut short never leaves
a half-written ``state.pt``. Restoring loads them into an existing
:class:`~custom_op_benchmark_tpu_torch.train.loop.TrainState` (its model
and optimizer keep their structure and device) and returns it.
"""

from __future__ import annotations

import copy
import os
from typing import Any

import torch

FILE = "state.pt"


def state_payload(state: Any, *, clone: bool = False) -> dict:
    """The step and the model's and optimizer's state; ``clone`` makes it
    an independent copy (a snapshot to restore in memory)."""
    payload = {"step": state.step, "params": state.model.state_dict(),
               "opt_state": state.optimizer.state_dict()}
    return copy.deepcopy(payload) if clone else payload


def load_payload(state: Any, payload: dict) -> Any:
    """Load a payload of :func:`state_payload` into ``state``; returns it."""
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return state


def save_checkpoint(path: str, state: Any) -> str:
    """Save ``state`` to the directory ``path``; returns its absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{FILE}.{os.getpid()}.tmp")
    torch.save(state_payload(state), tmp)
    os.replace(tmp, os.path.join(path, FILE))
    return path


def restore_checkpoint(path: str, state: Any) -> Any:
    """Restore the checkpoint at ``path`` into ``state`` and return it."""
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(os.path.abspath(path), FILE),
                         map_location=device, weights_only=True)
    return load_payload(state, payload)
