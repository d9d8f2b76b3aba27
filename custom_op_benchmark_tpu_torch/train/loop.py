"""Full-graph training step for node classification.

Counterpart of the JAX package's ``create_train_state``,
``masked_cross_entropy`` and ``make_train_step``
(custom_op_benchmark_tpu/train/loop.py). PyTorch runs eagerly and updates
the parameters in place, so the state is the model and its optimizer, and a
step returns ``(loss, acc)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, *, learning_rate: float = 1e-2,
                       weight_decay: float = 5e-4) -> TrainState:
    """AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8):
    decoupled weight decay on every parameter, as optax applies it."""
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return TrainState(model=model, optimizer=opt)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the nodes where ``mask`` is set."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def make_train_step(apply_kwargs: Optional[dict] = None):
    """A full-graph train step. ``apply_kwargs`` forwards execution-strategy
    views to the model as keyword arguments (``{"tiled": tile_graph(g)}``).
    """
    views = dict(apply_kwargs or {})

    def train_step(state: TrainState, g, x, labels, mask):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(g, x, **views)
        loss = masked_cross_entropy(logits, labels, mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            m = mask.to(logits.dtype)
            hit = (logits.argmax(-1) == labels).to(logits.dtype)
            acc = (hit * m).sum() / m.sum().clamp(min=1.0)
        return loss.detach(), acc

    return train_step
