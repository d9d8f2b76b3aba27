"""Full-graph training for node classification.

Counterpart of the JAX package's ``create_train_state``,
``masked_cross_entropy``, ``make_train_step``, ``make_eval_step`` and
``fit_full_graph`` (custom_op_benchmark_tpu/train/loop.py). PyTorch runs
eagerly and updates the parameters in place, so the state is the model and
its optimizer, and a step returns ``(loss, acc)``.
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
    """Mean negative log-likelihood over the nodes where ``mask`` is set,
    in the logits' dtype: the models return f32 logits also under a bf16
    compute ``dtype``, so the loss and the accuracy are f32, as in the
    reference."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def make_train_step(dropout: bool = False,
                    apply_kwargs: Optional[dict] = None):
    """A full-graph train step. ``apply_kwargs`` forwards execution-strategy
    views to the model as keyword arguments (``{"tiled": tile_graph(g)}``).

    ``dropout=False`` (the reference's default) runs the forward pass with
    the model in eval mode, so its dropout layers are off and a GAT with
    ``dropout_rate > 0`` stays on its fused ELL or dense-block path;
    ``dropout=True`` runs it in train mode.
    """
    views = dict(apply_kwargs or {})

    def train_step(state: TrainState, g, x, labels, mask):
        state.model.train(dropout)
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(g, x, **views)
        loss = masked_cross_entropy(logits, labels, mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc = _accuracy(logits, labels, mask)
        return loss.detach(), acc

    return train_step


def _accuracy(logits, labels, mask):
    m = mask.to(logits.dtype)
    hit = (logits.argmax(-1) == labels).to(logits.dtype)
    return (hit * m).sum() / m.sum().clamp(min=1.0)


def make_eval_step(apply_kwargs: Optional[dict] = None):
    """An evaluation step: the model in eval mode, no gradients; returns
    ``(loss, acc)`` over the nodes where ``mask`` is set."""
    views = dict(apply_kwargs or {})

    @torch.no_grad()
    def eval_step(state: TrainState, g, x, labels, mask):
        state.model.eval()
        logits = state.model(g, x, **views)
        return (masked_cross_entropy(logits, labels, mask),
                _accuracy(logits, labels, mask))

    return eval_step


def fit_full_graph(model: nn.Module, dataset, *, epochs: int = 100,
                   learning_rate: float = 1e-2, weight_decay: float = 5e-4,
                   seed: int = 0, log_every: int = 0,
                   target_val_acc: Optional[float] = None,
                   strategy: Optional[str] = None, device=None):
    """Train on the whole graph each epoch (the Cora/ogbn-arxiv configs).

    ``strategy``: None (segment ops), ``"ell"`` (the degree-bucketed fused
    path, with the training ladder ``ell_dual(g, profile="train")``),
    ``"block"`` (the component-batched dense layout, for graphs whose
    components fit a block) or ``"auto"`` (``utils.summary.describe``
    picks block or ELL, as in the reference); the view is built once and
    passed to every call of the model.

    Training runs on ``device``: the CUDA device unless the caller names
    another (the CPU tests pass ``device="cpu"``); with no card and no
    device it raises. The model moves there. The parameters are drawn
    afresh from ``seed`` (``model.reset_parameters``, on the host), as the
    reference initialises them from its PRNG key. Returns ``(state,
    metrics)`` with the final ``val_loss`` and ``val_acc`` and, every
    ``log_every`` epochs, a history entry.
    """
    if strategy not in (None, "ell", "block", "auto"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if device is None:
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    g = dataset.graph.to(device)
    apply_kwargs = {}
    if strategy == "auto":
        from custom_op_benchmark_tpu_torch.utils.summary import describe

        rec = describe(g).recommended
        strategy = "block" if rec == "dense_block" else "ell"
    if strategy == "ell":
        from custom_op_benchmark_tpu_torch.ops.ell import ell_dual

        apply_kwargs["ell"] = ell_dual(g, profile="train")
    elif strategy == "block":
        from custom_op_benchmark_tpu_torch.graph.blockdiag import block_graph

        bg = block_graph(g)
        if bg is None:
            raise ValueError("graph has components too large for "
                             "strategy='block'")
        apply_kwargs["block"] = bg

    def t(a):
        return torch.from_numpy(a).to(device)

    x, labels = t(dataset.features), t(dataset.labels)
    train_mask, val_mask = t(dataset.train_mask), t(dataset.val_mask)
    if hasattr(model, "reset_parameters"):
        # Drawn on the host, so a seed gives the same weights on any device.
        model.to("cpu").reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    state = create_train_state(model, learning_rate=learning_rate,
                               weight_decay=weight_decay)
    train_step = make_train_step(apply_kwargs=apply_kwargs)
    eval_step = make_eval_step(apply_kwargs=apply_kwargs)

    history = []
    for epoch in range(epochs):
        loss, acc = train_step(state, g, x, labels, train_mask)
        if log_every and (epoch + 1) % log_every == 0:
            vl, va = eval_step(state, g, x, labels, val_mask)
            history.append(dict(epoch=epoch + 1, loss=float(loss),
                                train_acc=float(acc), val_loss=float(vl),
                                val_acc=float(va)))
            if target_val_acc is not None and float(va) >= target_val_acc:
                break
    vl, va = eval_step(state, g, x, labels, val_mask)
    return state, dict(val_loss=float(vl), val_acc=float(va),
                       history=history)
