"""Training for node classification: full-graph and sampled minibatches.

Counterpart of the JAX package's ``create_train_state``,
``masked_cross_entropy``, ``make_train_step``, ``make_eval_step``,
``fit_full_graph`` and ``fit_sampled`` (custom_op_benchmark_tpu/train/
loop.py); ``fit_sampled_dp`` comes with the distributed plans. PyTorch runs
eagerly and updates the parameters in place, so the state is the model and
its optimizer; a full-graph step returns ``(loss, acc)``, a sampled one
its loss. Both steps run inside the span ``train.step``, their model and
loss in ``train.forward``, ``loss.backward()`` in ``train.backward`` and
AdamW's step in ``train.optimizer``; each batch's sampling in
``sampled_batches`` runs in ``data.sample`` (``utils.spans``).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from custom_op_benchmark_tpu_torch.utils.spans import span, spanned


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

    @spanned("train.step")
    def train_step(state: TrainState, g, x, labels, mask):
        state.model.train(dropout)
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            logits = state.model(g, x, **views)
            loss = masked_cross_entropy(logits, labels, mask)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
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


def make_sampled_step():
    """A sampled-minibatch train step: the model in eval mode (no dropout,
    as the reference's default), the loss over the batch's seeds (its first
    ``len(seed_mask)`` nodes), one AdamW step. Returns the loss, on the
    device."""

    @spanned("train.step")
    def sampled_step(state: TrainState, g, x, labels, seed_mask,
                     in_cols=None):
        state.model.train(False)
        state.optimizer.zero_grad(set_to_none=True)
        kw = {} if in_cols is None else {"in_cols": in_cols}
        with span("train.forward"):
            logits = state.model(g, x, **kw)
            loss = masked_cross_entropy(logits[: seed_mask.shape[0]],
                                        labels, seed_mask)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            state.optimizer.step()
        state.step += 1
        return loss.detach()

    return sampled_step


# Device-resident features and labels below this size (the reference's
# rule, custom_op_benchmark_tpu/train/loop.py:215-220).
DEVICE_FEATURES_BYTES = 8 * 1024 ** 3
# Steps of the first epoch left out of the median step time (warm-up).
WARMUP_STEPS = 5


def sampled_batches(sampler, train_ids, batch_size, feats=None, *,
                    takes_in_cols=True, timings=None):
    """The batches of one epoch as ``(graph, x_spec, seed_ids, seed_mask,
    in_cols)`` on the host: ``x_spec`` is the batch's global node ids, or
    with ``feats`` (features kept on the host) its feature rows. Each
    sample's host seconds go to ``timings`` when it is a list."""
    import time

    it = sampler.epoch(train_ids, batch_size)
    while True:
        t0 = time.perf_counter()
        with span("data.sample"):
            b = next(it, None)
        if timings is not None and b is not None:
            timings.append(time.perf_counter() - t0)
        if b is None:
            return
        ids = b.node_ids.astype(np.int64)
        yield (b.graph, ids if feats is None else feats[ids],
               b.seed_ids.astype(np.int64), b.seed_mask,
               b.in_cols if takes_in_cols else None)


def fit_sampled(model: nn.Module, dataset, *, fanouts=(25, 10),
                batch_size: int = 128, epochs: int = 1,
                learning_rate: float = 1e-3, seed: int = 0,
                prefetch_depth: int = 2, device=None):
    """Sampled-minibatch training (the Reddit GraphSAGE configuration).

    Counterpart of the reference's ``fit_sampled``. The sampler
    (``data.sampling.NeighborSampler``, seeded with ``seed``) runs on the
    host in a prefetch thread that copies each batch to the device while
    the previous steps run (``data.pipeline.prefetch``). Features and
    labels stay on the device when they take less than 8 GiB and are
    gathered there by the batch's node ids; losses stay there until the
    run ends. The parameters are drawn afresh from ``seed``. The final
    evaluation is full-graph, on the segment path. Training runs on
    ``device``: the CUDA device unless the caller names another.

    Returns ``(state, metrics)``: ``losses``, ``final_loss``, ``val_acc``,
    and ``steps``, ``sample_ms`` (median host seconds of one batch's
    sampling, in ms), ``eval_ms``, and on the card ``step_ms`` (the median
    time between the ends of consecutive steps on the device's stream,
    the first epoch's first steps left out).
    """
    import inspect
    import time

    from custom_op_benchmark_tpu_torch.data.pipeline import prefetch
    from custom_op_benchmark_tpu_torch.data.sampling import NeighborSampler

    if device is None:
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        device = cuda_device()
    device = torch.device(device)
    on_card = device.type == "cuda"
    sampler = NeighborSampler(dataset.graph, fanouts, seed=seed)
    takes_in_cols = "in_cols" in inspect.signature(
        model.forward).parameters
    feats, labels = dataset.features, dataset.labels
    device_feats = feats.nbytes < DEVICE_FEATURES_BYTES
    if device_feats:
        feats_dev = torch.from_numpy(feats).to(device)
    labels_dev = torch.from_numpy(labels.astype(np.int64)).to(device)
    train_ids = np.nonzero(dataset.train_mask)[0]

    if hasattr(model, "reset_parameters"):
        model.to("cpu").reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    state = create_train_state(model, learning_rate=learning_rate)
    step = make_sampled_step()

    losses, sample_s, ends = [], [], []
    for epoch in range(epochs):
        batches = sampled_batches(
            sampler, train_ids, batch_size,
            None if device_feats else feats, takes_in_cols=takes_in_cols,
            timings=sample_s)
        for g_b, x_b, seeds_b, mask_b, cols_b in prefetch(
                batches, prefetch_depth, device=device):
            x = feats_dev[x_b] if device_feats else x_b
            losses.append(step(state, g_b, x, labels_dev[seeds_b], mask_b,
                               cols_b))
            if on_card and (epoch > 0 or len(losses) > WARMUP_STEPS):
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
    losses = torch.stack(losses).tolist() if losses else []
    step_ms = None
    if on_card and len(ends) > 1:
        ends[-1].synchronize()
        step_ms = statistics.median(a.elapsed_time(b)
                                    for a, b in zip(ends, ends[1:]))

    # The final evaluation: full-graph inference on the segment path
    # (sampling is a training-time approximation).
    t0 = time.perf_counter()
    with torch.no_grad():
        model.eval()
        g = dataset.graph.to(device)
        x = feats_dev if device_feats else torch.from_numpy(feats).to(device)
        pred = model(g, x).argmax(-1).cpu().numpy()
    eval_ms = (time.perf_counter() - t0) * 1e3
    val = dataset.val_mask
    val_acc = (float((pred[val] == labels[val]).mean()) if val.any()
               else float("nan"))
    return state, dict(
        losses=losses, final_loss=losses[-1] if losses else float("nan"),
        val_acc=val_acc, steps=len(losses),
        sample_ms=(statistics.median(sample_s) * 1e3 if sample_s
                   else None),
        step_ms=step_ms, eval_ms=eval_ms)


def dp_step(state: TrainState, mesh, axis: str, batches, feats, labels):
    """One data-parallel sampled step: each of this process's shards
    computes its batch's loss and gradients on its own (the model in eval
    mode, no dropout), the gradients are averaged over ``mesh[axis]``,
    summed in shard order, and AdamW takes one step. ``batches``: this
    process's ``(graph, node_ids, seed_ids, seed_mask, in_cols)`` on the
    device, one a shard. Returns the mean loss over the axis."""
    from custom_op_benchmark_tpu_torch.parallel.mesh import psum

    model = state.model
    model.train(False)
    params = list(model.parameters())
    p = mesh.shape[axis]
    grads, shard_losses = [], []
    for g_b, ids, seeds, mask, cols in batches:
        kw = {} if cols is None else {"in_cols": cols}
        logits = model(g_b, feats[ids], **kw)
        loss = masked_cross_entropy(logits[: mask.shape[0]], labels[seeds],
                                    mask)
        grads.append(torch.autograd.grad(loss, params))
        shard_losses.append(loss.detach())
    for j, prm in enumerate(params):
        prm.grad = psum(mesh, axis, torch.stack([g[j] for g in grads]))[0] / p
    state.optimizer.step()
    state.step += 1
    return psum(mesh, axis, torch.stack(shard_losses))[0] / p


def fit_sampled_dp(model: nn.Module, dataset, mesh, *, fanouts=(25, 10),
                   batch_size: int = 128, epochs: int = 1,
                   learning_rate: float = 1e-3, seed: int = 0,
                   axis: str = "batch", max_steps: Optional[int] = None):
    """Data-parallel sampled-minibatch training over ``mesh[axis]``.

    Counterpart of the reference's ``fit_sampled_dp``. Each step samples
    ``P`` seed batches (P = the axis size) in the reference's order, batch
    r of a group going to shard r; each shard computes its loss and
    gradients on its own subgraph, and the gradients (and losses) are
    averaged over the axis, summed in shard order, before one AdamW step of
    the replicated parameters. On the local mesh the P shards run one after
    the other on the mesh's device; on the process mesh every rank draws
    the same groups and computes its own batch, so both meshes give the
    same bits. The forward of each batch is S3 and its backward S3's CSR
    entry (``ops/sampled.py``). ``max_steps`` stops after that many steps.

    Returns ``(state, metrics)``: ``losses``, ``val_acc`` (full-graph, on
    the segment path), ``num_devices``, and ``steps``, ``sample_ms`` (the
    median host time to sample one group) and, on the card, ``step_ms``
    (the median time between the ends of consecutive steps, after
    warm-up).
    """
    import inspect
    import time

    from custom_op_benchmark_tpu_torch.data.sampling import NeighborSampler

    p = mesh.shape[axis]
    device = mesh.device
    on_card = device.type == "cuda"
    sampler = NeighborSampler(dataset.graph, fanouts, seed=seed)
    takes_in_cols = "in_cols" in inspect.signature(
        model.forward).parameters
    feats = torch.from_numpy(dataset.features).to(device)
    labels = torch.from_numpy(dataset.labels.astype(np.int64)).to(device)
    train_ids = np.nonzero(dataset.train_mask)[0]
    # The reference draws one batch to initialise its state; drawing it
    # keeps the sampler's stream in step with the reference's.
    sampler.sample(train_ids[:batch_size])
    if hasattr(model, "reset_parameters"):
        model.to("cpu").reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    state = create_train_state(model, learning_rate=learning_rate)
    mine = range(p) if mesh.is_local else [mesh.shard_index(axis)]

    def to_dev(batch):
        g_b, ids, seeds, mask, cols = batch
        return (g_b.to(device), torch.from_numpy(ids).to(device),
                torch.from_numpy(seeds).to(device),
                torch.from_numpy(mask).to(device),
                None if cols is None else torch.from_numpy(cols).to(device))

    losses, sample_s, ends = [], [], []
    for _ in range(epochs):
        it = sampled_batches(sampler, train_ids, batch_size,
                             takes_in_cols=takes_in_cols)
        while max_steps is None or len(losses) < max_steps:
            t0 = time.perf_counter()
            group = []
            for b in it:
                group.append(b)
                if len(group) == p:
                    break
            if len(group) < p:
                break
            sample_s.append(time.perf_counter() - t0)
            losses.append(dp_step(state, mesh, axis,
                                  [to_dev(group[r]) for r in mine], feats,
                                  labels))
            if on_card and len(losses) > WARMUP_STEPS:
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
    losses = torch.stack(losses).tolist() if losses else []
    step_ms = None
    if on_card and len(ends) > 1:
        ends[-1].synchronize()
        step_ms = statistics.median(a.elapsed_time(b)
                                    for a, b in zip(ends, ends[1:]))
    with torch.no_grad():
        pred = model(dataset.graph.to(device), feats).argmax(-1).cpu().numpy()
    val = dataset.val_mask
    val_acc = (float((pred[val] == dataset.labels[val]).mean())
               if val.any() else float("nan"))
    return state, dict(
        losses=losses, val_acc=val_acc, num_devices=p, steps=len(losses),
        sample_ms=(statistics.median(sample_s) * 1e3 if sample_s
                   else None),
        step_ms=step_ms)
