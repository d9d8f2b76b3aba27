"""Precision, loss, AdamW and the comparison of leaves, in plain PyTorch.

The reference runs in float64. Its control runs it in float32 with every
dense product's operands rounded to TF32 (10 bits of mantissa, to nearest,
ties to even) before an f32 product: the precision one step below the
configuration's float32, done by hand so that it reads the same on any
device.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class Prec:
    """How the reference runs: its dtype, TF32 rounding of the dense
    products' operands, and (a planted fault) the loss taken over the
    first half of each batch's labelled rows only."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False
    half_batch: bool = False


EXACT = Prec()
CONTROL = Prec(torch.float32, tf32=True)
# What the control driver can put in the program's place besides CONTROL:
# plain float32 (a witness of f32's own round-off) and the half-batch
# fault.
KINDS = {"tf32": CONTROL, "f32": Prec(torch.float32),
         "half_batch": Prec(half_batch=True)}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest, ties
    to even; the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    rounded = ((bits + bias) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, prec: Prec) -> torch.Tensor:
    if prec.tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def linear(x, weight, bias, prec: Prec):
    y = mm(x, weight.t(), prec)
    return y if bias is None else y + bias


def masked_ce(logits, labels, mask):
    """Mean negative log-likelihood over the rows where ``mask`` is set."""
    nll = -F.log_softmax(logits, -1).gather(-1, labels.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


@torch.no_grad()
def adamw_(params: dict, grads: dict, state: dict, t: int, *, lr: float,
           weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
    """One AdamW step in place (decoupled decay, bias-corrected moments),
    as ``torch.optim.AdamW`` takes it."""
    b1, b2 = betas
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        p.mul_(1 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def train_steps(forward, params0: dict, batches, *, lr: float,
                weight_decay: float, prec: Prec) -> dict:
    """Follow the program through its first steps: for each batch
    ``(inputs, labels, mask)`` the loss of ``forward(params, inputs)`` over
    the masked rows, its gradient and one AdamW step. Returns the losses,
    the logits, the first step's gradients and the parameters after the
    last step, all in float64."""
    params = {k: v.detach().to(prec.dtype).clone().requires_grad_()
              for k, v in params0.items()}
    state, losses, logits, grad1 = {}, [], [], None
    for t, (inputs, labels, mask) in enumerate(batches, 1):
        if prec.half_batch:
            mask = mask.clone()
            rows = torch.nonzero(mask).flatten()
            mask[rows[len(rows) // 2:]] = False
        out = forward(params, inputs, prec)
        loss = masked_ce(out[: mask.shape[0]], labels, mask)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        losses.append(float(loss.detach()))
        logits.append(out.detach().double())
        if grad1 is None:
            grad1 = {k: g.double() for k, g in grads.items()}
        adamw_({k: p.data for k, p in params.items()}, grads, state, t,
               lr=lr, weight_decay=weight_decay)
        del out, loss, grads
    return dict(losses=losses, logits=logits, grad1=grad1,
                params={k: p.detach().double() for k, p in params.items()})


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap as a share of the reference's largest magnitude."""
    prog, ref = prog.double(), ref.double()
    if prog.shape != ref.shape:
        return float("inf")
    return float((prog - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def loss_gap(prog: list, ref: list) -> float:
    if len(prog) != len(ref):
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-300) for p, r in zip(prog, ref))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (inf where the program lacks the leaf). ``keep``
    limits the leaves compared."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return {}
    norms = {k: float(ref[k].double().norm()) for k in names}
    median = statistics.median(norms.values())
    out = {}
    for k in names:
        p = prog.get(k)
        out[k] = (float("inf") if p is None or p.shape != ref[k].shape
                  else abs(float(p.double().norm()) - norms[k])
                  / max(norms[k], median, 1e-300))
    return out


def whole_gap(prog: dict, ref: dict, keep=None) -> float:
    """The gap between the program's norm of all the leaves together and
    the reference's, against the reference's (inf where the program lacks
    a leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    if any(prog.get(k) is None or prog[k].shape != ref[k].shape
           for k in names):
        return float("inf")
    p = sum(float(prog[k].double().norm()) ** 2 for k in names) ** 0.5
    r = sum(float(ref[k].double().norm()) ** 2 for k in names) ** 0.5
    return abs(p - r) / max(r, 1e-300)


def moving_leaves(grad1: dict, share: float = 1e-3) -> set:
    """The leaves whose first gradient in the reference is at least
    ``share`` of the median leaf's; the others move under AdamW by
    round-off alone."""
    norms = {k: float(g.norm()) for k, g in grad1.items()}
    median = statistics.median(norms.values())
    return {k for k, v in norms.items() if v >= share * median}


def _deltas(prog: dict, ref: dict, params0: dict) -> tuple:
    d_prog = {k: prog["params"][k].double() - params0[k].double()
              for k in params0 if k in prog["params"]}
    d_ref = {k: ref["params"][k] - params0[k].double() for k in params0}
    return d_prog, d_ref


def training_readings(prog: dict, ref: dict, params0: dict) -> dict:
    """The compared numbers of a training check: the first step's loss and
    logits (before any AdamW step), steady from seed to seed; the worst
    leaf's gap in the first gradient, so that a fault confined to a small
    leaf shows; and the gap in the norm of the whole first gradient and of
    the whole change after the last step (the leaves that move, together),
    where each leaf weighs by its size. Gradients swing with f32 round-off
    where a pre-activation lies within it of a LeakyReLU or ReLU kink, and
    AdamW's normalised step turns an element whose gradient rounds across
    zero into an lr-sized move the other way, so the later steps' losses
    and logits and single leaves' changes are not compared;
    ``training_details`` gives them."""
    if not (prog["losses"] and prog["logits"]) or len(
            prog["losses"]) != len(ref["losses"]):
        return {k: float("inf") for k in (
            "loss1_gap", "logits1_gap", "grad_gap_leaf", "grad_gap_all",
            "delta_gap_all")}
    d_prog, d_ref = _deltas(prog, ref, params0)
    return dict(
        loss1_gap=loss_gap(prog["losses"][:1], ref["losses"][:1]),
        logits1_gap=rel_gap(prog["logits"][0], ref["logits"][0]),
        grad_gap_leaf=max(leaf_gaps(prog["grad1"], ref["grad1"]).values(),
                          default=float("inf")),
        grad_gap_all=whole_gap(prog["grad1"], ref["grad1"]),
        delta_gap_all=whole_gap(d_prog, d_ref,
                                moving_leaves(ref["grad1"])))


def adamw_step_bound(betas, steps: int = 100_000) -> float:
    """The most that one AdamW step can move an element, in units of lr,
    before the decay: the bias-corrected |m̂| / √v̂ over any gradients, by
    Cauchy–Schwarz on the moments' sums, the largest over the first
    ``steps`` steps (it rises towards its limit)."""
    b1, b2 = betas
    r = b1 * b1 / b2
    t = torch.arange(1, steps + 1, dtype=torch.float64)
    k = ((1 - b1) / (1 - b1 ** t) * ((1 - b2 ** t) / (1 - b2)).sqrt()
         * ((1 - r ** t) / (1 - r)).sqrt())
    return float(k.max())


@torch.no_grad()
def window_readings(before: dict, after: dict, steps: int,
                    opt: dict) -> dict:
    """What the window's AdamW steps guarantee, read from the parameters
    before and after it: every element finite, every leaf moved (the decay
    alone moves every element that is not 0), and no element moved further
    than AdamW can in ``steps`` steps: the widest |after − before·(1 −
    lr·wd)^steps| over lr · steps · ``adamw_step_bound``, at most 1."""
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    scale = lr * max(steps, 1) * adamw_step_bound(opt["betas"])
    nonfinite = unmoved = 0
    ratio = 0.0
    for k, b in before.items():
        a = after.get(k)
        if a is None or a.shape != b.shape:
            unmoved += 1
            continue
        nonfinite += int((~torch.isfinite(a)).sum())
        unmoved += int(steps > 0 and bool(torch.equal(a, b)))
        move = a.double() - b.double() * (1 - lr * wd) ** steps
        ratio = max(ratio, float(move.abs().max()) / scale)
    return dict(window_nonfinite=nonfinite, window_unmoved=unmoved,
                window_move_ratio=ratio)


def training_details(prog: dict, ref: dict, params0: dict) -> dict:
    """Where the training numbers come from: the worst over the steps, the
    worst and the median leaf, each step's loss and logits gap, and each
    leaf's gradient and change gap."""
    d_prog, d_ref = _deltas(prog, ref, params0)
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    delta = leaf_gaps(d_prog, d_ref, moving_leaves(ref["grad1"]))
    return dict(
        loss_gap=loss_gap(prog["losses"], ref["losses"]),
        logits_gap=max((rel_gap(p, r) for p, r in zip(prog["logits"],
                                                      ref["logits"])),
                       default=float("inf")),
        grad_gap=max(grad.values(), default=0.0),
        delta_gap=max(delta.values(), default=0.0),
        grad_gap_med=statistics.median(grad.values()) if grad else 0.0,
        delta_gap_med=statistics.median(delta.values()) if delta else 0.0,
        loss_by_step=[abs(p - r) / max(abs(r), 1e-300)
                      for p, r in zip(prog["losses"], ref["losses"])],
        logits_by_step=[rel_gap(p, r) for p, r in zip(prog["logits"],
                                                      ref["logits"])],
        grad_by_leaf=grad, delta_by_leaf=delta,
        grad_norm_by_leaf={k: float(g.norm())
                           for k, g in ref["grad1"].items()})
