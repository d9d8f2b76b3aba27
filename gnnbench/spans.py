"""The device's time by the port's program spans, in profiled steps.

A program span is a host event whose name starts with ``train.``,
``ell.``, ``sampled.`` or ``data.``: the ``record_function`` ranges of the
port's ``utils/spans.py``. ``self_device_s`` credits each device op of a
profile once, to the innermost program span that holds the start of the
host event that launched it; ``per_step`` profiles a cell's own steps and
divides by their number. The per-layer readers ``forward_device_ms``,
``backward_device_ms``, ``optimizer_device_ms`` and
``ell_gat_attention_step_roofline`` read ``per_step``.
"""

from __future__ import annotations

import importlib.util
from typing import Optional

import torch

PREFIXES = ("train.", "ell.", "sampled.", "data.")
NONE = "(none)"
# Steps profiled a reading, after a dropped warm-up step: the arxiv mix's
# trace_steps.
STEPS = 5
PORT_SPANS = "custom_op_benchmark_tpu_torch.utils.spans"


def _innermost(ranges: list, t: float, thread) -> Optional[str]:
    """The shortest span holding ``t``: on ``thread`` if it has one, else
    on any thread; a ``data.`` span counts on its own thread only (its
    thread launches nothing for another, where a training thread's
    backward runs on autograd's threads)."""
    best = other = None
    for s0, s1, th, name in ranges:
        if not s0 <= t <= s1:
            continue
        if th == thread:
            if best is None or s1 - s0 < best[0]:
                best = (s1 - s0, name)
        elif not name.startswith("data.") and (
                other is None or s1 - s0 < other[0]):
            other = (s1 - s0, name)
    found = best or other
    return None if found is None else found[1]


def self_device_s(prof) -> dict:
    """``{span name: seconds}`` of the device ops in ``prof`` (a
    ``torch.profiler.profile``, or anything whose ``events()`` carry
    ``name``, ``device_type``, ``time_range``, ``thread`` and ``kernels``).
    Each device op counts once: the profiler lists it, by its correlation
    id, in the ``kernels`` of the one host event that launched it, and its
    duration goes to the innermost program span, on any thread, whose host
    interval holds that event's start. An op under no program span, or
    listed under no host event, goes to ``"(none)"``. The device's
    annotation ranges are not ops, as ``timing`` leaves them out of the
    busy time."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end, e.thread, e.name)
             for e in events
             if e.device_type == cpu and e.name.startswith(PREFIXES)]
    total_us = sum(e.time_range.end - e.time_range.start for e in events
                   if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False))
    out: dict = {}
    for e in events:
        if e.device_type != cpu or not e.kernels:
            continue
        name = _innermost(spans, e.time_range.start, e.thread) or NONE
        out[name] = out.get(name, 0.0) + sum(k.duration for k in e.kernels)
    unlisted = total_us - sum(out.values())
    if unlisted > 0:
        out[NONE] = out.get(NONE, 0.0) + unlisted
    return {name: us / 1e6 for name, us in out.items()}


def path_run(ctx):
    """The cell's path object (``paths/<path>.Run``) behind ``ctx.probe``,
    or None."""
    run = getattr(ctx.probe, "__self__", None)
    return run if hasattr(run, "step") and hasattr(run, "device") else None


def per_step(ctx) -> Optional[dict]:
    """``{span name: device seconds a step}`` of the cell's own training
    steps: ``STEPS`` steps of the path profiled as the traced tail profiles
    them (``run._traced_tail``), after the window, through
    :func:`self_device_s`. Worked out once a run and kept on ``ctx``
    (``ctx.span_s``). None off the card, where the port has no spans (its
    ``utils/spans.py``), or where ``ctx`` leads to no path."""
    if getattr(ctx, "span_s", None) is not None:
        return ctx.span_s
    if not ctx.on_card or importlib.util.find_spec(PORT_SPANS) is None:
        return None
    cell_run = path_run(ctx)
    if cell_run is None:
        return None
    from gnnbench import run as harness

    _, _, prof = harness._traced_tail(cell_run,
                                      harness.Clock(cell_run.device), STEPS)
    ctx.span_s = {k: v / STEPS for k, v in self_device_s(prof).items()}
    return ctx.span_s


def summed_ms(ctx, phase: str, suffix: str) -> Optional[float]:
    """Milliseconds a step of ``train.<phase>``'s own device time and every
    span ending in ``suffix`` (the ops' ``.fwd`` or ``.bwd``); None where
    the steps recorded no ``train.<phase>``."""
    span_s = per_step(ctx)
    if not span_s or f"train.{phase}" not in span_s:
        return None
    return 1e3 * sum(v for k, v in span_s.items()
                     if k == f"train.{phase}" or (suffix and
                                                  k.endswith(suffix)))
