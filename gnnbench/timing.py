"""Timing on the card and the arithmetic of a profiled window.

Frozen copies, apart from the port so that a change there cannot move the
yardstick, of the port's ``utils.benchlib.bench_fn`` (CUDA events around
back-to-back calls after warm-up, the calls in a window doubled until it
lasts 20 ms, the median of repeats) and ``device_summary`` (device events
only, annotation spans left out, busy time the union of their spans, each
name credited the busy time it adds). ``idle_gaps`` names each gap in the
device's busy time by what the host was doing.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable

import numpy as np
import torch

AUTO_WINDOW_S = 0.020
AUTO_MAX_CALLS = 4096


def time_cuda(fn: Callable[[], Any], *, warmup: int, iters: int,
              repeats: int) -> list:
    """Mean seconds per call of ``fn()`` for each of ``repeats`` windows of
    ``iters`` calls, by CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return times


def bench_fn(fn: Callable[[], Any], *, warmup: int = 3,
             repeats: int = 5) -> float:
    """Median seconds per call of ``fn()``: calls a window doubled from 1
    until the window lasts ``AUTO_WINDOW_S`` (or ``AUTO_MAX_CALLS``), then
    the median of ``repeats`` windows. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fn times a CUDA device; none is present")
    for _ in range(warmup):
        fn()
    k = 1
    while k < AUTO_MAX_CALLS and time_cuda(
            fn, warmup=0, iters=k, repeats=1)[0] * k < AUTO_WINDOW_S:
        k = min(2 * k, AUTO_MAX_CALLS)
    return statistics.median(time_cuda(fn, warmup=0, iters=k,
                                       repeats=repeats))


def _device_spans(prof) -> list:
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def device_summary(prof, top: int = 10) -> dict:
    """Busy time (the union of the device's spans), the window from the
    first start to the last end, and the ``top`` names by the busy time
    each adds (its spans less what an earlier span already covered), all
    in seconds; None times where the device ran nothing."""
    spans = _device_spans(prof)
    if not spans:
        return dict(busy_s=None, window_s=None, events=0, top=[], gaps=[])
    busy, end = 0.0, None
    per_name: dict = {}
    gaps = []
    for s, e, name in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        added = e - s if end is None or s >= end else max(e - end, 0.0)
        busy += added
        end = e if end is None else max(end, e)
        per_name[name] = per_name.get(name, 0.0) + added
    ranked = sorted(per_name.items(), key=lambda kv: kv[1], reverse=True)
    return dict(busy_s=busy / 1e6, window_s=(end - spans[0][0]) / 1e6,
                events=len(spans),
                top=[[name, us / 1e6] for name, us in ranked[:top]],
                gaps=gaps)


def idle_gaps(prof, gaps: list, top: int = 10, longest: int = 400) -> list:
    """The device's idle time by what the host was doing: each of the
    ``longest`` gaps is named by the innermost host event (op or
    ``record_function`` span) that spans its middle, and the ``top`` names
    by summed gap seconds are returned as ``[name, seconds]``."""
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    per_name: dict = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        mid = 0.5 * (g0 + g1)
        around = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = "(no host event)"
        if around.size:
            name = host[around[np.argmin(ends[around] - starts[around])]][2]
        per_name[name] = per_name.get(name, 0.0) + (g1 - g0) / 1e6
    ranked = sorted(per_name.items(), key=lambda kv: kv[1], reverse=True)
    return [[name, s] for name, s in ranked[:top]]
