"""Benchmark harness: warm-up, repeats, medians, roofline accounting.

Counterpart of the interface of custom_op_benchmark_tpu/utils/benchlib.py
(:class:`BenchRecord`, :func:`bench_fn`, :func:`trace_fn`,
:func:`hbm_bandwidth_bytes`) for a CUDA card, plus :func:`l2_gather_rate`,
the card's ceiling for row gathers that hit L2 (a probe kernel of its own,
csrc/l2_probe.cu), and :func:`device_summary`, the busy time, idle share
and top kernels of a ``torch.profiler`` window. Timing is by CUDA events
around ``iters`` back-to-back calls after warm-up, and the median of
``repeats`` such runs; a host clock would time only the enqueue. The peak
memory bandwidth is measured on the device with a large copy, not read
from a table. On a CPU tensor there is no device to time and
:func:`bench_fn` raises: a CPU run is a smoke run of the code paths, never
a device number.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import statistics
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class BenchRecord:
    """One structured benchmark result."""

    name: str
    time_s: float                 # median time per call, seconds
    times: list                   # every repeat's mean time per call
    bytes_moved: Optional[float] = None   # minimal/ideal bytes per call
    flops: Optional[float] = None
    edges: Optional[int] = None
    device: Optional[str] = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def edges_per_s(self) -> Optional[float]:
        return None if self.edges is None else self.edges / self.time_s

    @property
    def achieved_bw(self) -> Optional[float]:
        return (None if self.bytes_moved is None
                else self.bytes_moved / self.time_s)

    def roofline_fraction(self, peak_bytes_per_s: Optional[float] = None):
        """Achieved bytes/s over the peak (default: the measured copy
        bandwidth of the current CUDA device)."""
        if self.bytes_moved is None:
            return None
        peak = peak_bytes_per_s or hbm_bandwidth_bytes()
        return self.achieved_bw / peak

    def to_json(self) -> str:
        d = dict(name=self.name, time_s=self.time_s, device=self.device,
                 edges_per_s=self.edges_per_s,
                 achieved_gb_s=(None if self.achieved_bw is None
                                else self.achieved_bw / 1e9),
                 roofline_frac=self.roofline_fraction(), **self.extra)
        return json.dumps({k: v for k, v in d.items() if v is not None})


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("bench_fn needs at least one tensor argument to know "
                     "which device it times")


def time_cuda(fn: Callable[[], Any], *, warmup: int = 3, iters: int = 10,
              repeats: int = 5, device=None) -> list:
    """Mean seconds per call of ``fn()`` for each of ``repeats`` runs of
    ``iters`` calls, by CUDA events on ``device``'s current stream, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return times


# iters="auto": the calls in one CUDA-event window double until the window
# lasts this long, or until AUTO_MAX_CALLS calls.
AUTO_WINDOW_S = 0.020
AUTO_MAX_CALLS = 4096


def auto_calls(window_s: Callable[[int], float], *,
               target_s: float = AUTO_WINDOW_S,
               max_calls: int = AUTO_MAX_CALLS) -> int:
    """The calls per timed window for ``iters="auto"``: 1, 2, 4, ... until
    ``window_s(k)`` (the seconds of one window of ``k`` calls) reaches
    ``target_s``, or ``max_calls``."""
    k = 1
    while k < max_calls and window_s(k) < target_s:
        k = min(2 * k, max_calls)
    return k


def _clone(x):
    """A copy of ``x`` whose tensors own fresh storage (tuples, lists and
    dicts are copied through; anything else is shared)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone().requires_grad_(x.requires_grad)
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def rotated_args(args: tuple, rotate: int) -> list:
    """``rotate`` sets of ``args`` for ``bench_fn(rotate=R)``: the first is
    ``args`` itself, the others copies that share no tensor storage with
    it or with each other."""
    if rotate < 1:
        raise ValueError(f"rotate must be at least 1, got {rotate}")
    return [args] + [_clone(args) for _ in range(rotate - 1)]


def bench_fn(fn: Callable[..., Any], args: tuple = (), *, warmup: int = 3,
             iters=10, repeats: int = 5, name: str = "bench",
             bytes_moved: Optional[float] = None,
             flops: Optional[float] = None, edges: Optional[int] = None,
             rotate: int = 1, **extra) -> BenchRecord:
    """Time ``fn(*args)`` on the CUDA device that holds ``args``: the
    median over ``repeats`` of the mean of ``iters`` back-to-back calls,
    after ``warmup`` calls. Raises on CPU tensors.

    ``iters="auto"`` doubles the calls in one CUDA-event window until the
    window lasts at least 20 ms (or 4096 calls), so a row of a few µs
    stands clear of the events' resolution and launch jitter; the count
    chosen is the record's ``extra["iters"]``. ``rotate=R`` cycles the
    calls over R independent copies of ``args`` (see
    :func:`rotated_args`), so the working set can exceed the card's 50 MB
    L2 and back-to-back calls read device memory, as a caller that finds
    its inputs cold would."""
    dev = _device_of(args)
    if dev.type != "cuda":
        raise RuntimeError(f"bench_fn times CUDA devices; the arguments lie "
                           f"on {dev}")
    sets = itertools.cycle(rotated_args(args, rotate))

    def call():
        return fn(*next(sets))

    if iters == "auto":
        for _ in range(warmup):
            call()
        iters = auto_calls(lambda k: time_cuda(call, warmup=0, iters=k,
                                               repeats=1, device=dev)[0] * k)
        extra["iters"] = iters
    elif not isinstance(iters, int) or iters < 1:
        raise ValueError(f"iters must be a positive int or 'auto', got "
                         f"{iters!r}")
    if rotate > 1:
        extra["rotate"] = rotate
    times = time_cuda(call, warmup=warmup, iters=iters, repeats=repeats,
                      device=dev)
    return BenchRecord(name=name, time_s=statistics.median(times),
                       times=times, bytes_moved=bytes_moved, flops=flops,
                       edges=edges, device=torch.cuda.get_device_name(dev),
                       extra=extra)


def device_summary(prof, top: int = 8) -> dict:
    """Busy time, idle share and top device activities of a profiled
    window (``torch.profiler.profile``, or any object whose ``events()``
    have ``name``, ``device_type`` and ``time_range``).

    Only events that ran on the device count: kernels, copies and sets,
    never the host ops that launched them nor the spans that annotate a
    group of kernels on the device's timeline (``record_function`` and
    the optimizer's step), so no time is counted twice.
    ``busy_ms`` is the union of their spans, ``window_ms`` the span from
    the first start to the last end, ``idle_share`` 1 − busy / window.
    ``top`` lists the ``top`` names by busy time, each with ``ms`` (the
    busy time it added: its spans less what an event that started earlier
    already covered, so the list's ``share`` of busy sums to at most 1)
    and ``count``. With no device event (a CPU run) the three times and
    the share are None and ``top`` is empty."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        return dict(busy_ms=None, window_ms=None, idle_share=None, events=0,
                    top=[])
    busy, end = 0.0, None
    per_name: dict = {}
    for s, e, name in spans:
        added = e - s if end is None or s >= end else max(e - end, 0.0)
        busy += added
        end = e if end is None else max(end, e)
        ms, count = per_name.get(name, (0.0, 0))
        per_name[name] = (ms + added, count + 1)
    window = end - spans[0][0]
    ranked = sorted(per_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return dict(
        busy_ms=busy / 1e3, window_ms=window / 1e3,
        idle_share=1.0 - busy / window if window > 0 else 0.0,
        events=len(spans),
        top=[dict(name=name, ms=us / 1e3, share=us / busy if busy else 0.0,
                  count=count) for name, (us, count) in ranked[:top]])


def trace_fn(fn: Callable[..., Any], args: tuple, trace_dir: str, *,
             iters: int = 3) -> str:
    """Profile ``fn(*args)`` with ``torch.profiler`` (CPU and, on a CUDA
    device, CUDA activities) on the device that holds ``args``: a warm-up
    step of one call under the profiler, whose events are dropped (the
    tracer's first kernels can be lost while it starts), then a recorded
    step of ``iters`` calls and a synchronisation. Writes the Chrome trace
    (``trace.json``, for Perfetto or ``chrome://tracing``) and
    ``summary.json`` (:func:`device_summary` of the recorded step, its
    ``iters``, the device and the step's host ``ms``) into ``trace_dir``,
    and returns ``trace_dir``. Every thread of the process is recorded
    (``profile_all_threads``), not only the caller's and autograd's: a
    prefetch thread's ``data.*`` spans too (``utils.spans``)."""
    import time

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = _device_of(args)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1),
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
        fn(*args)
        sync()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        wall = time.perf_counter() - t0
        prof.step()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    summary = dict(device_summary(prof), iters=iters, host_ms=wall * 1e3,
                   device=(torch.cuda.get_device_name(dev) if on_card
                           else str(dev)))
    with open(os.path.join(trace_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return trace_dir


def read_summary(trace_dir: str) -> dict:
    """The ``summary.json`` that :func:`trace_fn` wrote into ``trace_dir``."""
    with open(os.path.join(trace_dir, "summary.json")) as f:
        return json.load(f)


def bench_ms(out: dict, name: str, fn: Callable[..., Any], *args,
             bytes_models: Optional[dict] = None,
             peak: Optional[float] = None, **kw) -> BenchRecord:
    """Time ``fn(*args)`` with :func:`bench_fn` (``kw`` goes to it), store
    the median ms as ``out[name]`` and print one row: ms, Medges/s when
    ``edges`` is given, and the roofline fraction of each of
    ``bytes_models`` (name → bytes per call) against ``peak`` bytes/s,
    which the record's ``extra`` also keeps as ``roofline_frac_<name>``."""
    rec = bench_fn(fn, args, name=name, **kw)
    out[name] = rec.time_s * 1e3
    line = f"  {name:40s} {out[name]:9.3f} ms"
    if rec.edges_per_s is not None:
        line += f"   {rec.edges_per_s / 1e6:9.1f} Medges/s"
    if bytes_models:
        fracs = {k: b / rec.time_s / peak for k, b in bytes_models.items()}
        rec.extra.update({f"roofline_frac_{k}": f for k, f in fracs.items()})
        line += "   roofline %s (%s)" % (
            "/".join(f"{f:.4f}" for f in fracs.values()), "/".join(fracs))
    print(line, flush=True)
    return rec


@functools.lru_cache(maxsize=None)
def _copy_bandwidth(index: int, nbytes: int) -> float:
    dev = torch.device("cuda", index)
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    times = time_cuda(lambda: dst.copy_(src), warmup=3, iters=10, repeats=5,
                      device=dev)
    return 2 * nbytes / statistics.median(times)   # read + write


def hbm_bandwidth_bytes(device=None, nbytes: int = 1 << 30) -> float:
    """Device-memory bytes/s of the CUDA device, measured once per device
    as a ``nbytes`` device-to-device copy (read plus write bytes over the
    median copy time). Raises when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("hbm_bandwidth_bytes measures a CUDA device; "
                           "none is present")
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _copy_bandwidth(index, int(nbytes))


L2_PROBE_ROW_BYTES = 512   # csrc/l2_probe.cu: 128 floats a row


def l2_gather_rate(device=None, *, table_rows: int = 16384,
                   reads: int = 256, warps: int = 8192) -> float:
    """Bytes per second that the card's L2 serves random rows of 512 bytes
    (128 floats, one 16-byte load a lane: the row S3 reads at d = 128) from
    a table resident in the 50 MB L2 (``table_rows`` rows: 8 MiB by
    default), ``warps`` warps of ``reads`` rows each (1.07 GB by
    default, about the S3 experiment's gathers): the better of 8 and 16
    rows in flight a warp. Measured by csrc/l2_probe.cu, a kernel whose only purpose is
    this measurement, so the bound it gives S3's rows does not move when
    S3 does. Measured on the CUDA device; raises where there is none.
    ``l2_gather_rate.launches`` counts the probe's launches."""
    import numpy as np

    from custom_op_benchmark_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        raise RuntimeError("l2_gather_rate measures a CUDA device; none is "
                           "present")
    dev = torch.device("cuda") if device is None else torch.device(device)
    table = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (table_rows, L2_PROBE_ROW_BYTES // 4), dtype=np.float32)).to(dev)
    out = torch.empty(warps, device=dev)

    def probe(depth):
        _build.call(l2_gather_rate, "l2_probe", table, _build.c_ptr(table),
                    table_rows, reads, warps, depth, _build.c_ptr(out))

    t = min(statistics.median(time_cuda(lambda: probe(depth), device=dev))
            for depth in (8, 16))
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the L2 probe wrote a non-finite sum")
    return warps * reads * L2_PROBE_ROW_BYTES / t


l2_gather_rate.launches = 0
