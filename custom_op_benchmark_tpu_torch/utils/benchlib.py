"""Benchmark harness: warm-up, repeats, medians, roofline accounting.

Counterpart of the interface of custom_op_benchmark_tpu/utils/benchlib.py
(:class:`BenchRecord`, :func:`bench_fn`, :func:`hbm_bandwidth_bytes`) for a
CUDA card, plus :func:`l2_gather_rate`, the card's ceiling for row
gathers that hit L2. Timing is by CUDA events around ``iters`` back-to-back calls
after warm-up, and the median of ``repeats`` such runs; a host clock would
time only the enqueue. The peak memory bandwidth is measured on the device
with a large copy, not read from a table. On a CPU tensor there is no
device to time and :func:`bench_fn` raises: a CPU run is a smoke run of
the code paths, never a device number.
"""

from __future__ import annotations

import dataclasses
import functools
import json
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


def bench_fn(fn: Callable[..., Any], args: tuple = (), *, warmup: int = 3,
             iters: int = 10, repeats: int = 5, name: str = "bench",
             bytes_moved: Optional[float] = None,
             flops: Optional[float] = None, edges: Optional[int] = None,
             **extra) -> BenchRecord:
    """Time ``fn(*args)`` on the CUDA device that holds ``args``: the
    median over ``repeats`` of the mean of ``iters`` back-to-back calls,
    after ``warmup`` calls. Raises on CPU tensors."""
    dev = _device_of(args)
    if dev.type != "cuda":
        raise RuntimeError(f"bench_fn times CUDA devices; the arguments lie "
                           f"on {dev}")
    times = time_cuda(lambda: fn(*args), warmup=warmup, iters=iters,
                      repeats=repeats, device=dev)
    return BenchRecord(name=name, time_s=statistics.median(times),
                       times=times, bytes_moved=bytes_moved, flops=flops,
                       edges=edges, device=torch.cuda.get_device_name(dev),
                       extra=extra)


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


def l2_gather_rate(device=None, *, table_rows: int = 16384, d: int = 128,
                   rows: int = 125_000, slots: int = 16,
                   seed: int = 11) -> float:
    """Bytes per second that the ELL gather-sum kernel S3 gathers from a
    table resident in the 50 MB L2 (``table_rows`` rows of ``d`` floats: 8
    MiB by default), in the pattern of the S3 experiment (``rows`` rows of
    ``slots`` random slots): the rate that bounds a gather whose rows
    mostly hit L2. Measured on the CUDA device; raises where there is none.
    """
    import numpy as np

    from custom_op_benchmark_tpu_torch.graph.ell import one_bucket_table
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
        gather_sum,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("l2_gather_rate measures a CUDA device; none is "
                           "present")
    dev = torch.device("cuda") if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (table_rows, d), dtype=np.float32)).to(dev)
    cols = torch.from_numpy(rng.integers(
        0, table_rows, size=(rows, slots)).astype(np.int32)).to(dev)
    table = one_bucket_table(cols)
    t = statistics.median(time_cuda(lambda: gather_sum(table, x),
                                    device=dev))
    return cols.numel() * d * 4 / t
