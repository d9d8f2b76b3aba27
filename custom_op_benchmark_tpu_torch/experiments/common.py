"""What the measurement drivers of this package share: their command line
(``--device``, ``--small``), the device they run on, their timed rows and
their one JSON line.

A driver runs on the CUDA device and stops where there is none; ``--device
cpu`` runs every path and every gate at a small size and times nothing
(its rows are None, "not measured"); ``--small`` is a card run of a few
seconds. A host-only probe (:func:`run_host_main`) touches no card: its
figures are host figures at every size, and ``--device cpu`` and
``--small`` both pick its small size. Rows are timed by ``benchlib.bench_fn`` with ``iters="auto"``
(CUDA events, median of 3 windows of at least 20 ms).

The A/B scripts (``ab_tiled``, ``ab_gather``) build other copies of the
kernels' sources (:func:`load_builds`) and run the committed wrappers on
them (:func:`on_library`).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from typing import Callable, Optional

import torch

from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.utils.benchlib import bench_fn
from custom_op_benchmark_tpu_torch.utils.device import cuda_device

TIMING = dict(warmup=1, iters="auto", repeats=3)

# (nodes, edges) of the power-law graph of the ELL and halo drivers, by
# size (:func:`size_of`): ``random_graph(n, e, power_law=True)``.
GRAPH = {"full": (131072, 2_000_000), "small": (16384, 250_000),
         "cpu": (512, 4000)}


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA device, and fail "
                    "without one); cpu runs every path at a small size and "
                    "times nothing")
    ap.add_argument("--small", action="store_true",
                    help="a card run of a few seconds at a small size")
    return ap


def pick_device(args, name: str) -> Optional[torch.device]:
    """The device ``args`` asks for; None (and a message) where it asks for
    the card and there is none."""
    if args.device == "cpu":
        return torch.device("cpu")
    try:
        return cuda_device()
    except RuntimeError as err:
        print(f"{name}: {err} (pass --device cpu for the small size)",
              file=sys.stderr)
        return None


def where(device: torch.device) -> str:
    """The card's name, or the device's on the CPU."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


class Rows:
    """The timed rows of one driver run, in ms: ``bench_fn``'s median on
    the card; on the CPU each path runs once and its row is None."""

    def __init__(self, device: torch.device, prefix: str = ""):
        self.timed = device.type == "cuda"
        self.prefix = prefix
        self.ms: dict = {}

    def __call__(self, name: str, fn: Callable, *args,
                 edges: Optional[int] = None) -> Optional[float]:
        if self.timed:
            rec = bench_fn(fn, args, name=name, edges=edges, **TIMING)
            ms = rec.time_s * 1e3
            line = f"{self.prefix}{name:40s} {ms:10.3f} ms"
            if edges is not None:
                line += f"  {rec.edges_per_s / 1e6:9.1f} Medges/s"
            line += f"  ({rec.extra['iters']} calls a window)"
        else:
            fn(*args)
            ms = None
            line = f"{self.prefix}{name:40s} not measured (no CUDA device)"
        self.ms[name] = ms
        print(line, flush=True)
        return ms


def sq_grad(f: Callable) -> Callable:
    """The gradients of ``(f(*args)²).sum()`` with respect to every tensor
    argument that requires grad: the rows' ``jax.grad`` of the same loss."""

    def grad(*args):
        ins = [a for a in args
               if isinstance(a, torch.Tensor) and a.requires_grad]
        return torch.autograd.grad((f(*args).float() ** 2).sum(), ins)

    return grad


def emit(key: str, result: dict) -> None:
    """Print the driver's one JSON line ``{key: result}``."""
    print(json.dumps({key: result}), flush=True)


def size_of(args, device: torch.device) -> str:
    """"cpu" (the small size, nothing timed), "small" (``--small`` on the
    card) or "full"."""
    if device.type == "cpu":
        return "cpu"
    return "small" if args.small else "full"


def run_main(name: str, doc: str, run: Callable, argv=None) -> int:
    """Parse ``argv``, pick the device and print ``run(device, size)``'s
    result (:func:`size_of`) as one JSON line; exit 1 where there is no
    card or the result's ``ok`` is False."""
    args = parser(doc).parse_args(argv)
    device = pick_device(args, name)
    if device is None:
        return 1
    result = run(device, size_of(args, device))
    emit(name, result)
    return 0 if result.get("ok", True) else 1


def run_host_main(name: str, doc: str, run: Callable, argv=None) -> int:
    """:func:`run_main` for a host-only probe: ``run(size)``, "full" by
    default, "small" under ``--small`` or ``--device cpu``."""
    args = parser(doc).parse_args(argv)
    result = run("small" if args.small or args.device == "cpu" else "full")
    emit(name, result)
    return 0 if result.get("ok", True) else 1


def load_builds(sources, tag: str) -> list:
    """Each CUDA source built on its own into a shared library under
    ``build/`` with the port's nvcc flags (one nvcc each, all started
    together; a quoted include resolves beside the source first, then in
    ``csrc/``) and its entry points bound with the committed signatures
    (``_build._SIGNATURES``): the libraries, in order, each with
    ``.entries``, the names of the entry points it has."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sos = [_build.BUILD_DIR / f"{tag}_{src.parent.name}_{src.stem}.so"
           for src in sources]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(_build.CSRC), "-shared", "-o", str(so),
                               str(src)])
             for src, so in zip(sources, sos)]
    libs = []
    for src, so, proc in zip(sources, sos, procs):
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {src}")
        lib = ctypes.CDLL(str(so))
        lib.entries = {name for name in _build._SIGNATURES
                       if hasattr(lib, name)}
        for name in lib.entries:
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs.append(lib)
    return libs


@contextlib.contextmanager
def on_library(lib):
    """Inside the block every wrapper of ``ops/kernels`` launches ``lib``'s
    entry points: ``_build.call`` looks the library up at each launch."""
    real = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = real
