"""Named host spans in the port's traces: ``span(name)`` and ``spanned``.

A span is a ``torch.profiler.record_function`` range, so it lands in the
one trace the port already takes (``utils.benchlib.trace_fn``, or any
``torch.profiler.profile``) as a host event on the profiler's clock, the
clock of the device trace. The device ops launched inside a span can then
be credited to it, and an idle gap named after it. With no profiler
recording, ``span`` returns one shared no-op context and builds nothing.

The port's spans, all under four prefixes:

- ``train.step``, ``train.forward`` (the model and the loss),
  ``train.backward`` and ``train.optimizer`` (AdamW's step) in
  ``train.loop``'s full-graph and sampled steps;
- ``ell.<op>.fwd`` / ``ell.<op>.bwd`` in the forward and backward of every
  ``torch.autograd.Function`` of ``ops.ell`` (``ell_gat_attention`` →
  ``ell.gat_attention``), and ``sampled.copy_spmm.fwd`` / ``.bwd`` in
  ``ops.sampled``; a backward span runs on autograd's thread;
- ``data.sample`` (one batch's sampling in ``train.loop.sampled_batches``),
  ``data.to_device`` (the prefetch thread's copies) and
  ``data.batch_wait`` (the consumer's wait for the next batch) in the
  sampled pipeline;
- ``train.reversible.fwd`` / ``.bwd`` around a reversible block's forward
  and backward (``models.revgat``), and ``train.recompute`` around the
  backward's recomputation of the block's functions (:func:`recompute`).

Every span opened inside :func:`recompute` on its thread ends in
``.recompute`` (``ell.gat_attention.fwd.recompute``), so that a forward
run again in the backward is told apart from the step's forward: the
``.fwd`` and ``.bwd`` spans are the step's own work, the ``.recompute``
spans what recomputation adds.

``launch(name)`` wraps a kernel launched outside the dispatcher (every
ctypes call, through ``ops/kernels/_build.call``), so that the profiler
links it to a host event inside the caller's span.

``torch.profiler`` records a thread only where its state reaches it: the
caller's thread and autograd's threads. A ``threading.Thread`` such as
``data.pipeline.prefetch``'s producer is recorded only under
``experimental_config=_ExperimentalConfig(profile_all_threads=True)``
(as ``utils.benchlib.trace_fn`` takes its traces), so ``span`` also opens
where any profiler of the process records.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
RECOMPUTE = ".recompute"
# The suffix of the spans opened on this thread: RECOMPUTE inside
# ``recompute``, else none.
_tag = threading.local()


def _recording() -> bool:
    return (torch.autograd._profiler_enabled()
            or getattr(_profiler, "_is_profiler_enabled", False))


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    no-op context; inside :func:`recompute` the name ends in
    ``.recompute``."""
    if _recording():
        return _profiler.record_function(name + getattr(_tag, "suffix", ""))
    return _OFF


@contextlib.contextmanager
def recompute():
    """The span ``train.recompute``, inside which every span this thread
    opens ends in ``.recompute``. The tag is set whether or not a profiler
    records, and read only by :func:`span` while one does."""
    with span("train.recompute"):
        outer = getattr(_tag, "suffix", "")
        _tag.suffix = RECOMPUTE
        try:
            yield
        finally:
            _tag.suffix = outer


def launch(name: str):
    """An op-scope range named ``name`` around a kernel launched outside
    the dispatcher (a ctypes call) while a profiler records, else the
    shared no-op context.

    The profiler links a kernel to the innermost op-scope range open at
    its launch; a span (``record_function``) is a user-scope range and is
    not one. A kernel launched bare inside an autograd Function would link
    to the Function's own range (``_EllGat``, ``_EllGatBackward``), which
    opens before the Function's ``ell.*`` span, and the span would get
    none of its time.

    ``torch._C._profiler._RecordFunctionFast`` is private PyTorch API (no
    public call opens an op-scope range); checked on torch 2.11 with CUDA
    and 2.13 on the CPU (``tests/test_torch_spans.py``)."""
    if _recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def spanned(name: str):
    """Decorator: the function's every call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
