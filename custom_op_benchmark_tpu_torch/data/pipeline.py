"""Minibatch prefetch: host sampling overlapped with the device's steps.

Counterpart of custom_op_benchmark_tpu/data/pipeline.py. A background
thread runs the iterator (the sampler; its native calls release the GIL)
and, given a CUDA ``device``, copies each item's tensors there: into
pinned host memory, then ``non_blocking`` on a side stream, with an event
recorded after the copies. The consumer makes its current stream wait on
that event before it uses the item, and ``record_stream`` tells the
caching allocator that the item's device memory is in use on the consumer's
stream, so it is not handed out again before those steps end. An error in
the producer surfaces in the consumer. ``size`` items are queued ahead. A
consumer that stops early stops the producer at its next item. The
producer's copies run in the span ``data.to_device`` and the consumer's
wait for an item in ``data.batch_wait`` (``utils.spans``; the producer's
thread shows in a trace taken with ``profile_all_threads``).

Items are nested tuples, lists and dicts of tensors, numpy arrays (made
tensors) and :class:`~custom_op_benchmark_tpu_torch.graph.graph.Graph`s;
anything else passes through unchanged.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph.graph import Graph
from custom_op_benchmark_tpu_torch.utils.spans import span


def map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``obj`` with ``fn`` applied to every tensor in it (numpy arrays
    become tensors first)."""
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(obj)
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, Graph):
        return dataclasses.replace(obj, **{
            f.name: fn(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    return obj


def prefetch(iterator: Iterable, size: int = 2,
             device=None) -> Iterator:
    """Wrap ``iterator`` with a ``size``-deep background queue; with a CUDA
    ``device`` the items arrive there (see the module docstring)."""
    device = None if device is None else torch.device(device)
    on_card = device is not None and device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    err: list = []
    stop = threading.Event()

    def put(entry) -> bool:
        """Queue ``entry`` unless the consumer has gone; False if it has."""
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            stream = torch.cuda.Stream(device) if on_card else None
            for item in iterator:
                event = None
                if on_card:
                    with span("data.to_device"), torch.cuda.stream(stream):
                        item = map_tensors(item, lambda t: t.pin_memory().to(
                            device, non_blocking=True))
                        event = torch.cuda.Event()
                        event.record(stream)
                elif device is not None:
                    with span("data.to_device"):
                        item = map_tensors(item, lambda t: t.to(device))
                if not put((item, event)):
                    return
        except BaseException as e:   # surfaces in the consumer
            err.append(e)
        finally:
            put((done, None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with span("data.batch_wait"):
                item, event = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)

                def in_use(t, stream=current):
                    t.record_stream(stream)
                    return t

                item = map_tensors(item, in_use)
            yield item
    finally:
        # A consumer that stops early (or fails) lets the producer go: it
        # stops at its next item instead of waiting on a full queue.
        stop.set()
        thread.join()
