"""Per-process shards of node-indexed arrays.

Counterpart of custom_op_benchmark_tpu/data/distributed.py. A feature
matrix too large for one host is never built whole: each process loads
only the rows its shards own (:func:`process_row_range`) through a loader
callback, for example over a ``.npy`` memmap (:func:`memmap_rows`), and
:func:`sharded_node_array` places them. On the local mesh one process
owns every shard and the loader is called once for the whole range, as in
the reference's one-process case; on the process mesh each rank reads its
own block.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_rows(n_rows: int, mesh, axis: str) -> int:
    """The global row count padded so the mesh axis divides it."""
    return _round_up(n_rows, mesh.shape[axis])


def process_row_range(n_rows: int, mesh, axis: str = "edge") -> Tuple[int,
                                                                       int]:
    """``[lo, hi)`` of the padded global rows this process owns along
    ``axis``: its coordinate along the axis (not its rank: on a 2-D mesh
    they differ)."""
    n_pad = padded_rows(n_rows, mesh, axis)
    if mesh.is_local:
        return 0, n_pad
    per = n_pad // mesh.shape[axis]
    c = mesh.shard_index(axis)
    return c * per, (c + 1) * per


def sharded_node_array(load_rows: Callable[[int, int], np.ndarray],
                       n_rows: int, trailing_shape: Sequence[int], mesh, *,
                       axis: str = "edge", dtype=np.float32) -> torch.Tensor:
    """This process's rows of the ``(n_pad, *trailing)`` array, row-sharded
    over ``axis``, loaded with ``load_rows(lo, hi)`` (rows past ``n_rows``
    are zero padding; the loader is never asked for them)."""
    lo, hi = process_row_range(n_rows, mesh, axis)
    real_hi = min(hi, n_rows)
    local = np.zeros((hi - lo,) + tuple(trailing_shape), dtype)
    if real_hi > lo:
        local[: real_hi - lo] = load_rows(lo, real_hi)
    return torch.from_numpy(local).to(mesh.device)


def memmap_rows(npy_path: str) -> Callable[[int, int], np.ndarray]:
    """A row loader over an on-disk ``.npy`` (never read whole)."""
    arr = np.load(npy_path, mmap_mode="r")

    def load(lo: int, hi: int) -> np.ndarray:
        return np.asarray(arr[lo:hi])

    return load
