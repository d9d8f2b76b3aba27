"""Row gathers and segment sums over the shards of a mesh, without atomics.

The plans' per-shard code reads node rows by edge (``x_ext[src_ext]``,
``q[dst_loc]``) and sums edge values into node rows. The JAX package leaves
the VJPs of those gathers to AD, which adds with scatters; on the card a
scatter adds with atomics in an order that changes from run to run. Here
both are the single-device pair of ``ops/xla.py`` (``GatherRows``,
``SegmentSum``) on a table of all local shards' rows, over one host-built
plan:

- :func:`take` gathers rows ``table[l][idx[l, e]]`` for each local shard
  ``l``; its VJP sums the cotangent over the slots of each row;
- :func:`segment_sum` sums values into rows ``idx[l, e]``; its VJP gathers
  the cotangent back by the same ids.

Both sums run on S3's CSR entry (``csr_sum``) over the plan's CSR of the
flattened ids ``l·n_rows + idx[l, e]``, in slot order, so the same inputs
give the same bits on every run. The plan is built once on the host
(:func:`row_index`): an argsort when the ids are not sorted.

:func:`take_raw` is the plain gather for code that runs under a hand VJP.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.ops.xla import (
    GatherRows,
    SegmentSum,
    segment_max as segment_max_flat,
)


@dataclasses.dataclass(frozen=True)
class RowIndex:
    """Ids ``(L, E)`` into tables of ``n_rows`` rows per shard, with the
    CSR of their flattened ids: ``ptr`` ``(L·n_rows + 1,)`` int32 and
    ``order`` ``(L·E,)`` int32 (slot positions grouped by id, in slot
    order; None when the flattened ids are sorted already)."""

    flat: torch.Tensor
    ptr: torch.Tensor
    order: Optional[torch.Tensor]
    shape: tuple
    n_rows: int

    @property
    def ids(self) -> torch.Tensor:
        """The ids ``(L, E)`` (int64), without the shard offsets."""
        return self.flat.view(self.shape) % self.n_rows


def row_index(idx, n_rows: int, device) -> RowIndex:
    """The plan of ``idx`` (numpy or tensor ``(L, E)``, values in
    ``[0, n_rows)``)."""
    ids = (idx.cpu().numpy() if isinstance(idx, torch.Tensor)
           else np.asarray(idx)).astype(np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= n_rows):
        raise ValueError(f"ids outside [0, {n_rows})")
    n_l = ids.shape[0]
    flat = (ids + np.arange(n_l, dtype=np.int64)[:, None] * n_rows).ravel()
    order = None
    if flat.size > 1 and bool((flat[1:] < flat[:-1]).any()):
        order = np.argsort(flat, kind="stable")
        srt = flat[order]
    else:
        srt = flat
    ptr = np.zeros(n_l * n_rows + 1, np.int64)
    np.cumsum(np.bincount(srt, minlength=n_l * n_rows), out=ptr[1:])

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return RowIndex(flat=t(flat, np.int64), ptr=t(ptr, np.int32),
                    order=None if order is None else t(order, np.int32),
                    shape=tuple(ids.shape), n_rows=int(n_rows))


def take_raw(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[l, ...] = table[l, idx[l, ...]]`` for ``table`` ``(L, N, ...)``
    and integer ``idx`` ``(L, ...)``; no autograd."""
    n_l, n = table.shape[0], table.shape[1]
    trail = tuple(table.shape[2:])
    off = torch.arange(n_l, device=idx.device, dtype=torch.int64) * n
    fidx = idx.long() + off.view((n_l,) + (1,) * (idx.dim() - 1))
    return table.reshape((n_l * n,) + trail)[fidx]


def take(table: torch.Tensor, ri: RowIndex) -> torch.Tensor:
    """``(L, n_rows, ...)`` → ``(L, E, ...)``: each shard's rows by its ids.
    VJP: the sorted segment sum of the cotangent (``csr_sum``)."""
    if table.shape[:2] != (ri.shape[0], ri.n_rows):
        raise ValueError(f"table {tuple(table.shape)} for ids over "
                         f"{ri.n_rows} rows of {ri.shape[0]} shards")
    trail = tuple(table.shape[2:])
    flat = GatherRows.apply(table.reshape((-1,) + trail), ri.flat, ri.ptr,
                            ri.order)
    return flat.reshape(ri.shape + trail)


def segment_sum(vals: torch.Tensor, ri: RowIndex) -> torch.Tensor:
    """``(L, E, ...)`` → ``(L, n_rows, ...)``: each shard's values summed
    into the rows its ids name, in slot order. VJP: :func:`take` of the
    cotangent."""
    if tuple(vals.shape[:2]) != ri.shape:
        raise ValueError(f"values {tuple(vals.shape)} for ids {ri.shape}")
    trail = tuple(vals.shape[2:])
    y = SegmentSum.apply(vals.reshape((-1,) + trail), ri.ptr, ri.order,
                         ri.flat)
    return y.reshape((ri.shape[0], ri.n_rows) + trail)


def segment_max(vals: torch.Tensor, ri: RowIndex) -> torch.Tensor:
    """``(L, E, ...)`` → ``(L, n_rows, ...)`` maxima per row (-1e9 where a
    row has no slot): ``ops/xla.py``'s ``segment_max`` over the flattened
    ids. Callers pass detached values: a softmax's stability shift."""
    trail = tuple(vals.shape[2:])
    m = segment_max_flat(vals.reshape((-1,) + trail), ri.flat,
                         ri.shape[0] * ri.n_rows)
    return m.reshape((ri.shape[0], ri.n_rows) + trail)
