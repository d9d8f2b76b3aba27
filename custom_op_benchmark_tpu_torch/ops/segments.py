"""Deterministic reductions over sorted segments (no scatter, no atomics).

The JAX package reduces sorted tile segments with a segmented associative
scan (custom_op_benchmark_tpu/ops/tiled.py:139-174). Here each segment is
gathered into a padded ``(n_segments, max_len)`` block along the reduced
axis and reduced in place: a gather and a dense reduction, both
deterministic on CUDA. ``index_add_`` and ``scatter_reduce`` would use
atomics there, so they stay off this path.
"""

from __future__ import annotations

from typing import Optional

import torch

# Empty segments take the JAX package's init values.
_INIT = {"max": -1e9, "sum": 0.0}


def sorted_segment_reduce(x: torch.Tensor, ptr: torch.Tensor, kind: str, *,
                          dim: int = 0,
                          max_len: Optional[int] = None) -> torch.Tensor:
    """Reduce ``x`` over consecutive segments along ``dim``.

    Segment ``s`` is ``x[ptr[s]:ptr[s+1]]`` along ``dim``. Returns a tensor
    with ``len(ptr) - 1`` entries along ``dim``; an empty segment gives
    -1e9 (``kind="max"``) or 0 (``kind="sum"``). ``max_len`` bounds the
    segment length; when it is None it is read from ``ptr`` (a device sync).
    """
    if kind not in _INIT:
        raise ValueError(f"kind must be 'max' or 'sum', got {kind!r}")
    dim = dim % x.dim()
    ptr = ptr.long()
    lo, hi = ptr[:-1], ptr[1:]
    n_seg = lo.shape[0]
    if max_len is None:
        max_len = int((hi - lo).max()) if n_seg else 0
    max_len = max(max_len, 1)
    ident = float("-inf") if kind == "max" else 0.0
    pad_shape = list(x.shape)
    pad_shape[dim] = 1
    xz = torch.cat([x, x.new_full(pad_shape, ident)], dim)
    idx = lo[:, None] + torch.arange(max_len, device=x.device)
    idx = torch.where(idx < hi[:, None], idx, x.shape[dim])
    g = xz.index_select(dim, idx.reshape(-1)).unflatten(dim, (n_seg, max_len))
    out = g.amax(dim + 1) if kind == "max" else g.sum(dim + 1)
    if kind == "max":
        empty = (hi == lo).reshape([n_seg] + [1] * (x.dim() - dim - 1))
        out = torch.where(empty, _INIT["max"], out)
    return out
