"""Row chunking and edge partitioning of graphs (host-side numpy).

Counterpart of custom_op_benchmark_tpu/graph/partition.py:

- :func:`partition_csr` keeps the contract of the reference's row-chunking
  preprocessor (part_csr.py:13-27): every CSR row split into chunks of at
  most ``chunk_size`` edges, with an owner row per chunk;
- :func:`edge_block_rows` gives the first row each fixed-size block of
  row-sorted edges touches (blocks may share boundary rows);
- :func:`edge_partition` splits the canonical edge list into ``P``
  contiguous, equally padded shards, each with the range of src rows it
  touches, the data layout of the edge-partitioned multi-device plans.

Everything is numpy on the host; the native row chunker
(``native.partition_csr_native``) gives the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from custom_op_benchmark_tpu_torch.graph.graph import Graph, _round_up


def partition_csr(indptr,
                  chunk_size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Split CSR rows into chunks of at most ``chunk_size`` edges: returns
    ``(row, chunk_indptr)``, where chunk ``i`` owns edges
    ``chunk_indptr[i]:chunk_indptr[i+1]`` of row ``row[i]``."""
    indptr = np.asarray(indptr)
    deg = np.diff(indptr).astype(np.int64)
    n_chunks_per_row = np.maximum((deg + chunk_size - 1) // chunk_size, 0)
    total = int(n_chunks_per_row.sum())
    row = np.repeat(np.arange(len(deg), dtype=np.int32), n_chunks_per_row)
    # Offsets of each chunk inside its row: 0, cs, 2cs, ...
    first_chunk = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(n_chunks_per_row, out=first_chunk[1:])
    within = np.arange(total, dtype=np.int64) - first_chunk[row]
    starts = indptr[:-1][row] + within * chunk_size
    ends = np.minimum(starts + chunk_size, indptr[1:][row])
    chunk_indptr = np.empty(total + 1, dtype=np.int32)
    chunk_indptr[0] = indptr[0]
    chunk_indptr[1:] = ends
    if not np.array_equal(starts, chunk_indptr[:-1]):
        raise ValueError("indptr must be non-decreasing (rows contiguous)")
    return row, chunk_indptr


def edge_block_rows(indptr, block_size: int) -> np.ndarray:
    """First row touched by each fixed-size edge block: block ``b`` covers
    edges ``[b·block_size, (b+1)·block_size)`` and rows
    ``[first[b], first[b+1]]`` (inclusive; blocks may share a boundary
    row)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    e = int(indptr[-1])
    n_blocks = max(1, -(-e // block_size))
    starts = np.minimum(np.arange(n_blocks + 1, dtype=np.int64) * block_size,
                        e)
    # The last row r with indptr[r] <= start, clamped to a real row (the
    # end sentinel would otherwise land past the last row).
    first = np.searchsorted(indptr, starts, side="right") - 1
    return np.minimum(first, len(indptr) - 2).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """Host-side plan for sharding a graph's edges over ``P`` devices.

    Each shard holds an equal (padded) count of canonically contiguous
    edges; since the canonical order is row-sorted, each shard's src rows
    form a contiguous range ``[row_lo[p], row_hi[p]]`` and only rows shared
    by neighbouring shards need a cross-device reduction.

    src, dst: (P, edges_per_part) int32, padded entries ``n_nodes``.
    eid:      (P, edges_per_part) int32 canonical edge id, padding
              ``n_edges``.
    row_lo, row_hi: (P,) first and last src row a shard touches
              (``n_nodes`` for an empty shard).
    """

    num_parts: int
    edges_per_part: int
    src: np.ndarray
    dst: np.ndarray
    eid: np.ndarray
    row_lo: np.ndarray
    row_hi: np.ndarray
    n_nodes: int
    n_edges: int


def edge_partition(g: Graph, num_parts: int,
                   pad_multiple: int = 8) -> EdgePartition:
    """Split ``g``'s canonical edge list into ``num_parts`` contiguous
    shards of equal padded size; the first ``E mod P`` shards hold one
    edge more than the rest."""
    src = g.src.cpu().numpy()[: g.n_edges]
    dst = g.dst.cpu().numpy()[: g.n_edges]
    e = g.n_edges
    per = _round_up(max(-(-e // num_parts), 1), pad_multiple)
    src_s = np.full((num_parts, per), g.n_nodes, dtype=np.int32)
    dst_s = np.full((num_parts, per), g.n_nodes, dtype=np.int32)
    eid_s = np.full((num_parts, per), e, dtype=np.int32)
    row_lo = np.zeros(num_parts, dtype=np.int32)
    row_hi = np.zeros(num_parts, dtype=np.int32)
    for p in range(num_parts):
        lo = min(p * (e // num_parts) + min(p, e % num_parts), e)
        hi = min(lo + e // num_parts + (1 if p < e % num_parts else 0), e)
        cnt = hi - lo
        src_s[p, :cnt] = src[lo:hi]
        dst_s[p, :cnt] = dst[lo:hi]
        eid_s[p, :cnt] = np.arange(lo, hi, dtype=np.int32)
        row_lo[p] = src[lo] if cnt else g.n_nodes
        row_hi[p] = src[hi - 1] if cnt else g.n_nodes
    return EdgePartition(num_parts=num_parts, edges_per_part=per,
                         src=src_s, dst=dst_s, eid=eid_s, row_lo=row_lo,
                         row_hi=row_hi, n_nodes=g.n_nodes, n_edges=e)
