"""The core Graph container: canonical edge order + dual CSR/CSC views.

Same layout as the JAX package's ``Graph`` (custom_op_benchmark_tpu/graph/
graph.py), held as torch tensors:

- the canonical edge order is row-sorted, by ``(src, dst)``;
- ``csc_perm[k]`` is the canonical id of the k-th edge in column-sorted
  order, and ``csc_perm_inv`` its inverse;
- indices are int32;
- edge arrays may be padded; padded edges point at the dummy node
  ``n_nodes``, so ``indptr_r``/``indptr_c`` have ``n_nodes + 2`` entries.

Everything is built on the host with numpy and then moved to ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """A directed graph in canonical (row-sorted) edge order.

    Tensors (int32, on one device):
      src, dst:      (E,) endpoints in canonical order; padded tail = n_nodes.
      indptr_r:      (n_nodes + 2,) CSR row pointers over canonical order.
      csc_perm:      (E,) canonical eid of the k-th edge in CSC order.
      csc_perm_inv:  (E,) CSC position of canonical edge e.
      indptr_c:      (n_nodes + 2,) CSC column pointers.
    """

    src: torch.Tensor
    dst: torch.Tensor
    indptr_r: torch.Tensor
    csc_perm: torch.Tensor
    csc_perm_inv: torch.Tensor
    indptr_c: torch.Tensor
    n_nodes: int
    n_edges: int

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_edges_padded(self) -> int:
        return self.src.shape[0]

    @property
    def edge_mask(self) -> torch.Tensor:
        """(E,) bool — True on real edges, False on the padded tail."""
        return torch.arange(self.num_edges_padded,
                            device=self.device) < self.n_edges

    @property
    def src_csc(self) -> torch.Tensor:
        return self.src[self.csc_perm.long()]

    @property
    def dst_csc(self) -> torch.Tensor:
        return self.dst[self.csc_perm.long()]

    def out_degrees(self) -> torch.Tensor:
        return torch.diff(self.indptr_r)[: self.n_nodes]

    def in_degrees(self) -> torch.Tensor:
        return torch.diff(self.indptr_c)[: self.n_nodes]

    def reverse(self) -> "Graph":
        """The transpose graph, sharing this graph's canonical edge ids.

        Its canonical order is this graph's CSC order, so edge data indexed
        by this graph's eids must be permuted by ``csc_perm`` to use it.
        """
        return Graph(
            src=self.dst_csc,
            dst=self.src_csc,
            indptr_r=self.indptr_c,
            csc_perm=self.csc_perm_inv,
            csc_perm_inv=self.csc_perm,
            indptr_c=self.indptr_r,
            n_nodes=self.n_nodes,
            n_edges=self.n_edges,
        )

    def __repr__(self) -> str:
        return (f"Graph(n_nodes={self.n_nodes}, n_edges={self.n_edges}, "
                f"padded_to={self.num_edges_padded})")


def from_coo(src, dst, n_nodes: int, *, pad_multiple: Optional[int] = None,
             pad_to: Optional[int] = None, device=None) -> Graph:
    """Build a :class:`Graph` from COO edge arrays (host-side numpy).

    Duplicate edges are kept (multigraph semantics). ``pad_multiple`` pads
    the edge arrays to a multiple of it, ``pad_to`` to exactly that length.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.ndim != 1 or dst.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src/dst must be equal-length 1-D, got "
                         f"{src.shape} vs {dst.shape}")
    e = int(src.shape[0])
    if e and (src.min() < 0 or src.max() >= n_nodes
              or dst.min() < 0 or dst.max() >= n_nodes):
        raise ValueError("edge endpoints out of range [0, n_nodes)")

    e_pad = e
    if pad_to is not None:
        if pad_to < e:
            raise ValueError(f"pad_to={pad_to} < n_edges={e}")
        e_pad = pad_to
    if pad_multiple is not None:
        e_pad = _round_up(max(e_pad, 1), pad_multiple)

    order = np.lexsort((dst, src))
    src_c = src[order].astype(np.int32)
    dst_c = dst[order].astype(np.int32)
    if e_pad != e:
        fill = np.full(e_pad - e, n_nodes, dtype=np.int32)
        src_c = np.concatenate([src_c, fill])
        dst_c = np.concatenate([dst_c, fill])

    # Stable sort by dst: padding (dst == n_nodes) stays at the tail.
    csc_perm = np.argsort(dst_c, kind="stable").astype(np.int32)
    csc_perm_inv = np.empty_like(csc_perm)
    csc_perm_inv[csc_perm] = np.arange(e_pad, dtype=np.int32)

    indptr_r = np.zeros(n_nodes + 2, dtype=np.int32)
    np.cumsum(np.bincount(src_c, minlength=n_nodes + 1), out=indptr_r[1:])
    indptr_c = np.zeros(n_nodes + 2, dtype=np.int32)
    np.cumsum(np.bincount(dst_c[csc_perm], minlength=n_nodes + 1),
              out=indptr_c[1:])

    def t(a):
        return torch.from_numpy(a).to(device)

    return Graph(
        src=t(src_c), dst=t(dst_c), indptr_r=t(indptr_r),
        csc_perm=t(csc_perm), csc_perm_inv=t(csc_perm_inv),
        indptr_c=t(indptr_c), n_nodes=int(n_nodes), n_edges=e,
    )
