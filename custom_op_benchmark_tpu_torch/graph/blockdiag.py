"""Component-batched dense view: the layout for blocky graphs.

Counterpart of custom_op_benchmark_tpu/graph/blockdiag.py. Each connected
component is packed into one row block of a ``(B, L, ...)`` batch, so
every sparse op of the family becomes a batched dense product (masked
``einsum``/``bmm``, ops/dense_block.py) with no index gathers and no slot
padding past the largest component. The op layer takes this path when
:func:`block_graph` succeeds (every component has at most ``max_block``
nodes).

The host build is numpy, once per graph; the tensors then move to the
graph's device. Node and edge tensors enter and leave the layout through
four ``torch.autograd.Function`` s whose backward passes are the opposite
gathers (the reference's gather-only VJPs): ``node_slot``/``slot_node`` and
``edge_slot``/``slot_edge`` are inverse injections, so no direction needs
a scatter or an atomic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.autograd import Function

from custom_op_benchmark_tpu_torch.graph.graph import Graph
from custom_op_benchmark_tpu_torch.graph.reorder import connected_components


@dataclasses.dataclass(frozen=True)
class BlockGraph:
    """Dense component-batched view of a :class:`Graph`.

    Tensors (on the graph's device):
      node_slot: (n_nodes,) int64 — flat slot ``b·L + i`` of each node.
      slot_node: (B·L,) int64 — node id per slot (n_nodes for padding).
      adj:       (B, L, L) bool — within-block adjacency (src row, dst col).
      edge_slot: (E_pad,) int64 — canonical eid → flat slot
                 ``b·L² + r·L + c``; padded edges point at slot B·L²
                 (scratch).
      slot_edge: (B·L²,) int64 — canonical edge id per flat edge slot
                 (E_pad for empty slots).
      node_mask: (B, L) bool — real-node slots.
    """

    node_slot: torch.Tensor
    slot_node: torch.Tensor
    adj: torch.Tensor
    edge_slot: torch.Tensor
    slot_edge: torch.Tensor
    node_mask: torch.Tensor
    n_nodes: int
    n_edges: int
    num_blocks: int
    block_len: int

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def scatter_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """(n_nodes, ...) → (B, L, ...) block layout (pads zero)."""
        return _ScatterNodes.apply(self, x)

    def gather_nodes(self, xb: torch.Tensor) -> torch.Tensor:
        """(B, L, ...) → (n_nodes, ...)."""
        return _GatherNodes.apply(self, xb)

    def scatter_edges(self, ed: torch.Tensor) -> torch.Tensor:
        """(E, ...) canonical edge order → (B, L, L, ...) (pads zero)."""
        return _ScatterEdges.apply(self, ed)

    def gather_edges(self, eb: torch.Tensor) -> torch.Tensor:
        """(B, L, L, ...) → (E_pad, ...) canonical order (padded edges read
        the last slot, as in the reference)."""
        return _GatherEdges.apply(self, eb)


def _gather_padded(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with a zero row appended: indices at or past x's rows
    read zero."""
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz[idx.clamp(max=x.shape[0])]


class _ScatterNodes(Function):
    @staticmethod
    def forward(ctx, bg, x):
        ctx.bg = bg
        out = _gather_padded(x, bg.slot_node)
        return out.reshape((bg.num_blocks, bg.block_len) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, dy):
        flat = dy.reshape((-1,) + tuple(dy.shape[2:]))
        return None, flat[ctx.bg.node_slot]


class _GatherNodes(Function):
    @staticmethod
    def forward(ctx, bg, xb):
        ctx.bg = bg
        return xb.reshape((-1,) + tuple(xb.shape[2:]))[bg.node_slot]

    @staticmethod
    def backward(ctx, dy):
        bg = ctx.bg
        dxb = _gather_padded(dy, bg.slot_node)
        return None, dxb.reshape((bg.num_blocks, bg.block_len)
                                 + tuple(dy.shape[1:]))


class _ScatterEdges(Function):
    @staticmethod
    def forward(ctx, bg, ed):
        ctx.bg, ctx.e_pad = bg, ed.shape[0]
        out = _gather_padded(ed, bg.slot_edge)
        b, l = bg.num_blocks, bg.block_len
        return out.reshape((b, l, l) + tuple(ed.shape[1:]))

    @staticmethod
    def backward(ctx, dy):
        bg = ctx.bg
        flat = dy.reshape((-1,) + tuple(dy.shape[3:]))
        ded = _gather_padded(flat, bg.edge_slot)[: ctx.e_pad]
        return None, ded


class _GatherEdges(Function):
    @staticmethod
    def forward(ctx, bg, eb):
        ctx.bg = bg
        flat = eb.reshape((-1,) + tuple(eb.shape[3:]))
        return flat[bg.edge_slot.clamp(max=flat.shape[0] - 1)]

    @staticmethod
    def backward(ctx, dy):
        bg = ctx.bg
        b, l = bg.num_blocks, bg.block_len
        deb = _gather_padded(dy, bg.slot_edge)
        return None, deb.reshape((b, l, l) + tuple(dy.shape[1:]))


def block_graph(g: Graph, max_block: int = 128,
                block_len: Optional[int] = None) -> Optional[BlockGraph]:
    """Build the dense block view, or return None if ``g`` is not blocky.

    Succeeds when every weakly connected component has at most
    ``max_block`` nodes and no edge repeats (the dense view holds one value
    per (src, dst) pair); ``block_len`` defaults to the largest component.
    Components come from graph/reorder.connected_components (labelled by
    their smallest node id), in the order of their labels.
    """
    src = g.src.cpu().numpy()[: g.n_edges].astype(np.int64)
    dst = g.dst.cpu().numpy()[: g.n_edges].astype(np.int64)
    n, e = g.n_nodes, g.n_edges
    labels = connected_components(src, dst, n)
    _, comp_of, counts = np.unique(labels, return_inverse=True,
                                   return_counts=True)
    comp_of = comp_of.reshape(-1)
    if counts.size == 0 or counts.max() > max_block:
        return None
    l = int(block_len or counts.max())
    if counts.max() > l:
        return None
    b = len(counts)

    # Position of each node within its component (old-id order).
    order = np.argsort(comp_of, kind="stable")
    pos = np.empty(n, dtype=np.int64)
    starts = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos[order] = np.arange(n, dtype=np.int64) - starts[comp_of[order]]
    node_slot = comp_of * l + pos

    slot_node = np.full(b * l, n, dtype=np.int64)
    slot_node[node_slot] = np.arange(n, dtype=np.int64)
    node_mask = (slot_node < n).reshape(b, l)

    eb = comp_of[src]
    flat = eb * (l * l) + pos[src] * l + pos[dst]
    if len(np.unique(flat)) != e:
        return None  # a multigraph: the dense view cannot hold it
    adj = np.zeros(b * l * l, dtype=bool)
    adj[flat] = True

    e_pad = g.num_edges_padded
    edge_slot = np.full(e_pad, b * l * l, dtype=np.int64)
    edge_slot[:e] = flat
    slot_edge = np.full(b * l * l, e_pad, dtype=np.int64)
    slot_edge[flat] = np.arange(e, dtype=np.int64)

    def t(a):
        return torch.from_numpy(a).to(g.device)

    return BlockGraph(node_slot=t(node_slot), slot_node=t(slot_node),
                      adj=t(adj.reshape(b, l, l)), edge_slot=t(edge_slot),
                      slot_edge=t(slot_edge), node_mask=t(node_mask),
                      n_nodes=n, n_edges=e, num_blocks=b, block_len=l)
