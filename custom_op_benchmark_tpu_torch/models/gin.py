"""Graph Isomorphism Network (sum aggregator + MLP).

Counterpart of custom_op_benchmark_tpu/models/gin.py. A layer computes
h'_v = MLP((1 + eps)·h_v + Σ_{u→v} h_u) with a learned scalar ``eps``
(starting at 0). The neighbour sum runs on the segment path through
``gspmm`` (copy_lhs, sum), on the ELL path through ``ell_copy_spmm`` (the
kernel S3, one launch over all buckets of a packing), and on the
dense-block path through ``block_copy_spmm`` with the whole stack in the
``(B, L, ·)`` layout (scatter once, gather once).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from custom_op_benchmark_tpu_torch.models.flax_init import flax_init_
from custom_op_benchmark_tpu_torch.ops import (
    block_copy_spmm,
    ell_copy_spmm,
    gspmm,
)


class GINLayer(nn.Module):
    """h'_v = MLP((1 + eps)·h_v + Σ_{u→v} h_u); the MLP is Dense → ReLU →
    Dense, ``hidden_dim`` wide (default: ``out_dim``)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 0, *,
                 device=None):
        super().__init__()
        hidden = hidden_dim or out_dim
        self.eps = nn.Parameter(torch.zeros((), device=device))
        self.mlp1 = nn.Linear(in_dim, hidden, device=device)
        self.mlp2 = nn.Linear(hidden, out_dim, device=device)

    def forward(self, g, x, *, ell=None, block=None):
        if block is not None:       # x arrives as (B, L, F)
            neigh = block_copy_spmm(block, x, reduce="sum")
        elif ell is not None:
            src_ell, dst_ell = ell
            neigh = ell_copy_spmm(dst_ell, src_ell, x, reduce="sum")
        else:
            neigh = gspmm(g, "copy_lhs", "sum", lhs=x, lhs_target="u",
                          to="dst")
        h = (1.0 + self.eps) * x + neigh
        return self.mlp2(F.relu(self.mlp1(h)))


class GIN(nn.Module):
    """A GIN stack (ReLU between layers); ``in_dim`` is the width of the
    node features. Parameters start as flax's defaults do (LeCun-normal
    weights, zero biases, ``eps`` 0), drawn from ``generator``."""

    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int = 2, *,
                 in_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            GINLayer(widths[i], widths[i + 1], device=device)
            for i in range(num_layers))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)

    def forward(self, g, x, *, ell=None, block=None):
        if block is not None:
            x = block.scatter_nodes(x)
        for layer in self.layers[:-1]:
            x = F.relu(layer(g, x, ell=ell, block=block))
        x = self.layers[-1](g, x, ell=ell, block=block)
        return block.gather_nodes(x) if block is not None else x
