"""GraphSAGE (mean aggregator).

Counterpart of custom_op_benchmark_tpu/models/sage.py, full-graph: the
neighbour mean runs on the segment path (``gspmm`` copy_lhs, mean), given
``ell`` on the ELL copy-SpMM, whose forward and backward are the CUDA
kernel S3, given ``block`` on ``block_copy_spmm`` with the whole stack in
the ``(B, L, ·)`` layout, or given ``in_cols`` (a sampled minibatch's
in-neighbour matrix) on ``sampled_copy_spmm``: S3 forward, its CSR entry
backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from custom_op_benchmark_tpu_torch.models.flax_init import flax_init_
from custom_op_benchmark_tpu_torch.models.precision import dense
from custom_op_benchmark_tpu_torch.ops import (
    block_copy_spmm,
    ell_copy_spmm,
    gspmm,
)
from custom_op_benchmark_tpu_torch.ops.sampled import sampled_copy_spmm


class SAGELayer(nn.Module):
    """h'_v = W_self·h_v + W_neigh·mean_{u→v} h_u."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.W_self = nn.Linear(in_dim, out_dim, device=device)
        self.W_neigh = nn.Linear(in_dim, out_dim, bias=False, device=device)

    def forward(self, g, x, *, ell=None, in_cols=None, block=None):
        if block is not None:
            neigh = block_copy_spmm(block, x, reduce="mean")
        elif in_cols is not None:
            neigh = sampled_copy_spmm(in_cols, g, x, reduce="mean")
        elif ell is not None:
            src_ell, dst_ell = ell
            neigh = ell_copy_spmm(dst_ell, src_ell, x, reduce="mean")
        else:
            neigh = gspmm(g, "copy_lhs", "mean", lhs=x, lhs_target="u",
                          to="dst")
        return dense(self.W_self, x) + dense(self.W_neigh, neigh)


class GraphSAGE(nn.Module):
    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int = 2,
                 dropout_rate: float = 0.0, *, in_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            SAGELayer(a, b, device=device) for a, b in zip(dims, dims[1:]))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)

    def forward(self, g, x, *, ell=None, in_cols=None, block=None):
        if block is not None:   # whole-stack (B, L, ·) layout
            x = block.scatter_nodes(x)
        for layer in self.layers[:-1]:
            x = F.relu(layer(g, x, ell=ell, in_cols=in_cols, block=block))
            if self.dropout_rate > 0.0:
                x = F.dropout(x, self.dropout_rate, training=self.training)
        x = self.layers[-1](g, x, ell=ell, in_cols=in_cols, block=block)
        return block.gather_nodes(x) if block is not None else x
