"""Graph Convolutional Network (symmetric-normalised aggregation).

Counterpart of custom_op_benchmark_tpu/models/gcn.py. The neighbour sum runs
on the segment path (``gspmm`` copy_lhs), given ``ell`` on the ELL
copy-SpMM, whose forward and backward are the CUDA kernel S3, or given
``block`` on ``block_copy_spmm`` with the whole stack in the ``(B, L, ·)``
layout (degrees from the block adjacency), as in the reference. The model
follows its input's dtype as flax does (no ``dtype`` field): ``W``
computes in the promoted type of x and its f32 weight, so bf16 features
give f32 activations.
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


class GCNLayer(nn.Module):
    """h' = D̂^{-1/2} Â D̂^{-1/2} h W, aggregated over in-edges."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 device=None):
        super().__init__()
        self.W = nn.Linear(in_dim, out_dim, bias=False, device=device)
        self.b = (nn.Parameter(torch.zeros(out_dim, device=device))
                  if use_bias else None)

    def forward(self, g, x, *, ell=None, block=None):
        z = dense(self.W, x)
        if block is not None:
            # Whole-stack layout: x is (B, L, F).
            deg_out = block.adj.sum(dim=2).to(z.dtype).clamp(min=1.0)
            deg_in = block.adj.sum(dim=1).to(z.dtype).clamp(min=1.0)
            z = z * torch.rsqrt(deg_out)[..., None]
            out = block_copy_spmm(block, z, reduce="sum")
            out = out * torch.rsqrt(deg_in)[..., None]
            return out if self.b is None else out + self.b
        deg_out = g.out_degrees().to(z.dtype).clamp(min=1.0)
        deg_in = g.in_degrees().to(z.dtype).clamp(min=1.0)
        z = z * torch.rsqrt(deg_out)[:, None]
        if ell is not None:
            src_ell, dst_ell = ell
            out = ell_copy_spmm(dst_ell, src_ell, z, reduce="sum")
        else:
            out = gspmm(g, "copy_lhs", "sum", lhs=z, lhs_target="u",
                        to="dst")
        out = out * torch.rsqrt(deg_in)[:, None]
        return out if self.b is None else out + self.b


class GCN(nn.Module):
    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int = 2,
                 dropout_rate: float = 0.0, *, in_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            GCNLayer(a, b, device=device) for a, b in zip(dims, dims[1:]))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)

    def forward(self, g, x, *, ell=None, block=None):
        if block is not None:   # whole-stack (B, L, ·) layout
            x = block.scatter_nodes(x)
        for layer in self.layers[:-1]:
            x = F.relu(layer(g, x, ell=ell, block=block))
            if self.dropout_rate > 0.0:
                x = F.dropout(x, self.dropout_rate, training=self.training)
        x = self.layers[-1](g, x, ell=ell, block=block)
        return block.gather_nodes(x) if block is not None else x
