"""Graph Attention Network (GAT) on the sparse op family.

Counterpart of custom_op_benchmark_tpu/models/gat.py. A layer scores each
edge with additive attention, takes the edge softmax over the in-edges of
its dst and aggregates: on the segment path through
``softmax_aggregate_dst``, on the ELL path through the fused
``ell_gat_attention`` (ops/ell.py), on the dense-block path through
``block_gat_attention`` (ops/dense_block.py), with the whole stack in the
``(B, L, ·)`` layout (scatter once, gather once). The ELL and block paths
are taken exactly when the reference takes them: the view is given and
there is no dropout to apply (``dropout_rate == 0`` or the module is in
eval mode, the reference's ``deterministic``).

Parameters start as flax's defaults do (LeCun-normal ``W`` and ``W_res``,
Glorot-uniform attention vectors), drawn from ``generator``; the flax
parameter tree converts with ``models.convert.flax_to_state_dict``.

``dtype`` is the reference's mixed precision: parameters stay
``param_dtype`` (f32), while ``W``'s product, the attention vectors and the
z tensor (and so every gathered tile of the fused ops) run at ``dtype``,
with f32 sums inside the ops; the stack returns its logits in f32. It
holds on all three paths.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from custom_op_benchmark_tpu_torch.models.flax_init import flax_init_
from custom_op_benchmark_tpu_torch.models.precision import dense
from custom_op_benchmark_tpu_torch.ops import (
    block_gat_attention,
    ell_gat_attention,
    softmax_aggregate_dst,
)
from custom_op_benchmark_tpu_torch.ops.xla import gather_rows


def attend(g, z, a_l, a_r, *, ell=None, negative_slope: float = 0.2,
           dropout_fn=None):
    """A GAT layer's attention on z (n, h, d): ``out[v] = Σ α·z[u]`` with α
    the softmax over the in-edges of v of ``LeakyReLU(a_l·z[u] +
    a_r·z[v])``; ``a_r`` None leaves the dst term out. On the ELL view
    ``ell`` (``(src_ell, dst_ell)``) the fused ``ell_gat_attention``;
    without it the segment path, whose α ``dropout_fn`` may drop."""
    if ell is not None:
        src_ell, dst_ell = ell
        return ell_gat_attention(dst_ell, src_ell, a_l, a_r, z,
                                 negative_slope=negative_slope)
    # Padded edge endpoints clamp; their scores are masked. The gathers'
    # VJP is a sorted segment sum (no atomics).
    scores = gather_rows(g, torch.einsum("nhd,hd->nh", z, a_l), "src")
    if a_r is not None:
        scores = scores + gather_rows(
            g, torch.einsum("nhd,hd->nh", z, a_r), "dst")
    scores = F.leaky_relu(scores, negative_slope)
    return softmax_aggregate_dst(g, scores, z, dropout_fn=dropout_fn)


class GATLayer(nn.Module):
    """One multi-head GAT layer (additive attention, LeakyReLU scores).

    score[e, h] = LeakyReLU(a_l·Wx[src] + a_r·Wx[dst]); α = edge softmax
    over the in-edges of dst; out[v] = Σ α·Wx[src].
    """

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1,
                 negative_slope: float = 0.2, concat_heads: bool = True,
                 residual: bool = False, dropout_rate: float = 0.0,
                 param_dtype: torch.dtype = torch.float32,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        h, d = num_heads, out_dim
        self.num_heads, self.out_dim = h, d
        self.negative_slope = negative_slope
        self.concat_heads = concat_heads
        self.residual = residual
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        pk = dict(device=device, dtype=param_dtype)
        self.W = nn.Linear(in_dim, h * d, bias=False, **pk)
        self.a_l = nn.Parameter(torch.empty(h, d, **pk))
        self.a_r = nn.Parameter(torch.empty(h, d, **pk))
        # flax creates W_res only when the widths differ.
        self.W_res = (nn.Linear(in_dim, h * d, bias=False, **pk)
                      if residual and in_dim != h * d else None)
        flax_init_(self)

    def _deterministic(self) -> bool:
        return self.dropout_rate == 0.0 or not self.training

    def _residual(self, x):
        return x if self.W_res is None else dense(self.W_res, x, self.dtype)

    def forward(self, g, x, *, ell=None, block=None):
        h, d = self.num_heads, self.out_dim
        a_l, a_r = self.a_l, self.a_r
        if self.dtype is not None:
            a_l, a_r = a_l.to(self.dtype), a_r.to(self.dtype)
        if block is not None and self._deterministic():
            # Whole-stack layout: x arrives as (B, L, F).
            lead = tuple(x.shape[:2])
            z = dense(self.W, x, self.dtype).reshape(lead + (h, d))
            out = block_gat_attention(block, a_l, a_r, z,
                                      negative_slope=self.negative_slope)
            if self.residual:
                out = out + self._residual(x).reshape(lead + (h, d))
            if self.concat_heads:
                return out.reshape(lead + (h * d,))
            return out.mean(-2)
        n = x.shape[0]
        z = dense(self.W, x, self.dtype).reshape(n, h, d)
        dropout_fn = None
        if not self._deterministic():
            p = self.dropout_rate

            def dropout_fn(a):
                return F.dropout(a, p, training=True)
        out = attend(g, z, a_l, a_r, ell=ell if dropout_fn is None else None,
                     negative_slope=self.negative_slope,
                     dropout_fn=dropout_fn)
        if self.residual:
            out = out + self._residual(x).reshape(n, h, d)
        if self.concat_heads:
            return out.reshape(n, h * d)
        return out.mean(1)


class GAT(nn.Module):
    """A GAT stack for node classification (ELU between layers).

    ``remat=True`` checkpoints each hidden layer
    (``torch.utils.checkpoint``, non-reentrant): its activations are
    recomputed in the backward instead of living until it. ``in_dim`` is
    the width of the node features. ``dtype`` (e.g. ``torch.bfloat16``)
    runs every layer at that width with f32 parameters and returns f32
    logits.
    """

    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int = 2,
                 num_heads: int = 8, dropout_rate: float = 0.0,
                 remat: bool = False, dtype: Optional[torch.dtype] = None, *,
                 in_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.remat = remat
        self.dtype = dtype
        width = hidden_dim * num_heads
        self.layers = nn.ModuleList(
            GATLayer(in_dim if i == 0 else width, hidden_dim, num_heads,
                     dropout_rate=dropout_rate, residual=i > 0, dtype=dtype,
                     device=device)
            for i in range(num_layers - 1))
        self.layers.append(GATLayer(in_dim if num_layers == 1 else width,
                                    out_dim, num_heads=1, concat_heads=False,
                                    dtype=dtype, device=device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)

    def forward(self, g, x, *, ell=None, block=None):
        # Dense-block whole-stack layout: scatter once, run every layer in
        # (B, L, ·), gather once.
        block_layout = block is not None and (self.dropout_rate == 0.0
                                              or not self.training)
        blk = block if block_layout else None
        if block_layout:
            x = block.scatter_nodes(x)
        for i, layer in enumerate(self.layers[:-1]):
            if self.remat:
                x = checkpoint(layer, g, x, ell=ell, block=blk,
                               use_reentrant=False)
            else:
                x = layer(g, x, ell=ell, block=blk)
            x = self._between(i, x)
        out = self.layers[-1](g, x, ell=ell, block=blk)
        if block_layout:
            out = block.gather_nodes(out)
        return self._output(out)

    def _between(self, i: int, x):
        """What follows hidden layer ``i``: ELU, then dropout."""
        x = F.elu(x)
        if self.dropout_rate > 0.0:
            x = F.dropout(x, self.dropout_rate, training=self.training)
        return x

    def _output(self, out):
        """The logits from the last layer's output."""
        return out.float() if self.dtype is not None else out
