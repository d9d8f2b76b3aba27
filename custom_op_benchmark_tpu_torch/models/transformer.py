"""Masked graph transformer: dot-product attention restricted to edges.

Counterpart of custom_op_benchmark_tpu/models/transformer.py, on all its
paths, taken in the reference's order: with ``ell=`` the fused ELL
attention (or with edge features the fused ``ell_edge_bias_attention``,
ops/ell.py); with ``block=`` and no edge features the dense-block
attention (ops/dense_block.py), by default with the whole stack in the
``(B, L, ·)`` layout; with ``tiled=`` and no edge features the fused tile
kernel K4, and its gradient the K1–K3 recompute; else the segment path
(``sddmm``, ``node_mul_edge`` with edge features, and
``softmax_aggregate_dst``). Layer for layer it matches the flax module,
including flax's defaults: LayerNorm with eps 1e-6 and GELU in its tanh
approximation (torch defaults to eps 1e-5 and the exact GELU).

``dtype`` is the reference's mixed precision on every path: parameters
stay f32; every dense layer computes at ``dtype``, each layer norm in f32
with its output rounded to ``dtype`` (flax's rules, models/precision.py),
the attention ops take ``dtype`` operands (bf16 K1–K4 on ``tiled=``, the
ELL ops' f32 sums on ``ell=``), and the logits return in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from custom_op_benchmark_tpu_torch.models.flax_init import flax_init_
from custom_op_benchmark_tpu_torch.models.precision import dense, layer_norm
from custom_op_benchmark_tpu_torch.ops import (
    block_attention,
    node_mul_edge,
    sddmm,
    softmax_aggregate_dst,
)
from custom_op_benchmark_tpu_torch.ops.ell import (
    ell_attention,
    ell_edge_bias_attention,
)
from custom_op_benchmark_tpu_torch.ops.tiled import tiled_attention

LN_EPS = 1e-6        # flax.linen.LayerNorm's default epsilon
GELU_APPROX = "tanh"  # flax.linen.gelu's default approximation


class GraphMultiHeadAttention(nn.Module):
    """Multi-head dot-product attention over graph edges.

    scores[e, h] = <Q[dst], K[src]>/√d (+ <Q[src], E[e]>/√d with edge
    features), α = softmax over the in-edges of dst, out[v] =
    Σ_{e=(u,v)} α[e]·V[u]. With ``block_layout`` x arrives already in the
    ``(B, L, D)`` block layout (the whole-stack pass) and stays there.
    """

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dtype = dtype
        inner = num_heads * head_dim
        self.Wq = nn.Linear(dim, inner, bias=False, device=device)
        self.Wk = nn.Linear(dim, inner, bias=False, device=device)
        self.Wv = nn.Linear(dim, inner, bias=False, device=device)
        self.Wo = nn.Linear(inner, dim, device=device)

    def forward(self, g, x, edge_feat=None, *, tiled=None, block=None,
                ell=None, block_layout: bool = False):
        h, d, dt = self.num_heads, self.head_dim, self.dtype
        lead = tuple(x.shape[:-1])     # (n,) or, in the block layout, (B, L)
        q = dense(self.Wq, x, dt).reshape(lead + (h, d))
        k = dense(self.Wk, x, dt).reshape(lead + (h, d))
        v = dense(self.Wv, x, dt).reshape(lead + (h, d))
        if block_layout:
            if block is None or edge_feat is not None:
                raise ValueError("block_layout needs block= and no edge "
                                 "features")
            out = block_attention(block, q, k, v, normalize="dst")
        elif ell is not None:
            src_ell, dst_ell = ell
            if edge_feat is None:
                out = ell_attention(dst_ell, src_ell, q, k, v)
            else:
                out = ell_edge_bias_attention(dst_ell, src_ell, q, k, v,
                                              edge_feat)
        elif block is not None and edge_feat is None:
            # Per-layer scatter/gather at the attention's boundary.
            out = block.gather_nodes(block_attention(
                block, block.scatter_nodes(q), block.scatter_nodes(k),
                block.scatter_nodes(v), normalize="dst"))
        elif tiled is not None and edge_feat is None:
            out = tiled_attention(tiled, q, k, v, normalize="dst")
        else:
            scores = sddmm(g, k, q)    # <K[src], Q[dst]> per edge
            if edge_feat is not None:
                scores = scores + node_mul_edge(g, q, edge_feat)
            out = softmax_aggregate_dst(g, scores / math.sqrt(d), v)
        return dense(self.Wo, out.reshape(lead + (h * d,)), dt)


class GraphTransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_dim: int,
                 dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = GraphMultiHeadAttention(dim, num_heads, head_dim, dtype,
                                            device=device)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp1 = nn.Linear(dim, mlp_dim, device=device)
        self.mlp2 = nn.Linear(mlp_dim, dim, device=device)

    def _dropout(self, y):
        if self.dropout_rate > 0.0:
            return F.dropout(y, self.dropout_rate, training=self.training)
        return y

    def forward(self, g, x, edge_feat=None, *, tiled=None, block=None,
                ell=None, block_layout: bool = False):
        dt = self.dtype
        y = self.attn(g, layer_norm(self.ln1, x, dt), edge_feat, tiled=tiled,
                      block=block, ell=ell, block_layout=block_layout)
        x = x + self._dropout(y)
        y = dense(self.mlp1, layer_norm(self.ln2, x, dt), dt)
        y = dense(self.mlp2, F.gelu(y, approximate=GELU_APPROX), dt)
        return x + self._dropout(y)


class GraphTransformer(nn.Module):
    """A stack of masked-attention transformer layers over a graph.

    ``in_dim`` is the width of the node features; when it differs from
    ``dim`` a ``proj_in`` layer maps them (flax infers this from the first
    input). Parameters start as flax's defaults do (LeCun-normal weights,
    zero biases, unit LayerNorm scales), drawn from ``generator``.

    ``dropout_rate`` drops after the attention and after the MLP, in
    training mode only (the reference's ``deterministic=False``).
    ``remat=True`` checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant, with the RNG state kept so dropout draws the same mask
    on the recompute). ``block_whole_stack`` (with ``block=`` and no edge
    features) scatters once to the ``(B, L, D)`` layout at the stack's
    entry and gathers once before ``ln_out``; padded slots carry finite
    values that the adjacency mask and the final gather discard. False
    scatters and gathers at every layer's attention, as an A/B. ``dtype``
    (e.g. ``torch.bfloat16``) runs the activations at that width with f32
    parameters and returns f32 logits.
    """

    def __init__(self, dim: int, num_heads: int, num_layers: int,
                 mlp_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 dropout_rate: float = 0.0, remat: bool = False, dtype=None,
                 block_whole_stack: bool = True, *,
                 in_dim: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.remat = remat
        self.block_whole_stack = block_whole_stack
        self.proj_in = (nn.Linear(in_dim, dim, device=device)
                        if in_dim is not None and in_dim != dim else None)
        head_dim = dim // num_heads
        self.layers = nn.ModuleList(
            GraphTransformerLayer(dim, num_heads, head_dim, mlp_dim or 4 * dim,
                                  dropout_rate, dtype, device=device)
            for _ in range(num_layers))
        self.ln_out = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.proj_out = (nn.Linear(dim, out_dim, device=device)
                         if out_dim is not None else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)

    def forward(self, g, x, edge_feat=None, *, tiled=None, block=None,
                ell=None):
        block_layout = (block is not None and edge_feat is None
                        and self.block_whole_stack)
        if block_layout:
            x = block.scatter_nodes(x)
        if self.proj_in is not None:
            x = dense(self.proj_in, x, self.dtype)
        elif x.shape[-1] != self.dim:
            raise ValueError(f"features are {x.shape[-1]} wide; build the "
                             f"model with in_dim={x.shape[-1]}")
        views = dict(tiled=tiled, block=block, ell=ell,
                     block_layout=block_layout)
        for layer in self.layers:
            if self.remat:
                x = checkpoint(layer, g, x, edge_feat, use_reentrant=False,
                               **views)
            else:
                x = layer(g, x, edge_feat, **views)
        if block_layout:
            x = block.gather_nodes(x)
        x = layer_norm(self.ln_out, x, self.dtype)
        if self.proj_out is not None:
            x = dense(self.proj_out, x, self.dtype)
        return x.float() if self.dtype is not None else x
