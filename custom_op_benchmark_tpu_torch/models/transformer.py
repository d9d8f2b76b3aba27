"""Masked graph transformer: dot-product attention restricted to edges.

Counterpart of custom_op_benchmark_tpu/models/transformer.py, on its
``tiled=`` and ``ell=`` paths: on the tile path every layer's attention is
the fused tile kernel K4, and its gradient the K1–K3 recompute; on the ELL
path it is ``ell_attention``, or with edge features the fused
``ell_edge_bias_attention`` (ops/ell.py). Layer for layer it matches the
flax module, including flax's defaults: LayerNorm with eps 1e-6 and GELU
in its tanh approximation (torch defaults to eps 1e-5 and the exact GELU).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from custom_op_benchmark_tpu_torch.models.flax_init import flax_init_
from custom_op_benchmark_tpu_torch.ops.ell import (
    ell_attention,
    ell_edge_bias_attention,
)
from custom_op_benchmark_tpu_torch.ops.tiled import tiled_attention

LN_EPS = 1e-6        # flax.linen.LayerNorm's default epsilon
GELU_APPROX = "tanh"  # flax.linen.gelu's default approximation


def _refuse_unported(tiled, edge_feat, block) -> None:
    """Without ``ell``, the reference takes the dense-block path, then the
    tile path, then the segment path; the port has the tile path only."""
    if edge_feat is not None:
        raise NotImplementedError(
            "edge features run on the ell= path here; the transformer's "
            "segment path is not ported yet (ROADMAP M9)")
    if block is not None:
        raise NotImplementedError(
            "the transformer's block= path and block_whole_stack are not "
            "ported yet (ROADMAP M9)")
    if tiled is None:
        raise NotImplementedError(
            "the transformer's segment path is not ported yet (ROADMAP "
            "M9); pass tiled=tile_graph(g) or ell=ell_dual(g)")


class GraphMultiHeadAttention(nn.Module):
    """Multi-head dot-product attention over graph edges.

    scores[e, h] = <Q[dst], K[src]>/√d (+ <Q[src], E[e]>/√d with edge
    features), α = softmax over the in-edges of dst, out[v] =
    Σ_{e=(u,v)} α[e]·V[u]: with ``ell`` (the ``(src, dst)`` pair of
    ``ell_dual``) the fused ELL attention over the dst packing, else the
    fused tile kernel on the transposed tiling.
    """

    def __init__(self, dim: int, num_heads: int, head_dim: int, *,
                 device=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.Wq = nn.Linear(dim, inner, bias=False, device=device)
        self.Wk = nn.Linear(dim, inner, bias=False, device=device)
        self.Wv = nn.Linear(dim, inner, bias=False, device=device)
        self.Wo = nn.Linear(inner, dim, device=device)

    def forward(self, g, x, edge_feat=None, *, tiled=None, block=None,
                ell=None):
        if ell is None:
            _refuse_unported(tiled, edge_feat, block)
        n, h, d = x.shape[0], self.num_heads, self.head_dim
        q = self.Wq(x).reshape(n, h, d)
        k = self.Wk(x).reshape(n, h, d)
        v = self.Wv(x).reshape(n, h, d)
        if ell is not None:
            src_ell, dst_ell = ell
            if edge_feat is None:
                out = ell_attention(dst_ell, src_ell, q, k, v)
            else:
                out = ell_edge_bias_attention(dst_ell, src_ell, q, k, v,
                                              edge_feat)
        else:
            out = tiled_attention(tiled, q, k, v, normalize="dst")
        return self.Wo(out.reshape(n, h * d))


class GraphTransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_dim: int,
                 *, device=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = GraphMultiHeadAttention(dim, num_heads, head_dim,
                                            device=device)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp1 = nn.Linear(dim, mlp_dim, device=device)
        self.mlp2 = nn.Linear(mlp_dim, dim, device=device)

    def forward(self, g, x, edge_feat=None, *, tiled=None, block=None,
                ell=None):
        x = x + self.attn(g, self.ln1(x), edge_feat, tiled=tiled, block=block,
                          ell=ell)
        return x + self.mlp2(F.gelu(self.mlp1(self.ln2(x)),
                                    approximate=GELU_APPROX))


class GraphTransformer(nn.Module):
    """A stack of masked-attention transformer layers over a graph.

    ``in_dim`` is the width of the node features; when it differs from
    ``dim`` a ``proj_in`` layer maps them (flax infers this from the first
    input). Parameters start as flax's defaults do (LeCun-normal weights,
    zero biases, unit LayerNorm scales), drawn from ``generator``.
    """

    def __init__(self, dim: int, num_heads: int, num_layers: int,
                 mlp_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 *, in_dim: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.proj_in = (nn.Linear(in_dim, dim, device=device)
                        if in_dim is not None and in_dim != dim else None)
        head_dim = dim // num_heads
        self.layers = nn.ModuleList(
            GraphTransformerLayer(dim, num_heads, head_dim, mlp_dim or 4 * dim,
                                  device=device)
            for _ in range(num_layers))
        self.ln_out = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.proj_out = (nn.Linear(dim, out_dim, device=device)
                         if out_dim is not None else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)

    def forward(self, g, x, edge_feat=None, *, tiled=None, block=None,
                ell=None):
        if self.proj_in is not None:
            x = self.proj_in(x)
        elif x.shape[-1] != self.dim:
            raise ValueError(f"features are {x.shape[-1]} wide; build the "
                             f"model with in_dim={x.shape[-1]}")
        for layer in self.layers:
            x = layer(g, x, edge_feat, tiled=tiled, block=block, ell=ell)
        x = self.ln_out(x)
        if self.proj_out is not None:
            x = self.proj_out(x)
        return x
