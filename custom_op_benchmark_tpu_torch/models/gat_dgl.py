"""DGL's ogbn-arxiv GAT: symmetric-normalised attention with no dst term,
a linear residual on every layer and batch norm between layers.

The model of DGL's OGB example ``examples/pytorch/ogb/ogbn-arxiv``
(``models.py`` ``GAT``, ``GATConv`` with ``use_symmetric_norm`` and no
``attn_dst``; Wang et al., arXiv:2103.13355), without its dropouts. For
layer i with h heads of width d, deg the node degrees clamped at 1:

    z     = (x·Wᵢᵀ).view(n, h, d) · deg_out^-1/2
    α_uv  = softmax over the in-edges u → v of LeakyReLU_0.2(a_l·z[u])
    out_v = (Σ_u α_uv·z[u]) · deg_in^+1/2 + (x·W_resᵢᵀ).view(n, h, d)

W and W_res have no bias. A hidden layer's heads are concatenated, then
``BatchNorm1d`` (no running statistics: the batch's, in eval mode too)
and ReLU; the last layer (one head) takes the mean over its head and adds
``bias_last``. The attention runs through :func:`models.gat.attend`: the
fused ``ell_gat_attention`` on the ELL view, ``softmax_aggregate_dst``
without one. There is no dense-block path.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from custom_op_benchmark_tpu_torch.models.flax_init import flax_init_
from custom_op_benchmark_tpu_torch.models.gat import GAT, attend


class DegreeScales:
    """``(deg_out^-1/2, deg_in^+1/2)`` of a graph as (n, 1, 1) float32,
    degrees clamped at 1: worked out once for the last graph asked for and
    kept while that graph lives."""

    def __init__(self):
        self._graph, self._scales = None, None

    def __call__(self, g):
        if self._graph is None or self._graph() is not g:
            out_deg = g.out_degrees().clamp(min=1).float()
            in_deg = g.in_degrees().clamp(min=1).float()
            self._scales = (out_deg.rsqrt()[:, None, None],
                            in_deg.sqrt()[:, None, None])
            self._graph = weakref.ref(g)
        return self._scales


class GATDGLLayer(nn.Module):
    """One layer of DGL's ogbn-arxiv GAT (its ``GATConv`` with symmetric
    normalisation, no dst attention and a linear residual)."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1,
                 negative_slope: float = 0.2, concat_heads: bool = True, *,
                 scales: Optional[DegreeScales] = None, device=None):
        super().__init__()
        h, d = num_heads, out_dim
        self.num_heads, self.out_dim = h, d
        self.negative_slope = negative_slope
        self.concat_heads = concat_heads
        self.scales = DegreeScales() if scales is None else scales
        self.W = nn.Linear(in_dim, h * d, bias=False, device=device)
        self.a_l = nn.Parameter(torch.empty(h, d, device=device))
        self.W_res = nn.Linear(in_dim, h * d, bias=False, device=device)
        flax_init_(self)

    def forward(self, g, x, *, ell=None, block=None):
        if block is not None:
            raise ValueError("GATDGLLayer has no dense-block path: give it "
                             "the ELL view (ell=) or no view")
        n, h, d = x.shape[0], self.num_heads, self.out_dim
        src_scale, dst_scale = self.scales(g)
        z = self.W(x).reshape(n, h, d) * src_scale
        out = attend(g, z, self.a_l, None, ell=ell,
                     negative_slope=self.negative_slope)
        out = out * dst_scale + self.W_res(x).reshape(n, h, d)
        return out.reshape(n, h * d) if self.concat_heads else out.mean(1)


class GATDGL(GAT):
    """DGL's ogbn-arxiv GAT stack (published: 3 layers, 3 heads of 250,
    ``in_dim`` 128 features + 40 label columns, 40 classes), float32.

    GAT's ``forward`` drives the stack, so whatever wraps GAT's forward
    wraps this model's too (``gnnbench``'s altered-answer fault patches
    ``GAT.forward`` and must reach every GAT cell); what follows a hidden
    layer (batch norm, ReLU) and the output bias are this model's. The
    layers differ from GAT's, so GAT's constructor is not run: the three
    attributes its forward reads are set here (no dropout, no remat, f32).
    One :class:`DegreeScales` serves every layer.
    """

    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int = 3,
                 num_heads: int = 3, *, in_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        self.dropout_rate, self.remat, self.dtype = 0.0, False, None
        scales = DegreeScales()
        width = hidden_dim * num_heads
        self.layers = nn.ModuleList(
            GATDGLLayer(in_dim if i == 0 else width, hidden_dim, num_heads,
                        scales=scales, device=device)
            for i in range(num_layers - 1))
        self.layers.append(GATDGLLayer(in_dim if num_layers == 1 else width,
                                       out_dim, 1, concat_heads=False,
                                       scales=scales, device=device))
        self.norms = nn.ModuleList(
            nn.BatchNorm1d(width, track_running_stats=False, device=device)
            for _ in range(num_layers - 1))
        self.bias_last = nn.Parameter(torch.zeros(out_dim, device=device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)
        for norm in self.norms:
            norm.reset_parameters()
        with torch.no_grad():
            self.bias_last.zero_()

    def _between(self, i: int, x):
        return F.relu(self.norms[i](x))

    def _output(self, out):
        return out + self.bias_last
