"""RevGAT: a GAT of grouped reversible blocks, whose backward rebuilds each
block's input from its output instead of keeping it.

The ogbn-arxiv RevGAT of Li, Müller, Ghanem and Koltun, "Training Graph
Neural Networks with 1000 Layers" (ICML 2021, arXiv:2106.07476; the
example ``examples/ogb_eff/ogbn_arxiv_dgl`` of ``deep_gcns_torch``), without
its dropouts. C is DGL's ogbn-arxiv layer (``models.gat_dgl.GATDGLLayer``:
symmetric-normalised attention with no dst term and a linear residual),
every layer sharing one :class:`DegreeScales`:

    h   = C₀(x)                               in → heads × hidden
    for each of num_layers − 2 blocks, G groups of W/G columns:
        (x₁, …, x_G) = split(h);  F_g(u) = C_g(ReLU(BN_g(u)))
        y₁ = x₁ + F₁(x₂ + … + x_G);  y_g = x_g + F_g(y_{g−1});  h = [y₁ … y_G]
    out = mean_heads(C_last(ReLU(BN(h)))) + bias_last        1 head

where C_g maps W/G columns to the same heads of hidden/G. Batch norm takes
the batch's statistics (no running statistics). The stack runs through
``GAT.forward``, with this model's ``_between`` and ``_output``.

A block is one autograd Function (:class:`GroupCoupling`). Its forward
runs the F_g without autograd and keeps only its output's groups y_g.
Its backward, last group first, recomputes F_g with autograd on its input
(y_{g−1}, which it kept; for the first group the sum of the rebuilt
x₂ … x_G), rebuilds x_g = y_g − F_g for g ≥ 2 and backpropagates the
output's gradient through F_g: one recompute of each F a step. x₁ is
never rebuilt: no F reads it, and its gradient is the output's.

The recompute gives the forward's F_g bit for bit from the same input: F
is the same code in both, and each of its sums has a fixed order on the
card (the GAT sweeps of csrc/ell_gat.cu, the batch norm's passes of
csrc/norm_act.cu, cuBLAS's f32 GEMMs at a fixed shape) and on the CPU.
The rebuilt x_g is y_g − F_g in f32, within a rounding of x_g.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from custom_op_benchmark_tpu_torch.models.flax_init import flax_init_
from custom_op_benchmark_tpu_torch.models.gat import GAT
from custom_op_benchmark_tpu_torch.models.gat_dgl import (
    DegreeScales,
    GATDGLLayer,
)
from custom_op_benchmark_tpu_torch.ops.kernels.norm_act import (
    norm_act_backward,
    norm_act_forward,
)
from custom_op_benchmark_tpu_torch.utils.spans import recompute, span


class _BatchNormReLU(torch.autograd.Function):
    """``ReLU(BN(u))`` with the batch's statistics through the fused passes
    of ``ops/kernels/norm_act.py``, which take ``h = out·ds + r``: here out
    and r are u and ds is 0, so h is u, bit for bit. Keeps u, the columns'
    mean and rstd."""

    @staticmethod
    def forward(ctx, u, weight, bias, eps):
        u = u.contiguous()
        ds = u.new_zeros(u.shape[0])
        with span("revgat.norm_act.fwd"):
            y, _, mean, rstd = norm_act_forward(u, ds, u, weight, bias, eps)
        ctx.save_for_backward(u, ds, mean, rstd, weight, bias)
        return y

    @staticmethod
    def backward(ctx, g):
        u, ds, mean, rstd, weight, bias = ctx.saved_tensors
        with span("revgat.norm_act.bwd"):
            _, du, d_weight, d_bias = norm_act_backward(
                g.contiguous(), u, ds, mean, rstd, weight, bias)
        return du, d_weight, d_bias, None


def batch_norm_relu(u, norm: nn.BatchNorm1d):
    """``ReLU(norm(u))`` for u (n, W), with the batch's mean and biased
    variance."""
    return _BatchNormReLU.apply(u, norm.weight, norm.bias, norm.eps)


def _tail(parts):
    """A hidden ``GATDGLLayer``'s output ``out·ds + res`` as (n, h·d)."""
    out, ds, res = parts
    return torch.addcmul(res.view_as(out), out, ds).view(out.shape[0], -1)


class GroupCoupling(torch.autograd.Function):
    """A reversible block's groups, ``(block, g, ell, x, *block's
    parameters) → y``, keeping only y's groups for the backward.
    ``forwards`` and ``recomputes`` count the F evaluations of forwards and
    of backwards (G a block each)."""

    forwards = recomputes = 0

    @staticmethod
    def forward(ctx, block, g, ell, x, *params):
        with span("train.reversible.fwd"):
            xs = x.chunk(block.group, 1)
            u = _sum(xs[1:])
            ys = []
            for i, xi in enumerate(xs):
                u = xi + block.f(i, g, ell, u)
                ys.append(u)
            y = torch.cat(ys, 1)
        GroupCoupling.forwards += block.group
        ctx.block, ctx.g, ctx.ell = block, g, ell
        ctx.save_for_backward(*ys)
        return y

    @staticmethod
    def backward(ctx, dy):
        block, g, ell = ctx.block, ctx.g, ctx.ell
        ys = ctx.saved_tensors
        grads = {}
        with span("train.reversible.bwd"):
            dys = list(dy.chunk(block.group, 1))
            xs = [None] * block.group
            for i in reversed(range(block.group)):
                u = ys[i - 1] if i else _sum(xs[1:])
                with torch.enable_grad():
                    u = u.detach().requires_grad_()
                    with recompute():
                        f = block.f(i, g, ell, u)
                if i:
                    xs[i] = ys[i] - f.detach()
                params = block.group_parameters(i)
                du, *dp = torch.autograd.grad(f, [u] + params, dys[i])
                del f  # F's graph goes before the next group's recompute
                grads.update(zip(map(id, params), dp))
                if i:
                    dys[i - 1] = dys[i - 1] + du
                else:
                    dys[1:] = [d + du for d in dys[1:]]
            dx = torch.cat(dys, 1)
        GroupCoupling.recomputes += block.group
        return (None, None, None, dx,
                *(grads[id(p)] for p in block.parameters()))


def _sum(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class ReversibleBlock(nn.Module):
    """One grouped reversible block of W columns in ``group`` groups: F_g =
    ``convs[g]`` after ``norms[g]`` and ReLU, ``convs[g]`` a
    ``GATDGLLayer`` from W/G columns to ``num_heads`` heads of
    ``hidden_dim`` (W/G in all)."""

    def __init__(self, width: int, hidden_dim: int, num_heads: int,
                 group: int, *, scales: DegreeScales, device=None):
        super().__init__()
        part = width // group
        if part * group != width or hidden_dim * num_heads != part:
            raise ValueError(f"{group} groups of {num_heads} heads of "
                             f"{hidden_dim} do not make {width} columns")
        self.group = group
        self.convs = nn.ModuleList(
            GATDGLLayer(part, hidden_dim, num_heads, scales=scales,
                        device=device) for _ in range(group))
        self.norms = nn.ModuleList(
            nn.BatchNorm1d(part, track_running_stats=False, device=device)
            for _ in range(group))

    def f(self, i: int, g, ell, u):
        """F_i(u) = ``convs[i]``'s output on ReLU(``norms[i]``(u)), (n,
        W/G)."""
        return _tail(self.convs[i](g, batch_norm_relu(u, self.norms[i]),
                                   ell=ell))

    def group_parameters(self, i: int) -> list:
        return [*self.convs[i].parameters(), *self.norms[i].parameters()]

    def forward(self, g, x, *, ell=None, block=None):
        if block is not None:
            raise ValueError("ReversibleBlock has no dense-block path: give "
                             "it the ELL view (ell=) or no view")
        return GroupCoupling.apply(self, g, ell, x, *self.parameters())


class RevGAT(GAT):
    """RevGAT (published for ogbn-arxiv: 5 layers, 3 heads of 256, 2
    groups, ``in_dim`` 128 features + 40 label columns, 40 classes;
    2,098,256 parameters), float32.

    ``layers`` is ``[C₀, block₁, …, block_{L−2}, C_last]``; GAT's
    ``forward`` drives it (so whatever wraps GAT's forward wraps this
    model's), and GAT's constructor is not run: the three attributes its
    forward reads are set here (no dropout, no remat, f32). On the card
    the batch norms run ``ops/kernels/norm_act.py``, whose widths bound
    W/G and W (``models.gat_dgl.GATDGL`` says how)."""

    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int = 5,
                 num_heads: int = 3, group: int = 2, *, in_dim: int,
                 device=None, generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        if num_layers < 2 or hidden_dim % group:
            raise ValueError(f"RevGAT takes at least 2 layers and a hidden "
                             f"width that {group} groups divide")
        self.dropout_rate, self.remat, self.dtype = 0.0, False, None
        scales = DegreeScales()
        width = hidden_dim * num_heads
        layers = [GATDGLLayer(in_dim, hidden_dim, num_heads, scales=scales,
                              device=device)]
        layers += [ReversibleBlock(width, hidden_dim // group, num_heads,
                                   group, scales=scales, device=device)
                   for _ in range(num_layers - 2)]
        layers.append(GATDGLLayer(width, out_dim, 1, concat_heads=False,
                                  scales=scales, device=device))
        self.layers = nn.ModuleList(layers)
        self.norm = nn.BatchNorm1d(width, track_running_stats=False,
                                   device=device)
        self.bias_last = nn.Parameter(torch.zeros(out_dim, device=device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
        with torch.no_grad():
            self.bias_last.zero_()

    def _between(self, i: int, x):
        if i == 0:
            x = _tail(x)
        if i == len(self.layers) - 2:
            x = batch_norm_relu(x, self.norm)
        return x

    def _output(self, out):
        return out + self.bias_last
