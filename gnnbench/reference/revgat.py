"""The plain RevGAT of the ogbn-arxiv leaderboard (grouped reversible
blocks of DGL's ogbn-arxiv GAT layer), computed directly.

Li, Müller, Ghanem and Koltun, "Training Graph Neural Networks with 1000
Layers" (arXiv:2106.07476); ``deep_gcns_torch``'s
``examples/ogb_eff/ogbn_arxiv_dgl`` (``RevGAT`` with ``--backbone rev``),
without its dropouts. C is ``reference/gat_dgl.py``'s layer: z = x·Wᵀ
(n, h, d) scaled by deg_out^-1/2 a source node, the softmax over v's
in-edges of LeakyReLU(a_l·z[u]), out[v] = (Σ α·z[u])·deg_in(v)^1/2 +
x·W_resᵀ, degrees counting every edge and clamped at 1. The stack:

    h = C₀(x)                                        in → heads × hidden
    for each of num_layers − 2 blocks, G = group groups of W/G columns:
        (x₁, …, x_G) = split(h);  F_g(u) = C_g(ReLU(BN_g(u)))
        y₁ = x₁ + F₁(x₂ + … + x_G);  y_g = x_g + F_g(y_{g−1})
        h = [y₁, …, y_G]
    out = mean over the head of C_last(ReLU(BN(h))) + bias_last

C_g maps W/G columns to the same heads of hidden/G each. Batch norm takes
the batch's mean and biased variance (eps 1e-5). Each block's input is
kept here (plain autograd): the reversibility changes what the program
keeps, not what it computes. Parameters are named as the port's state
dict names them (``layers.<i>.W.weight``, ``layers.<i>.a_l``,
``layers.<i>.W_res.weight`` for the first and last layer;
``layers.<b>.convs.<g>.…`` and ``layers.<b>.norms.<g>.weight``/``.bias``
in block b; ``norm.weight``, ``norm.bias``, ``bias_last``), strings only.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from gnnbench import counts
from gnnbench.reference import gat_dgl
from gnnbench.reference.common import Prec, mm


def _convs(m: dict) -> list:
    """(parameter prefix, in width, heads, width a head) of each C."""
    width = m["hidden_dim"] * m["num_heads"]
    h, d, g = m["num_heads"], m["hidden_dim"], m["group"]
    last = m["num_layers"] - 1
    out = [("layers.0.", m["in_dim"], h, d)]
    out += [(f"layers.{b}.convs.{i}.", width // g, h, d // g)
            for b in range(1, last) for i in range(g)]
    out.append((f"layers.{last}.", width, 1, m["out_dim"]))
    return out


def layer_shapes(m: dict) -> list:
    """(in width, heads, width a head) of each attention layer C, in the
    order the forward runs them."""
    return [(k, h, d) for _, k, h, d in _convs(m)]


def forward(params: dict, inputs, model: dict, prec: Prec):
    """Logits (n, out_dim) of RevGAT ``model`` on ``inputs = (x, src,
    dst)``: node features and the graph's edges (u → v, int64)."""
    x, src, dst = inputs
    x = x.to(prec.dtype)
    n = x.shape[0]
    ones = x.new_ones(src.shape[0])
    deg_out = x.new_zeros(n).index_add_(0, src, ones).clamp(min=1)
    deg_in = x.new_zeros(n).index_add_(0, dst, ones).clamp(min=1)
    src_scale = deg_out.pow(-0.5)[:, None, None]
    dst_scale = deg_in.pow(0.5)[:, None, None]
    convs = iter(_convs(model))

    def conv(u):
        pre, _, h, d = next(convs)
        z = mm(u, params[pre + "W.weight"].t(), prec).reshape(n, h, d)
        out = gat_dgl.attention(z * src_scale, params[pre + "a_l"], src,
                                dst)
        return (out * dst_scale + mm(u, params[pre + "W_res.weight"].t(),
                                     prec).reshape(n, h, d))

    def bn_relu(u, pre):
        return F.relu(gat_dgl.batch_norm(u, params[pre + "weight"],
                                         params[pre + "bias"]))

    h = conv(x).reshape(n, -1)
    for b in range(1, model["num_layers"] - 1):
        xs = h.chunk(model["group"], 1)
        y, ys = sum(xs[1:]), []
        for i, xi in enumerate(xs):
            y = xi + conv(bn_relu(y, f"layers.{b}.norms.{i}.")).reshape(n, -1)
            ys.append(y)
        h = torch.cat(ys, 1)
    return conv(bn_relu(h, "norm.")).mean(1) + params["bias_last"]


def forward_flops(model: dict, n: int, e: int) -> float:
    """Operations of one forward pass over n nodes and e edges, on
    ``reference/gat_dgl.py``'s rules for each C (both dense products, the
    one attention vector, four per edge and head for the score and its
    softmax, 2·e·h·d for the weighted sum); batch norm, ReLU, the degree
    scalings and the adds are not counted, nor is the program's recompute
    (``counts``)."""
    total = 0.0
    for k, h, d in layer_shapes(model):
        total += 2 * counts.dense(n, k, h * d)
        total += 2.0 * n * h * d + 4.0 * e * h + 2.0 * e * h * d
    return total


def mp_counts(n: int, e: int, h: int, d: int) -> tuple:
    """(operations, bytes) of one attention call's forward and backward at
    (h, d): ``reference/gat_dgl.mp_counts``, the same op."""
    return gat_dgl.mp_counts(n, e, h, d)
