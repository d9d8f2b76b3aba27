"""The plain GAT of DGL's ogbn-arxiv example (symmetric-normalised attention
with no dst term, a linear residual on every layer, batch norm and ReLU
between layers).

DGL's ``examples/pytorch/ogb/ogbn-arxiv`` ``models.py`` (``GAT``,
``GATConv`` with ``use_symmetric_norm`` and without ``attn_dst``; Wang et
al., arXiv:2103.13355), without its dropouts. Layer i maps x (n, k) to z
= x·Wᵢᵀ (n, h, d) scaled by deg_out^-1/2 a source node; el = Σ_d z·a_l;
an edge u → v scores LeakyReLU(el[u]); α is the softmax of the scores
over the in-edges of v; out[v] = (Σ α·z[u])·deg_in(v)^1/2 + x·W_resᵢᵀ.
Degrees count every edge (loops and repeats too), clamped at 1. A hidden
layer's heads are concatenated, batch-normalised with the batch's own
statistics (biased variance, eps 1e-5) and put through ReLU; the last
layer has one head, averages it and adds ``bias_last``. Parameters are
named as the port's state dict names them (``layers.<i>.W.weight``,
``layers.<i>.a_l``, ``layers.<i>.W_res.weight``, ``norms.<i>.weight``,
``norms.<i>.bias``, ``bias_last``), strings only.

The weighted sum is taken in chunks of edges under checkpointing, so the
gathered (edges, h, d) rows live one chunk at a time in the forward and
in the backward.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from gnnbench import counts
from gnnbench.reference.common import Prec, mm

CHUNK_BYTES = 1 << 29
BN_EPS = 1e-5


def _weighted_sum(alpha, z, src, dst, n):
    out = z.new_zeros((n,) + tuple(z.shape[1:]))
    return out.index_add_(0, dst, alpha[..., None] * z[src])


def attention(z, a_l, src, dst, slope: float = 0.2):
    """The no-dst attention on one layer's z (n, h, d): out[v] = Σ_{u→v}
    α·z[u], α the softmax over v's in-edges of LeakyReLU(el[u])."""
    n, h, d = z.shape
    s = F.leaky_relu((z * a_l).sum(-1)[src], slope)
    top = torch.full((n, h), -torch.inf, dtype=s.dtype, device=s.device)
    top = top.scatter_reduce(0, dst[:, None].expand(-1, h), s.detach(),
                             "amax")
    p = torch.exp(s - top[dst])
    den = p.new_zeros(n, h).index_add_(0, dst, p)
    alpha = p / den[dst]
    step = max(1, CHUNK_BYTES // (h * d * z.element_size()))
    out = None
    for a in range(0, src.shape[0], step):
        part = checkpoint(_weighted_sum, alpha[a:a + step], z,
                          src[a:a + step], dst[a:a + step], n,
                          use_reentrant=False)
        out = part if out is None else out + part
    return out


def batch_norm(x, weight, bias):
    """Batch norm over the rows with the batch's own mean and biased
    variance."""
    mean = x.mean(0)
    var = (x - mean).square().mean(0)
    return (x - mean) / torch.sqrt(var + BN_EPS) * weight + bias


def layer_shapes(m: dict) -> list:
    """(in width, heads, width a head) of each layer."""
    width = m["hidden_dim"] * m["num_heads"]
    shapes = [(m["in_dim"] if i == 0 else width, m["num_heads"],
               m["hidden_dim"]) for i in range(m["num_layers"] - 1)]
    shapes.append((m["in_dim"] if m["num_layers"] == 1 else width, 1,
                   m["out_dim"]))
    return shapes


def forward(params: dict, inputs, model: dict, prec: Prec):
    """Logits (n, out_dim) of DGL's ogbn-arxiv GAT ``model`` on ``inputs =
    (x, src, dst)``: node features and the graph's edges (u → v, int64)."""
    x, src, dst = inputs
    x = x.to(prec.dtype)
    n = x.shape[0]
    ones = x.new_ones(src.shape[0])
    deg_out = x.new_zeros(n).index_add_(0, src, ones).clamp(min=1)
    deg_in = x.new_zeros(n).index_add_(0, dst, ones).clamp(min=1)
    src_scale = deg_out.pow(-0.5)[:, None, None]
    dst_scale = deg_in.pow(0.5)[:, None, None]
    shapes = layer_shapes(model)
    for i, (_, h, d) in enumerate(shapes):
        pre = f"layers.{i}."
        z = mm(x, params[pre + "W.weight"].t(), prec).reshape(n, h, d)
        out = attention(z * src_scale, params[pre + "a_l"], src, dst)
        out = (out * dst_scale
               + mm(x, params[pre + "W_res.weight"].t(), prec)
               .reshape(n, h, d))
        if i < len(shapes) - 1:
            x = F.relu(batch_norm(out.reshape(n, h * d),
                                  params[f"norms.{i}.weight"],
                                  params[f"norms.{i}.bias"]))
        else:
            x = out.mean(1) + params["bias_last"]
    return x


def forward_flops(model: dict, n: int, e: int) -> float:
    """Operations of one forward pass over n nodes and e edges, on
    ``reference/gat.py``'s rules: both dense products of each layer (W and
    W_res), the one attention vector (2·n·h·d), four per edge and head for
    the el-only score and its softmax, and 2·e·h·d for the weighted sum;
    the degree scalings, batch norm, ReLU and the adds are not counted."""
    total = 0.0
    for k, h, d in layer_shapes(model):
        total += 2 * counts.dense(n, k, h * d)
        total += 2.0 * n * h * d + 4.0 * e * h + 2.0 * e * h * d
    return total


def mp_counts(n: int, e: int, h: int, d: int) -> tuple:
    """(operations, bytes) of one no-dst attention layer's forward and
    backward (``ell_gat_attention`` with no ``a_r`` on z (n, h, d)): the
    forward reads z and the edges (two int32 a real edge) and writes out;
    the backward reads dy, z and the edges and writes dz; the backward's
    operations are counted as twice the forward's."""
    fwd = 2.0 * n * h * d + 4.0 * e * h + 2.0 * e * h * d
    node = n * h * d * counts.F32
    edges = 2 * e * counts.INDEX
    return 3.0 * fwd, (2 * node + edges) + (3 * node + edges)
