"""The plain GAT (additive attention, LeakyReLU 0.2, ELU between layers).

A hidden layer i maps its input x (n, k) to z = x·Wᵢᵀ (n, h, d);
el = Σ_d z·a_l and er = Σ_d z·a_r; an edge u → v scores LeakyReLU(el[u] +
er[v]); α is the softmax of the scores over the in-edges of v; out[v] =
Σ α·z[u]; layers after the first add x back (through W_res where the
widths differ); the heads are concatenated. The last layer has one head
and averages it. Parameters are named as the port's state dict names them
(``layers.<i>.W.weight``, ``layers.<i>.a_l``, ``layers.<i>.a_r``,
``layers.<i>.W_res.weight``), strings only.

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


def _weighted_sum(alpha, z, src, dst, n):
    out = z.new_zeros((n,) + tuple(z.shape[1:]))
    return out.index_add_(0, dst, alpha[..., None] * z[src])


def attention(z, a_l, a_r, src, dst, slope: float = 0.2):
    """The GAT core on one layer's z (n, h, d): out[v] = Σ_{u→v} α·z[u]."""
    n, h, d = z.shape
    el, er = (z * a_l).sum(-1), (z * a_r).sum(-1)
    s = F.leaky_relu(el[src] + er[dst], slope)
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


def layer_shapes(m: dict) -> list:
    """(in width, heads, width a head, residual, concat) of each layer."""
    width = m["hidden_dim"] * m["num_heads"]
    shapes = [(m["in_dim"] if i == 0 else width, m["num_heads"],
               m["hidden_dim"], i > 0, True)
              for i in range(m["num_layers"] - 1)]
    shapes.append((m["in_dim"] if m["num_layers"] == 1 else width, 1,
                   m["out_dim"], False, False))
    return shapes


def forward(params: dict, inputs, model: dict, prec: Prec):
    """Logits (n, out_dim) of the GAT ``model`` on ``inputs = (x, src,
    dst)``: node features and the graph's edges (u → v, int64)."""
    x, src, dst = inputs
    x = x.to(prec.dtype)
    n = x.shape[0]
    shapes = layer_shapes(model)
    for i, (_, h, d, residual, concat) in enumerate(shapes):
        pre = f"layers.{i}."
        z = mm(x, params[pre + "W.weight"].t(), prec).reshape(n, h, d)
        out = attention(z, params[pre + "a_l"], params[pre + "a_r"], src,
                        dst)
        if residual:
            res = params.get(pre + "W_res.weight")
            res = x if res is None else mm(x, res.t(), prec)
            out = out + res.reshape(n, h, d)
        x = out.reshape(n, h * d) if concat else out.mean(1)
        if i < len(shapes) - 1:
            x = F.elu(x)
    return x


def forward_flops(model: dict, n: int, e: int) -> float:
    """Operations of one forward pass over n nodes and e edges: the dense
    products, the attention vectors (2·2·n·h·d), five per edge and head for
    the score and its softmax, and 2·e·h·d for the weighted sum."""
    total = 0.0
    for k, h, d, residual, _ in layer_shapes(model):
        total += counts.dense(n, k, h * d)
        if residual and k != h * d:
            total += counts.dense(n, k, h * d)
        total += 4.0 * n * h * d + 5.0 * e * h + 2.0 * e * h * d
    return total


def mp_counts(n: int, e: int, h: int, d: int) -> tuple:
    """(operations, bytes) of one attention layer's forward and backward
    (``ell_gat_attention`` on z (n, h, d)): the forward reads z and the
    edges (two int32 a real edge) and writes out; the backward reads dy, z
    and the edges and writes dz; the backward's operations are counted as
    twice the forward's."""
    fwd = 4.0 * n * h * d + 5.0 * e * h + 2.0 * e * h * d
    node = n * h * d * counts.F32
    edges = 2 * e * counts.INDEX
    return 3.0 * fwd, (2 * node + edges) + (3 * node + edges)
