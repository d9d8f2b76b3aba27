"""The plain GraphSAGE with the mean aggregator (ReLU between layers).

A layer maps x (n, k) to x·W_selfᵀ + b_self + mean_{u→v} x[u]·W_neighᵀ,
the mean over the in-edges of v (0 for a node with none). Parameters are
named as the port's state dict names them (``layers.<i>.W_self.weight``,
``layers.<i>.W_self.bias``, ``layers.<i>.W_neigh.weight``), strings only.
"""

from __future__ import annotations

from torch.nn import functional as F

from gnnbench import counts
from gnnbench.reference.common import Prec, linear


def mean_in(x, src, dst, n):
    """The mean of x[u] over the in-edges u → v of each node v."""
    total = x.new_zeros(n, x.shape[1]).index_add_(0, dst, x[src])
    deg = x.new_zeros(n).index_add_(0, dst, x.new_ones(dst.shape[0]))
    return total / deg.clamp(min=1)[:, None]


def widths(model: dict) -> list:
    dims = ([model["in_dim"]] + [model["hidden_dim"]]
            * (model["num_layers"] - 1) + [model["out_dim"]])
    return list(zip(dims, dims[1:]))


def forward(params: dict, inputs, model: dict, prec: Prec):
    """Logits (n, out_dim) of the GraphSAGE ``model`` on ``inputs = (x,
    src, dst)``."""
    x, src, dst = inputs
    x = x.to(prec.dtype)
    n = x.shape[0]
    layers = widths(model)
    for i in range(len(layers)):
        pre = f"layers.{i}."
        x_next = (linear(x, params[pre + "W_self.weight"],
                         params[pre + "W_self.bias"], prec)
                  + linear(mean_in(x, src, dst, n),
                           params[pre + "W_neigh.weight"], None, prec))
        x = F.relu(x_next) if i < len(layers) - 1 else x_next
    return x


def forward_flops(model: dict, n: int, e: int) -> float:
    """Operations of one forward pass over n nodes and e edges: two dense
    products a layer and (e + n)·k for the mean over the in-edges."""
    return sum(2 * counts.dense(n, k, o) + (e + n) * k
               for k, o in widths(model))


def mp_counts(n: int, e: int, d: int) -> tuple:
    """(operations, bytes) of one mean aggregation's forward and backward
    at width d (``sampled_copy_spmm`` on a batch of n real nodes and e real
    edges): the forward reads x and the in-edges (one int32 a slot and a
    row pointer a node) and writes the mean; the backward reads dy and the
    edges the same way and writes dx, with as many operations."""
    ops = 2.0 * (e + n) * d
    node = n * d * counts.F32
    edges = (e + n) * counts.INDEX
    return ops, 2 * (2 * node + edges)
