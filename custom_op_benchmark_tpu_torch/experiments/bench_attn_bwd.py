"""ELL attention, edge-bias attention and GAT, forward and backward, on
the power-law graph.

Counterpart of scripts/bench_attn_bwd.py. On ``random_graph(131072, 2M,
power_law=True)`` (pow-2 ladder unless marked ``[train]``):

    attn_fwd / attn_bwd                 ``ell_attention``, h = 1, d = 128
    attn_mh_fwd / attn_mh_bwd           the same at h = 4, d = 32
    gat_fwd / gat_bwd                   ``ell_gat_attention``, h = 4, d = 32
    eb_fwd / eb_bwd                     ``ell_edge_bias_attention`` with a
                                        canonical (E, 128) bias
    eb_packed_fwd / eb_packed_bwd       the same bias packed in both ELL
                                        layouts (``ell_pack_weights``)
    eb_mh_packed_fwd / _bwd             packed, h = 4, d = 32
    eb_packed_bwd[train]                packed on the training ladder

Each ``_bwd`` row is the gradient of (out²).sum() with respect to every
input (forward and backward). Timed by ``benchlib.bench_fn``.

Runs on the CUDA device, ``--small`` on a 16,384-node, 250,000-edge
graph, or with ``--device cpu`` on 512 nodes and 4,000 edges, timing
nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.bench_attn_bwd [--small | --device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.ops import (
    PackedEdgeWeights,
    ell_attention,
    ell_dual,
    ell_edge_bias_attention,
    ell_gat_attention,
    ell_pack_weights,
)

D = 128
HEADS, HEAD_DIM = 4, 32


def packed_args(w: PackedEdgeWeights) -> tuple:
    """The packed weights' tensors, each requiring grad, as call args."""
    return tuple(t.detach().clone().requires_grad_() for t in w.src + w.dst)


def eb_packed(de, se, n_src):
    """Edge-bias attention on packed weights passed as flat tensors (the
    first ``n_src`` the src copy)."""

    def f(q, k, v, *ws):
        w = PackedEdgeWeights(src=list(ws[:n_src]), dst=list(ws[n_src:]))
        return ell_edge_bias_attention(de, se, q, k, v, w)

    return f


def run(device: torch.device, size: str = "full") -> dict:
    n, e = common.GRAPH[size]
    g = random_graph(n, e, seed=0, power_law=True).to(device)
    se, de = ell_dual(g)
    e_real = g.n_edges
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(device).requires_grad_()

    q, k, v = normal(n, D), normal(n, D), normal(n, D)
    a_l, a_r = normal(HEADS, HEAD_DIM), normal(HEADS, HEAD_DIM)
    z = normal(n, HEADS, HEAD_DIM)
    zk, zv = (z.detach().clone().requires_grad_() for _ in range(2))
    be = normal(e_real, D)
    beh = normal(e_real, HEAD_DIM)
    rows = common.Rows(device)

    def pair(name, f, *args):
        with torch.no_grad():
            rows(f"{name}_fwd", f, *args, edges=e_real)
        rows(f"{name}_bwd", common.sq_grad(f), *args, edges=e_real)

    def attn(q, k, v):
        return ell_attention(de, se, q, k, v)

    pair("attn", attn, q, k, v)
    pair("attn_mh", attn, z, zk, zv)
    pair("gat", lambda a, b, z: ell_gat_attention(de, se, a, b, z),
         a_l, a_r, z)
    pair("eb", lambda q, k, v, be: ell_edge_bias_attention(de, se, q, k, v,
                                                           be), q, k, v, be)
    w = ell_pack_weights(se, de, be.detach())
    pair("eb_packed", eb_packed(de, se, len(w.src)), q, k, v,
         *packed_args(w))
    del w
    wh = ell_pack_weights(se, de, beh.detach())
    pair("eb_mh_packed", eb_packed(de, se, len(wh.src)), z, zk, zv,
         *packed_args(wh))
    del wh
    se_t, de_t = ell_dual(g, profile="train")
    w_t = ell_pack_weights(se_t, de_t, be.detach())
    rows("eb_packed_bwd[train]", common.sq_grad(eb_packed(
        de_t, se_t, len(w_t.src))), q, k, v, *packed_args(w_t),
        edges=e_real)
    return dict(device=common.where(device), n=n, e=e_real, d=D,
                heads=HEADS, head_dim=HEAD_DIM, ms=rows.ms)


def main(argv=None) -> int:
    return common.run_main("bench_attn_bwd", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
