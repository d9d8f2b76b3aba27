"""ELL bucket-width ladders: padding against bucket count on the power-law
graph.

Counterpart of scripts/exp_ell_ladder.py. A coarse ladder pads more slots
(each one a gathered row in the sweeps and a hopped row in the backward);
a finer one makes more buckets (more launches a sweep). On
``random_graph(131072, 2M, power_law=True)``, for each ladder: the bucket
counts and padding factors (slots / edges) of both packings, and the
times of ``ell_attention``'s forward (h = 1, d = 128), its gradient, and
``ell_gat_attention``'s gradient (h = 4, d = 32).

Runs on the CUDA device, ``--small`` on a 16,384-node, 250,000-edge
graph, or with ``--device cpu`` on 512 nodes and 4,000 edges, timing
nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_ell_ladder [--small | --device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.ops import (
    ell_attention,
    ell_dual,
    ell_gat_attention,
)

LADDERS = {
    "pow2": (4, 8, 16, 32, 64, 128, 256, 512, 1024),
    "x1.5": (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
             384, 512, 768, 1024),
    "lin8": tuple(range(4, 65, 4)) + (96, 128, 192, 256, 384, 512,
                                      768, 1024),
}
D = 128
HEADS, HEAD_DIM = 4, 32


def run(device: torch.device, size: str = "full") -> dict:
    n, e = common.GRAPH[size]
    g = random_graph(n, e, seed=0, power_law=True).to(device)
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(device).requires_grad_()

    q, k, v = normal(n, D), normal(n, D), normal(n, D)
    a_l, a_r = normal(HEADS, HEAD_DIM), normal(HEADS, HEAD_DIM)
    z = normal(n, HEADS, HEAD_DIM)
    out = {}
    for name, widths in LADDERS.items():
        se, de = ell_dual(g, widths=widths)
        slots = {k_: sum(b.cols.numel() for b in p.buckets)
                 for k_, p in (("dst", de), ("src", se))}
        rec = dict(buckets_dst=len(de.buckets), buckets_src=len(se.buckets),
                   pad_dst=slots["dst"] / g.n_edges,
                   pad_src=slots["src"] / g.n_edges)
        print(f"[{name}] buckets dst {rec['buckets_dst']} src "
              f"{rec['buckets_src']}, pad dst {rec['pad_dst']:.3f} src "
              f"{rec['pad_src']:.3f}", flush=True)
        rows = common.Rows(device, prefix="  ")

        def attn(q, k, v, de=de, se=se):
            return ell_attention(de, se, q, k, v)

        with torch.no_grad():
            rows("attn_fwd", attn, q, k, v, edges=g.n_edges)
        rows("attn_grad", common.sq_grad(attn), q, k, v, edges=g.n_edges)
        rows("gat_grad", common.sq_grad(
            lambda a, b, z, de=de, se=se: ell_gat_attention(de, se, a, b, z)),
            a_l, a_r, z, edges=g.n_edges)
        out[name] = dict(rec, ms=rows.ms)
        del se, de
    return dict(device=common.where(device), n=n, e=g.n_edges,
                ladders=out)


def main(argv=None) -> int:
    return common.run_main("exp_ell_ladder", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
