"""The halo plan at P = 1 against the single-card ELL attention, pass by
pass.

Counterpart of scripts/exp_halo_accounting.py. On ``random_graph(131072,
2M, power_law=True)``: first the padded slots of the single-card packing
(``ell_dual``) and of the halo plan's packing (``halo_ell`` on a local
mesh of one shard), both directions; then, at (h, d) = (1, 128) and
(4, 32):

    fused_fwd / fused_bwd     the single-card ``ell_attention``: forward and
                              the gradient of (out²).sum()
    halo_fwd / halo_bwd       ``halo_attention_ell`` on the one-shard mesh
    exchange_only             the plan's exchange step alone
                              (``parallel/halo.py``'s ``_Exchange``: the
                              local table with its zero row, the all_to_all
                              of the send rows and the hub gather, the
                              extended table) for k and for v, as the
                              forward starts it
    combine_only              the ``row_pos`` gather of packed bucket rows
                              into owned rows

The forward outputs of the two paths must agree within 1e-4 (the plans'
gate); the driver exits 1 otherwise.

Runs on the CUDA device, ``--small`` on a 16,384-node, 250,000-edge
graph, or with ``--device cpu`` on 512 nodes and 4,000 edges, timing
nothing.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_halo_accounting [--small | --device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import random_graph
from custom_op_benchmark_tpu_torch.ops import ell_attention, ell_dual
from custom_op_benchmark_tpu_torch.parallel import (
    halo_attention_ell,
    halo_ell,
    halo_graph,
    make_mesh,
    shard_halo_nodes,
)
from custom_op_benchmark_tpu_torch.parallel.halo import _Exchange
from custom_op_benchmark_tpu_torch.parallel.rows import take_raw

SHAPES = ((1, 128), (4, 32))
TOL = 1e-4


def padded_slots(de, se, he) -> dict:
    """Padded slots of the single-card packings and of the halo plan's."""
    def halo(cols):
        return sum(int(np.prod(c.shape[1:])) for c in cols)

    return dict(single_card=sum(b.cols.numel() for b in de.buckets),
                halo=halo(he.cols_b),
                single_card_t=sum(b.cols.numel() for b in se.buckets),
                halo_t=halo(he.cols_t_b))


def run(device: torch.device, size: str = "full") -> dict:
    n, e = common.GRAPH[size]
    g = random_graph(n, e, seed=0, power_law=True)
    se, de = ell_dual(g.to(device))
    mesh = make_mesh((1,), ("edge",), device=device)
    hg = halo_graph(g, mesh)
    he = halo_ell(hg, mesh)
    slots = padded_slots(de, se, he)
    print(f"padded slots dst: single card {slots['single_card']} vs halo "
          f"{slots['halo']} | src/t: {slots['single_card_t']} vs "
          f"{slots['halo_t']}", flush=True)
    rng = np.random.default_rng(0)
    rows = common.Rows(device)
    errs = {}
    for h, d in SHAPES:
        tag = f"h{h}d{d}"
        shape = (n, d) if h == 1 else (n, h, d)
        host = rng.standard_normal(shape, dtype=np.float32)
        q = torch.from_numpy(host).to(device).requires_grad_()
        qs = shard_halo_nodes(hg, mesh, host).requires_grad_()

        def fused(q):
            return ell_attention(de, se, q, q, q)

        def halo(q):
            return halo_attention_ell(hg, he, mesh, q, q, q)

        with torch.no_grad():
            errs[tag] = float((fused(q) - halo(qs)[:n]).abs().max())
            rows(f"fused_fwd[{tag}]", fused, q, edges=g.n_edges)
        rows(f"fused_bwd[{tag}]", common.sq_grad(fused), q, edges=g.n_edges)
        with torch.no_grad():
            rows(f"halo_fwd[{tag}]", halo, qs, edges=g.n_edges)
        rows(f"halo_bwd[{tag}]", common.sq_grad(halo), qs, edges=g.n_edges)

        x2 = qs.detach().reshape(1, hg.n_per, h * d)
        with torch.no_grad():
            rows(f"exchange_only[{tag}]", lambda x: (
                _Exchange(mesh, hg, x).ext(), _Exchange(mesh, hg, x).ext()),
                x2)
            flat = torch.from_numpy(rng.standard_normal(
                (1, he.total_rows + 1, h * d), dtype=np.float32)).to(device)
            rows(f"combine_only[{tag}]",
                 lambda f: take_raw(f, he.row_pos), flat)
        print(f"[{tag}] halo forward vs single card: max abs err "
              f"{errs[tag]:.3e} (gate {TOL:g})", flush=True)
    ok = all(err <= TOL for err in errs.values())
    return dict(device=common.where(device), n=n, e=g.n_edges,
                padded_slots=slots, ms=rows.ms, max_abs_err=errs, gate=TOL,
                ok=ok)


def main(argv=None) -> int:
    return common.run_main("exp_halo_accounting", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
