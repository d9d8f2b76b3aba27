"""Host-only probe: the halo plan's padded slots under the cluster
renumbering and the degree-balanced one.

Counterpart of scripts/exp_balance.py. For each configuration (a 65,536-
node, 1M-edge power-law graph and an arxiv-sized one, 169,343 nodes and
2,516,000 edges) and each renumbering (``graph/cluster.py``'s
``cluster_order`` and ``degree_balanced_order``, both for 8 parts), the
halo plan's static numbers (``parallel/halo.py`` ``plan_stats`` with
``hub_threshold="auto"``) at P = 2, 4 and 8: padded slots of both
packings, waste(P) = pack_slots(P)·P / pack_slots(1) of the same
renumbering, the halo rows, hubs and halo fraction. Host figures; no card
is touched.

Runs at the full size by default; ``--small`` or ``--device cpu`` at
4,096 nodes and 40,000 edges and 8,192 nodes and 80,000 edges.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_balance [--small]
"""

from __future__ import annotations

import sys

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import (
    degree_balanced_order,
    random_graph,
    reorder_graph,
)
from custom_op_benchmark_tpu_torch.graph.cluster import cluster_order
from custom_op_benchmark_tpu_torch.parallel.halo import plan_stats

CONFIGS = {
    "full": (("powerlaw_1m", 65536, 1_000_000),
             ("arxiv_gat", 169_343, 2_516_000)),
    "small": (("powerlaw_40k", 4096, 40_000),
              ("powerlaw_80k", 8192, 80_000)),
}
DEVICES = (2, 4, 8)
ORDERS = {"cluster": cluster_order, "balanced": degree_balanced_order}


def stats_for(g, p):
    """``plan_stats`` of ``g`` on P = ``p`` shards, hubs at "auto"."""
    src = g.src.cpu().numpy()[: g.n_edges]
    dst = g.dst.cpu().numpy()[: g.n_edges]
    return plan_stats(src, dst, g.n_nodes, g.n_edges, p, -(-g.n_nodes // p),
                      g.num_edges_padded, hub_threshold="auto")


def analyze(g0, devices=DEVICES, parts=None) -> dict:
    """Each renumbering (for ``parts`` parts, default the most devices) of
    ``g0``: its P = 1 padded slots and, for each P in ``devices``, the
    plan's numbers."""
    parts = parts or max(devices)
    rows = {}
    for label, order_fn in ORDERS.items():
        g, _ = reorder_graph(g0, order_fn(g0, parts))
        base = stats_for(g, 1).pack_slots
        per_p = {}
        for p in devices:
            st = stats_for(g, p)
            per_p[p] = dict(pack_slots=st.pack_slots,
                            waste=st.pack_slots * p / base, halo=st.halo,
                            n_hub=st.n_hub, halo_fraction=st.halo_fraction)
        rows[label] = dict(pack_slots_p1=base, per_p=per_p)
    return rows


def run(size: str = "full") -> dict:
    out = {}
    for name, n, e in CONFIGS[size]:
        out[name] = analyze(random_graph(n, e, seed=0, power_law=True))
        for label, rec in out[name].items():
            for p, st in rec["per_p"].items():
                print(f"{name} {label} P={p}: waste {st['waste']:.3f} halo "
                      f"{st['halo']} hubs {st['n_hub']} halo fraction "
                      f"{st['halo_fraction']:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    return common.run_host_main("exp_balance", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
