"""Host-only probe: the per-shard memory budget of the halo plan at
ogbn-papers100M's size.

Counterpart of scripts/papers100m_budget.py. The plan is built on the host
(``parallel/halo.py`` ``plan_stats``: the numpy plan and both shared-shape
packings a P-shard mesh would get) for a papers100M-shaped power-law
synthetic at ``--scale`` (default 1/10: 11.1M nodes, 161.6M edges),
renumbered by ``degree_balanced_order``, at P = 16 and 64. From it come
the ratios that do not depend on the graph's size:

    halo_frac     (P·M + (P−1)·K) / n_per, exchanged rows per owned row
    slots_ratio   P·pack_slots / e, padded slots per edge
    interior      the share of interior rows
    hub_frac      hubs per owned row

and from those a plan at the full size (n = 111,059,956, e =
1,615,685,872, 128-d features) goes through ``parallel/budget.py``'s
``budget_table`` (a GAT of 4 heads of 32, 2 layers; bf16 and f32, remat
on and off). Each row says whether a shard fits the card's memory
(``budget.card_bytes``) where a card is present, and is null where there
is none. Host figures otherwise.

Runs at ``--scale`` by default; ``--small`` or ``--device cpu`` at 1/10,000.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.papers100m_budget [--scale S | --small]
"""

from __future__ import annotations

import sys
import time

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import (
    degree_balanced_order,
    random_graph,
    reorder_graph,
)
from custom_op_benchmark_tpu_torch.parallel.budget import budget_table
from custom_op_benchmark_tpu_torch.parallel.halo import PlanStats, plan_stats

PAPERS_N = 111_059_956
PAPERS_E = 1_615_685_872
PAPERS_F = 128
DEVICE_COUNTS = (16, 64)
SCALE = {"full": 0.1, "small": 1e-4}


def plan_ratios(n, e, p) -> dict:
    """The size-free ratios of the balanced halo plan of a power-law
    graph of ``n`` nodes and ``e`` edges on ``p`` shards."""
    t0 = time.perf_counter()
    g = random_graph(n, e, seed=0, power_law=True)
    g, _ = reorder_graph(g, degree_balanced_order(g, p))
    build_s = time.perf_counter() - t0
    n2 = g.n_nodes
    src = g.src.numpy()[: g.n_edges]
    dst = g.dst.numpy()[: g.n_edges]
    t0 = time.perf_counter()
    st = plan_stats(src, dst, n2, g.n_edges, p, -(-n2 // p),
                    g.num_edges_padded, hub_threshold="auto")
    return dict(graph_seconds=build_s,
                plan_seconds=time.perf_counter() - t0, n=n2,
                e=int(g.n_edges), p=p, halo_frac=st.halo_fraction,
                slots_ratio=st.pack_slots * p / g.n_edges,
                interior_frac=st.interior_frac, n_hub=st.n_hub,
                hub_frac=st.n_hub / max(st.n_per, 1))


def full_scale_stats(r, p) -> PlanStats:
    """A plan at papers100M's size from the ratios ``r``."""
    n_per = -(-PAPERS_N // p)
    n_hub = int(r["hub_frac"] * n_per)
    m = max(int((r["halo_frac"] * n_per - (p - 1) * n_hub) / p), 0)
    return PlanStats(num_parts=p, n_per=n_per, halo=m, n_hub=n_hub,
                     edges_per_part=-(-PAPERS_E // p),
                     pack_slots=int(r["slots_ratio"] * PAPERS_E / p),
                     interior_frac=r["interior_frac"])


def run(scale: float) -> dict:
    ratios, st_by_p = {}, {}
    for p in DEVICE_COUNTS:
        r = plan_ratios(int(PAPERS_N * scale), int(PAPERS_E * scale), p)
        print(f"P={p} scale={scale:g}: halo_frac {r['halo_frac']:.4f} "
              f"slots_ratio {r['slots_ratio']:.4f} interior "
              f"{r['interior_frac']:.4f} hubs {r['n_hub']} (graph "
              f"{r['graph_seconds']:.1f} s, plan {r['plan_seconds']:.1f} s)",
              flush=True)
        ratios[p] = r
        st_by_p[p] = full_scale_stats(r, p)
    rows = budget_table(st_by_p, feat_dim=PAPERS_F, heads=4, head_dim=32,
                        num_layers=2)
    for row in rows:
        print(f"P={row['devices']} {row['dtype']} remat={row['remat']}: "
              f"{row['total_gb']} GB a shard, fits the card: "
              f"{row['fits_card']}", flush=True)
    return dict(target="ogbn-papers100M", full_n=PAPERS_N, full_e=PAPERS_E,
                feat_dim=PAPERS_F, scale=scale, ratios=ratios, budget=rows)


def main(argv=None) -> int:
    ap = common.parser(__doc__)
    ap.add_argument("--scale", type=float, default=SCALE["full"],
                    help="the synthetic's share of papers100M's size "
                    "(default 0.1)")
    args = ap.parse_args(argv)
    small = args.small or args.device == "cpu"
    common.emit("papers100m_budget",
                run(SCALE["small"] if small else args.scale))
    return 0


if __name__ == "__main__":
    sys.exit(main())
