"""Host-only probe: the halo packing's shared bucket shapes against
per-shard private ladders.

Counterpart of scripts/exp_pack_private.py. For each configuration (the
graphs of ``exp_balance``, renumbered by ``degree_balanced_order`` for 8
parts) and each P in 2, 4, 8, the per-shard padded slots of both packings
(local dst rows and extended src rows, from the halo plan's host arrays,
``parallel/halo.py`` ``_plan_host`` with ``hub_threshold="auto"``) under

    shared_pow2     shared shapes (bucket rows the largest shard's), the
                    pow-2 ladder: what the mesh gets
    shared_train    shared shapes, the training ladder (``TRAIN_WIDTHS``)
    private_pow2    each shard packed on its own (shapes differ by shard:
                    the bound on what a shard-local shape could buy)
    private_train   both
    ideal           the true degrees, no padding

as waste = P · (largest shard's slots) / (the P = 1 slots of the same
ladder). Host figures; no card is touched.

Runs at the full size by default; ``--small`` or ``--device cpu`` at the
small graphs of ``exp_balance``.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.exp_pack_private [--small]
"""

from __future__ import annotations

import sys

import numpy as np

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.experiments.exp_balance import CONFIGS
from custom_op_benchmark_tpu_torch.graph import (
    DEFAULT_WIDTHS,
    TRAIN_WIDTHS,
    degree_balanced_order,
    random_graph,
    reorder_graph,
)
from custom_op_benchmark_tpu_torch.parallel.halo import _plan_host, _round_up

PAD = 8
DEVICES = (2, 4, 8)
LADDERS = (("pow2", DEFAULT_WIDTHS), ("train", TRAIN_WIDTHS))


def _ladder(widths, top):
    """``widths`` sorted, doubled up to ``top``."""
    widths = sorted(set(int(w) for w in widths))
    while widths[-1] < top:
        widths.append(widths[-1] * 2)
    return widths


def slots_for(deg, widths) -> int:
    """Padded slots of one shard's rows of degrees ``deg`` under
    ``widths`` (each bucket's rows rounded up to 8, slots = rows·width)."""
    widths = _ladder(widths, deg.max() if len(deg) else 1)
    bi = np.searchsorted(np.asarray(widths, np.int64), deg, side="left")
    cnt = np.bincount(bi, minlength=len(widths))
    return int(sum(_round_up(int(c), PAD) * w
                   for c, w in zip(cnt, widths) if c))


def shared_slots(deg_by_shard, widths, p) -> int:
    """Per-shard slots with shared shapes: each bucket's rows the largest
    shard's count."""
    widths = _ladder(widths, max((int(d.max()) for d in deg_by_shard
                                  if len(d)), default=1))
    wa = np.asarray(widths, np.int64)
    cnt = np.zeros((len(widths), p), np.int64)
    for s, deg in enumerate(deg_by_shard):
        cnt[:, s] = np.bincount(np.searchsorted(wa, deg, side="left"),
                                minlength=len(widths))
    return int(sum(_round_up(int(c), PAD) * w
                   for c, w in zip(cnt.max(axis=1), widths) if c))


def degrees(src, dst, e, p, n_per, e_pad):
    """Per shard, the row degrees of both packings (local dst rows,
    extended src rows) from the halo plan's host arrays."""
    _, src_ext, dst_loc = _plan_host(src, dst, e, p, n_per, PAD, e_pad,
                                     "auto")[:3]
    out = []
    for s in range(p):
        real = dst_loc[s] < n_per
        dl = np.bincount(dst_loc[s][real].astype(np.int64))
        se = np.bincount(src_ext[s][real].astype(np.int64))
        out.append((dl[dl > 0], se[se > 0]))
    return out


def analyze(g, device_counts=DEVICES) -> dict:
    """Waste of each packing for the renumbered graph ``g`` at each P."""
    n, e, e_pad = g.n_nodes, g.n_edges, g.num_edges_padded
    src = g.src.cpu().numpy()[:e]
    dst = g.dst.cpu().numpy()[:e]
    degs1 = degrees(src, dst, e, 1, n, e_pad)[0]
    base = {name: slots_for(degs1[0], w) + slots_for(degs1[1], w)
            for name, w in LADDERS}
    ideal1 = int(degs1[0].sum() + degs1[1].sum())
    rows = {"n": n, "e": int(e), "p1_slots": dict(base, ideal=ideal1),
            "per_p": []}
    for p in device_counts:
        degs = degrees(src, dst, e, p, -(-n // p), e_pad)
        rec = {"devices": p}
        for name, w in LADDERS:
            shared = (shared_slots([d[0] for d in degs], w, p)
                      + shared_slots([d[1] for d in degs], w, p))
            private = max(slots_for(d[0], w) + slots_for(d[1], w)
                          for d in degs)
            rec[f"shared_{name}"] = shared * p
            rec[f"private_{name}"] = private * p
            rec[f"waste_shared_{name}"] = shared * p / base[name]
            rec[f"waste_private_{name}"] = private * p / base[name]
        rec["ideal"] = int(max(d[0].sum() + d[1].sum() for d in degs) * p)
        rec["waste_ideal"] = rec["ideal"] / ideal1
        rows["per_p"].append(rec)
    return rows


def run(size: str = "full") -> dict:
    out = {}
    for name, n, e in CONFIGS[size]:
        g = random_graph(n, e, seed=0, power_law=True)
        g, _ = reorder_graph(g, degree_balanced_order(g, max(DEVICES)))
        out[name] = analyze(g)
        for rec in out[name]["per_p"]:
            print(f"{name} P={rec['devices']}: waste shared pow2 "
                  f"{rec['waste_shared_pow2']:.3f} train "
                  f"{rec['waste_shared_train']:.3f} | private pow2 "
                  f"{rec['waste_private_pow2']:.3f} train "
                  f"{rec['waste_private_train']:.3f} | ideal "
                  f"{rec['waste_ideal']:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    return common.run_host_main("exp_pack_private", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
