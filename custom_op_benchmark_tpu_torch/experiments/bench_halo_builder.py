"""Host-only probe: the halo plan and its ELL packing built at P = 64 on a
100M-edge graph.

Counterpart of scripts/bench_halo_builder.py. The graph has clustered
locality: 90 % of edges take a source in the owner's node range of their
destination, 10 % a uniform one (the halo). It times, by the host clock:
the edges' draw, ``from_coo`` (the dual CSR), ``halo_graph`` (the plan)
and ``halo_ell`` (the packing) on a local mesh of 64 shards on the CPU,
and reports the halo rows, the halo fraction, the bucket count and the
interior row share. Host figures; no card is touched.

The full size is 8,388,608 nodes and 100M edges. ``--small`` or
``--device cpu`` cuts it to 65,536 nodes and 1M edges at P = 64; the
record's ``cuts`` lists every cut from the full size.

Run:  python -m custom_op_benchmark_tpu_torch.experiments.bench_halo_builder [--small]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.experiments import common
from custom_op_benchmark_tpu_torch.graph import from_coo
from custom_op_benchmark_tpu_torch.parallel import (
    halo_ell,
    halo_graph,
    make_mesh,
)

P = 64
SIZES = {"full": (1 << 23, 100_000_000), "small": (1 << 16, 1_000_000)}
LOCAL_FRAC = 0.9


def clustered_edges(n, e, p, rng):
    """(src, dst) with 90 % of sources in the owner's range of dst."""
    n_per = -(-n // p)
    dst = rng.integers(0, n, size=e)
    owner = dst // n_per
    local = rng.random(e) < LOCAL_FRAC
    src = np.where(local, owner * n_per + rng.integers(0, n_per, size=e),
                   rng.integers(0, n, size=e))
    np.minimum(src, n - 1, out=src)
    return src, dst


def run(size: str = "full") -> dict:
    n, e = SIZES[size]
    full_n, full_e = SIZES["full"]
    cuts = [] if size == "full" else [
        f"nodes {full_n:,} -> {n:,}", f"edges {full_e:,} -> {e:,}"]
    times = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        times[key] = time.perf_counter() - t0
        print(f"{key}: {times[key]:.2f} s", flush=True)
        return out

    rng = np.random.default_rng(0)
    src, dst = timed("edge_gen_s", lambda: clustered_edges(n, e, P, rng))
    g = timed("from_coo_s", lambda: from_coo(src, dst, n_nodes=n))
    del src, dst
    mesh = make_mesh((P,), ("edge",), device=torch.device("cpu"))
    hg = timed("halo_graph_s", lambda: halo_graph(g, mesh))
    he = timed("halo_ell_s", lambda: halo_ell(hg, mesh))
    total = sum(int(r.shape[1]) for r in he.rows_b)
    result = dict(p=P, n=n, e=e, cuts=cuts, **times, halo=int(hg.halo),
                  halo_fraction=hg.halo_fraction, buckets=len(he.widths),
                  boundary_rows=int(sum(he.n_bnd)), rows=total,
                  interior_row_frac=1 - sum(he.n_bnd) / max(total, 1),
                  halo_rows_t=int(he.halo_rows_t),
                  plan_route=hg.host.route, pack_route=he.route)
    print(f"halo rows {hg.halo}, halo fraction {hg.halo_fraction:.3f}, "
          f"{len(he.widths)} buckets, interior rows "
          f"{result['interior_row_frac']:.4f}", flush=True)
    return result


def main(argv=None) -> int:
    return common.run_host_main("bench_halo_builder", __doc__, run, argv)


if __name__ == "__main__":
    sys.exit(main())
