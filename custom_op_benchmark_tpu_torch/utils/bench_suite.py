"""The benchmark and validation suite: so far its grid regime.

Counterpart of ``run_grid_suite`` in custom_op_benchmark_tpu/utils/
bench_suite.py: the 4-neighbour 2-D grid (locality-rich, no dense
components), tile-aligned and cut into 128×128 tiles, where the tile
strategy is meant to win. For SpMM and for dst-normalised attention,
forward and backward, it runs the segment oracle and the tiled strategy,
checks them against each other with ``allclose`` at the reference's
``RTOL = ATOL = 2e-3``, and times each on the CUDA device with the
roofline fractions of two byte models against the measured copy
bandwidth. The ELL rows and ``describe()`` wait for ROADMAP M8 and M5.

On the CPU the checks run (the kernels' plain versions stand in) and the
rows are recorded as not measured: a CPU run gives no device time.

Run:  python -m custom_op_benchmark_tpu_torch.utils.bench_suite --grid [--small]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph import (
    Graph,
    Reordering,
    TiledGraph,
    grid_graph,
    reorder_graph,
    tile_aligned_order,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops import (
    edge_softmax,
    sddmm,
    tiled_attention,
    tiled_spmm,
    vector_spmm,
)
from custom_op_benchmark_tpu_torch.utils.benchlib import (
    bench_ms,
    hbm_bandwidth_bytes,
)

# The reference's gate (wrapper.py's allclose defaults, loosened for f32
# sums taken in other orders over up to 5 tiles of 128 products).
RTOL, ATOL = 2e-3, 2e-3


def _check(name, a, b, records):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    ok = bool(torch.allclose(a, b, rtol=RTOL, atol=ATOL))
    diff = float((a - b).abs().max()) if a.numel() else 0.0
    if not ok:
        print(f"  ALLCLOSE FAIL: {name} (max abs diff {diff:.3e})",
              file=sys.stderr)
    records.append({"check": name, "ok": ok, "max_diff": diff})
    return ok


@dataclasses.dataclass
class GridCase:
    """The grid suite's graph, views and inputs, made from seed 0."""

    g: Graph
    g_rev: Graph
    ro: Reordering
    tg: TiledGraph
    q: torch.Tensor        # (n, d) node features
    ed: torch.Tensor       # (E,) edge values, canonical order
    vals: torch.Tensor     # (T, 128, 128) the edge values on the tiles
    q_al: torch.Tensor     # q in the tile-aligned order
    host_s: float          # seconds to build the graph and views on the host

    @property
    def n(self) -> int:
        return self.g.n_nodes

    @property
    def e(self) -> int:
        return self.g.n_edges

    @property
    def d(self) -> int:
        return self.q.shape[1]


def grid_case(rows: int = 1024, cols: int = 1024, d: int = 128, *,
              device="cpu") -> GridCase:
    """Build the grid, its tile-aligned order and 128×128 tiling on the
    host, then move them to ``device``; inputs as the reference makes them
    (``np.random.default_rng(0)``: normal q, then uniform edge values)."""
    t0 = time.perf_counter()
    g = grid_graph(rows, cols)
    ro = tile_aligned_order(g, block=128)
    g_al, eperm = reorder_graph(g, ro)
    tg = tile_graph(g_al, 128, 128)
    host_s = time.perf_counter() - t0
    g, tg = g.to(device), tg.to(device)
    tg.transpose()          # the dst-normalised attention's view, cached
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(g.n_nodes, d)).astype(np.float32))
    ed = torch.from_numpy(
        rng.uniform(size=g.num_edges_padded).astype(np.float32))
    q, ed = q.to(device), ed.to(device)
    eperm_t = torch.from_numpy(eperm.astype(np.int64)).to(device)
    vals = tg.scatter_edges(ed[eperm_t])[: tg.num_tiles]
    return GridCase(g=g, g_rev=g.reverse(), ro=ro, tg=tg, q=q, ed=ed,
                    vals=vals, q_al=ro.scatter_nodes(q), host_s=host_s)


def segment_attention(case: GridCase, q: torch.Tensor) -> torch.Tensor:
    """The composed segment attention of the reference's grid suite:
    sddmm → edge_softmax(by="dst") → vector_spmm over the reversed graph."""
    g = case.g
    s = sddmm(g, q, q, impl="xla") / math.sqrt(q.shape[-1])
    a = edge_softmax(g, s, by="dst", impl="xla")
    return vector_spmm(case.g_rev, a[g.csc_perm.long()], q, impl="xla")


def tiled_grid_attention(case: GridCase, q_al: torch.Tensor) -> torch.Tensor:
    return tiled_attention(case.tg, q_al, q_al, q_al, normalize="dst")


def byte_models(case: GridCase) -> dict:
    """The reference's two bounds, f32 (4 bytes an element): ``unique``
    touches every live node row once plus the edge values once (perfect
    reuse); ``refetch`` fetches one neighbour row per edge (no reuse). The
    backward models count about five edge sweeps."""
    n, e, d = case.n, case.e, case.d
    return {
        "spmm": {"unique": (2 * n * d + e) * 4.0,
                 "refetch": (e * d + n * d + e) * 4.0},
        "attn": {"unique": 4 * n * d * 4.0,
                 "refetch": (2 * e * d + 2 * n * d) * 4.0},
        "attn_bwd": {"unique": 8 * n * d * 4.0,
                     "refetch": (5 * e * d + 5 * n * d) * 4.0},
    }


def run_grid_suite(rows=1024, cols=1024, d=128, *, device=None, case=None,
                   warmup=1, iters=5, repeats=3):
    """Returns (records, all_ok). Times the rows only on a CUDA device."""
    if case is None:
        case = grid_case(rows, cols, d, device=device or "cpu")
    dev = case.q.device
    timed = dev.type == "cuda"
    records, ok = [], True
    n, e = case.n, case.e
    where = torch.cuda.get_device_name(dev) if timed else dev
    print(f"Grid {rows}x{cols} (n={n}, e={e}, T={case.tg.num_tiles}, "
          f"d={case.d}) on {where}")
    models = byte_models(case)
    peak = hbm_bandwidth_bytes(dev) if timed else None
    if timed:
        records.append({"copy_bandwidth_bytes_per_s": peak})

    def bench(name, fn, *args, bytes_model):
        if not timed:
            records.append({"bench": name, "time_s": None})
            print(f"  {name:40s} not measured (no CUDA device)")
            return
        rec = bench_ms({}, name, fn, *args, bytes_models=bytes_model,
                       peak=peak, warmup=warmup, iters=iters,
                       repeats=repeats, edges=e)
        records.append({"bench": name, "time_s": rec.time_s,
                        "edges_per_s": rec.edges_per_s, "device": rec.device,
                        **rec.extra})

    g, ro, tg = case.g, case.ro, case.tg

    def seg_spmm(ed, x):
        return vector_spmm(g, ed, x, impl="xla")

    def til_spmm(v, x):
        return tiled_spmm(tg, v, x, out_rows=ro.n_new)

    bench("grid_spmm/xla_segment", seg_spmm, case.ed, case.q,
          bytes_model=models["spmm"])
    bench("grid_spmm/tiled", til_spmm, case.vals, case.q_al,
          bytes_model=models["spmm"])
    y0 = seg_spmm(case.ed, case.q)
    ok &= _check("grid spmm tiled vs segment",
                 ro.gather_nodes(til_spmm(case.vals, case.q_al)), y0, records)
    del y0

    def seg_attn(q):
        return segment_attention(case, q)

    def til_attn(q_al):
        return tiled_grid_attention(case, q_al)

    def til_attn_grad(q_al):
        q_al = q_al.detach().requires_grad_()
        (til_attn(q_al) ** 2).sum().backward()
        return q_al.grad

    bench("grid_attention/xla_composed", seg_attn, case.q,
          bytes_model=models["attn"])
    bench("grid_attention/tiled", til_attn, case.q_al,
          bytes_model=models["attn"])
    bench("grid_attention_bwd/tiled", til_attn_grad, case.q_al,
          bytes_model=models["attn_bwd"])
    y0 = seg_attn(case.q)
    ok &= _check("grid attention tiled vs composed",
                 ro.gather_nodes(til_attn(case.q_al)), y0, records)
    del y0
    q = case.q.detach().requires_grad_()
    (seg_attn(q) ** 2).sum().backward()
    ok &= _check("grid attention grad tiled vs composed",
                 ro.gather_nodes(til_attn_grad(case.q_al)), q.grad, records)
    return records, ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", action="store_true",
                    help="run the grid (locality-rich) suite")
    ap.add_argument("--small", action="store_true",
                    help="a 48x48 grid at d=32 (runs on the CPU too)")
    ap.add_argument("--json", type=str, default=None,
                    help="write the records to this file")
    args = ap.parse_args(argv)
    if not args.grid:
        ap.error("only the grid suite is ported so far (--grid); the clique "
                 "and power-law suites wait for ROADMAP M5, M8 and M13")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.small:
        records, ok = run_grid_suite(48, 48, 32, device=device)
    else:
        if device != "cuda":
            print("bench_suite: the full grid suite needs a CUDA device",
                  file=sys.stderr)
            return 1
        records, ok = run_grid_suite(device=device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"suite_ok": ok,
                      "checks": sum(1 for r in records if "check" in r),
                      "benches": sum(1 for r in records if "bench" in r)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
