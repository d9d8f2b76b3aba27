"""The benchmark and validation suite: its power-law and grid regimes.

Counterparts of ``run_powerlaw_suite`` and ``run_grid_suite`` in
custom_op_benchmark_tpu/utils/bench_suite.py:

- **power law** (``--powerlaw``): a random graph with Zipf-skewed sources
  and no locality, the general-graph regime, packed into degree buckets
  (ELL). Every op of the family runs on the segment oracle and on the ELL
  path (packed-weight SpMM, the copy-SpMM on the CUDA kernel S3, fused
  attention, edge-bias attention single- and multi-head, fused GAT),
  forward and backward;
- **grid** (``--grid``): the 4-neighbour 2-D grid (locality-rich, no dense
  components), tile-aligned and cut into 128×128 tiles, where the tile
  strategy is meant to win: SpMM and dst-normalised attention, forward and
  backward, on the segment oracle and the tiled strategy. Its ELL rows and
  ``describe()`` wait for ROADMAP M5.

Each suite checks the strategies against each other with ``allclose`` at
the reference's ``RTOL = ATOL = 2e-3`` and times each row on the CUDA
device, with the roofline fractions of two byte models against the
measured copy bandwidth. The byte models are bounds computed from shapes
(``unique``: every node row and edge value moved once; ``refetch``: one
neighbour row per edge), not measured traffic.

The suites run on the CUDA device (``cuda_device()``, which raises where
there is none) unless the caller asks for the CPU: ``device="cpu"`` or a
case built there, and ``--device cpu`` on the command line, for the
``--small`` sizes only. On the CPU the checks run (the kernels' plain
versions stand in) and the rows are recorded as not measured: a CPU run
gives no device time.

Run:  python -m custom_op_benchmark_tpu_torch.utils.bench_suite --powerlaw [--small]
      python -m custom_op_benchmark_tpu_torch.utils.bench_suite --grid [--small]
      (add --device cpu to run a --small suite on the CPU)
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
    EllGraph,
    Graph,
    Reordering,
    TiledGraph,
    grid_graph,
    random_graph,
    reorder_graph,
    tile_aligned_order,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops import (
    edge_softmax,
    ell_attention,
    ell_copy_spmm,
    ell_dual,
    ell_edge_bias_attention,
    ell_gat_attention,
    ell_pack_weights,
    ell_spmm,
    gspmm,
    node_mul_edge,
    sddmm,
    tiled_attention,
    tiled_spmm,
    vector_spmm,
)
from custom_op_benchmark_tpu_torch.utils.benchlib import (
    bench_ms,
    hbm_bandwidth_bytes,
)
from custom_op_benchmark_tpu_torch.utils.device import cuda_device

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


def _grad_of_square_sum(fn):
    """``args → ∂(Σ fn(args)²)/∂args`` for tensor arguments, or for a
    :class:`PackedEdgeWeights` argument its two lists of tensors."""
    from custom_op_benchmark_tpu_torch.ops import PackedEdgeWeights

    def grad(*args):
        leaves, call = [], []
        for a in args:
            if isinstance(a, PackedEdgeWeights):
                src = [t.detach().requires_grad_() for t in a.src]
                dst = [t.detach().requires_grad_() for t in a.dst]
                leaves += src + dst
                call.append(PackedEdgeWeights(src=src, dst=dst))
            else:
                t = a.detach().requires_grad_()
                leaves.append(t)
                call.append(t)
        return torch.autograd.grad((fn(*call) ** 2).sum(), leaves)

    return grad


def _timer(records, dev, *, warmup, iters, repeats, edges):
    """The suites' ``bench(name, fn, *args, bytes_model)``: a timed row on
    a CUDA device, a "not measured" row elsewhere."""
    timed = dev.type == "cuda"
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
                       repeats=repeats, edges=edges)
        records.append({"bench": name, "time_s": rec.time_s,
                        "edges_per_s": rec.edges_per_s, "device": rec.device,
                        **rec.extra})

    return bench


# ---------------------------------------------------------------------------
# Power-law regime
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PowerLawCase:
    """The power-law suite's graph, its dual ELL packing (pow-2 ladder) and
    inputs, made from seed 0 in the reference's order."""

    g: Graph
    g_rev: Graph
    se: EllGraph
    de: EllGraph
    q: torch.Tensor        # (n, d)
    k: torch.Tensor
    v: torch.Tensor
    ed: torch.Tensor       # (E,) edge values, canonical order
    be: torch.Tensor       # (E, d) edge features
    qh4: torch.Tensor      # (n, 4, d/4) the multi-head edge-bias inputs
    kh4: torch.Tensor
    vh4: torch.Tensor
    beh: torch.Tensor      # (E, d/4)
    a_l: torch.Tensor      # (4, d/4) the GAT attention vectors
    a_r: torch.Tensor
    zf: torch.Tensor       # (n, 4, d/4)
    host_s: float          # seconds to build the graph and packing on the host

    @property
    def n(self) -> int:
        return self.g.n_nodes

    @property
    def e(self) -> int:
        return self.g.n_edges

    @property
    def d(self) -> int:
        return self.q.shape[1]


def powerlaw_case(n: int = 131072, e: int = 2_000_000, d: int = 128, *,
                  device=None) -> PowerLawCase:
    """``random_graph(n, e, seed=0, power_law=True)`` and ``ell_dual`` on
    the host, moved to ``device`` (default: the CUDA device); inputs as the
    reference draws them from ``np.random.default_rng(0)``."""
    device = cuda_device() if device is None else device
    t0 = time.perf_counter()
    g = random_graph(n, e, seed=0, power_law=True)
    se, de = ell_dual(g)
    host_s = time.perf_counter() - t0
    g, se, de = g.to(device), se.to(device), de.to(device)
    rng = np.random.default_rng(0)
    e_pad = g.num_edges_padded

    def t(*shape, uniform=False):
        a = rng.uniform(size=shape) if uniform else rng.normal(size=shape)
        return torch.from_numpy(a.astype(np.float32)).to(device)

    q, k, v = t(n, d), t(n, d), t(n, d)
    ed = t(e_pad, uniform=True)
    be = t(e_pad, d)
    dh = max(d // 4, 1)
    qh4, kh4, vh4 = t(n, 4, dh), t(n, 4, dh), t(n, 4, dh)
    beh = t(e_pad, dh)
    a_l, a_r = t(4, dh), t(4, dh)
    zf = t(n, 4, dh)
    return PowerLawCase(g=g, g_rev=g.reverse(), se=se, de=de, q=q, k=k, v=v,
                        ed=ed, be=be, qh4=qh4, kh4=kh4, vh4=vh4, beh=beh,
                        a_l=a_l, a_r=a_r, zf=zf, host_s=host_s)


def powerlaw_byte_models(case: PowerLawCase) -> dict:
    """Bounds on the bytes a row moves, f32: ``unique`` moves every node row
    and edge value once, ``refetch`` one neighbour row per edge. The
    backward models count about five edge sweeps; edge-bias rows add their
    (E, d) features (read once forward; read, and written as a gradient,
    backward)."""
    n, e, d = case.n, case.e, case.d
    feat = e * d * 4.0
    attn = {"unique": 4 * n * d * 4.0, "refetch": (2 * e * d + 2 * n * d) * 4.0}
    attn_bwd = {"unique": 8 * n * d * 4.0,
                "refetch": (5 * e * d + 5 * n * d) * 4.0}
    return {
        "spmm": {"unique": (2 * n * d + e) * 4.0,
                 "refetch": (e * d + n * d + e) * 4.0},
        "spmm_bwd": {"unique": (4 * n * d + 2 * e) * 4.0,
                     "refetch": (2 * e * d + 2 * n * d + 2 * e) * 4.0},
        "copy": {"unique": 2 * n * d * 4.0,
                 "refetch": (e * d + n * d) * 4.0},
        "attn": attn,
        "attn_bwd": attn_bwd,
        "eb": {k: b + feat for k, b in attn.items()},
        "eb_bwd": {k: b + 2 * feat for k, b in attn_bwd.items()},
    }


def segment_powerlaw_attention(case: PowerLawCase, q, k, v, be=None):
    """The reference's composed segment attention: ``(sddmm(k, q) [+
    node_mul_edge(q, be)]) / √d`` → dst softmax (padded edges zeroed) →
    vector_spmm over the reversed graph."""
    g = case.g
    s = sddmm(g, k, q, impl="xla")
    if be is not None:
        s = s + node_mul_edge(g, q, be, impl="xla")
    a = edge_softmax(g, s / math.sqrt(q.shape[-1]), by="dst", impl="xla")
    em = g.edge_mask if a.dim() == 1 else g.edge_mask[:, None]
    a = torch.where(em, a, 0.0)
    return vector_spmm(case.g_rev, a[g.csc_perm.long()], v, impl="xla")


def segment_powerlaw_gat(case: PowerLawCase, a_l, a_r, z):
    """The reference's composed GAT: LeakyReLU(0.2) additive scores → dst
    softmax → vector_spmm over the reversed graph."""
    g, n = case.g, z.shape[0]
    el = torch.einsum("nhd,hd->nh", z, a_l)
    er = torch.einsum("nhd,hd->nh", z, a_r)
    s = (el[g.src.long().clamp(max=n - 1)]
         + er[g.dst.long().clamp(max=n - 1)])
    s = torch.where(s > 0, s, 0.2 * s)
    a = edge_softmax(g, s, by="dst", impl="xla")
    a = torch.where(g.edge_mask[:, None], a, 0.0)
    return vector_spmm(case.g_rev, a[g.csc_perm.long()], z, impl="xla")


def run_powerlaw_suite(n=131072, e=2_000_000, d=128, *, device=None,
                       case=None, warmup=1, iters=5, repeats=3):
    """Segment oracle against the ELL path on a power-law graph: every row
    and gate of the reference's suite, on ``case``'s device, else on
    ``device`` (default: the CUDA device). Returns (records, all_ok). Times
    the rows only on a CUDA device."""
    if case is None:
        case = powerlaw_case(n, e, d, device=device)
    dev = case.q.device
    records, ok = [], True
    g, se, de = case.g, case.se, case.de
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"Power law (n={case.n}, e={case.e}, d={case.d}; ELL waste "
          f"{se.padding_waste:.2f}x src / {de.padding_waste:.2f}x dst) on "
          f"{where}")
    models = powerlaw_byte_models(case)
    bench = _timer(records, dev, warmup=warmup, iters=iters,
                   repeats=repeats, edges=case.e)
    q, k, v, ed, be = case.q, case.k, case.v, case.ed, case.be

    def seg_spmm(ed, x):
        return vector_spmm(g, ed, x, impl="xla")

    def ell_sp(w, x):
        return ell_spmm(se, de, w, x)

    bench("pl_spmm/xla_segment", seg_spmm, ed, q, bytes_model=models["spmm"])
    bench("pl_spmm/ell", ell_sp, ed, q, bytes_model=models["spmm"])
    wpk = ell_pack_weights(se, de, ed)
    bench("pl_spmm_packed/ell", ell_sp, wpk, q, bytes_model=models["spmm"])
    bench("pl_spmm_packed_bwd/ell", _grad_of_square_sum(ell_sp), wpk, q,
          bytes_model=models["spmm_bwd"])
    bench("pl_spmm_bwd/xla_segment", _grad_of_square_sum(seg_spmm), ed, q,
          bytes_model=models["spmm_bwd"])
    ok &= _check("pl packed spmm vs segment", ell_sp(wpk, q),
                 seg_spmm(ed, q)[: case.n], records)
    del wpk

    # Unweighted aggregation (the GCN/SAGE inner loop): S3 on the ELL path.
    def seg_copy(x):
        return gspmm(g, "copy_lhs", "sum", lhs=x, lhs_target="u", to="dst")

    def ell_copy(x):
        return ell_copy_spmm(de, se, x)

    bench("pl_copy_spmm/xla_segment", seg_copy, q, bytes_model=models["copy"])
    bench("pl_copy_spmm/ell", ell_copy, q, bytes_model=models["copy"])
    ok &= _check("pl copy_spmm ell vs segment", ell_copy(q), seg_copy(q),
                 records)

    def seg_attn(q, k, v):
        return segment_powerlaw_attention(case, q, k, v)

    def ell_attn(q, k, v):
        return ell_attention(de, se, q, k, v)

    bench("pl_attention/xla_composed", seg_attn, q, k, v,
          bytes_model=models["attn"])
    bench("pl_attention/ell_fused", ell_attn, q, k, v,
          bytes_model=models["attn"])
    bench("pl_attention_bwd/xla_composed", _grad_of_square_sum(seg_attn),
          q, k, v, bytes_model=models["attn_bwd"])
    bench("pl_attention_bwd/ell_fused", _grad_of_square_sum(ell_attn),
          q, k, v, bytes_model=models["attn_bwd"])

    # Edge-bias (NodeMulEdge) attention, the transformer's edge_feat path.
    def seg_eb(q, k, v, be):
        return segment_powerlaw_attention(case, q, k, v, be)

    def ell_eb(q, k, v, be):
        return ell_edge_bias_attention(de, se, q, k, v, be)

    bench("pl_eb_attention/xla_composed", seg_eb, q, k, v, be,
          bytes_model=models["eb"])
    bench("pl_eb_attention/ell_fused", ell_eb, q, k, v, be,
          bytes_model=models["eb"])
    bench("pl_eb_attention_bwd/ell_fused", _grad_of_square_sum(ell_eb),
          q, k, v, be, bytes_model=models["eb_bwd"])
    be_pk = ell_pack_weights(se, de, be)
    bench("pl_eb_attention_packed/ell_fused", ell_eb, q, k, v, be_pk,
          bytes_model=models["eb"])
    bench("pl_eb_attention_packed_bwd/ell_fused", _grad_of_square_sum(ell_eb),
          q, k, v, be_pk, bytes_model=models["eb_bwd"])
    del be_pk
    ok &= _check("pl fused edge-bias attention vs composed",
                 ell_eb(q, k, v, be), seg_eb(q, k, v, be), records)

    # Multi-head edge bias at h = 4 (the same e·d as the rows above).
    qh, kh, vh, beh = case.qh4, case.kh4, case.vh4, case.beh
    bench("pl_eb_attention_mh/ell_fused", ell_eb, qh, kh, vh, beh,
          bytes_model=models["eb"])
    bench("pl_eb_attention_mh_bwd/ell_fused", _grad_of_square_sum(ell_eb),
          qh, kh, vh, beh, bytes_model=models["eb_bwd"])
    beh_pk = ell_pack_weights(se, de, beh)
    bench("pl_eb_attention_mh_packed/ell_fused", ell_eb, qh, kh, vh, beh_pk,
          bytes_model=models["eb"])
    bench("pl_eb_attention_mh_packed_bwd/ell_fused",
          _grad_of_square_sum(ell_eb), qh, kh, vh, beh_pk,
          bytes_model=models["eb_bwd"])
    y_raw = ell_eb(qh, kh, vh, beh)
    ok &= _check("pl fused mh edge-bias attention vs composed", y_raw,
                 seg_eb(qh, kh, vh, beh), records)
    ok &= _check("pl fused mh edge-bias packed vs raw",
                 ell_eb(qh, kh, vh, beh_pk), y_raw, records)
    del beh_pk, y_raw

    # GAT core (additive attention), h = 4 heads.
    def seg_gat(a_l, a_r, z):
        return segment_powerlaw_gat(case, a_l, a_r, z)

    def ell_gat(a_l, a_r, z):
        return ell_gat_attention(de, se, a_l, a_r, z)

    gat_args = (case.a_l, case.a_r, case.zf)
    bench("pl_gat/xla_composed", seg_gat, *gat_args,
          bytes_model=models["attn"])
    bench("pl_gat/ell_fused", ell_gat, *gat_args, bytes_model=models["attn"])
    bench("pl_gat_bwd/ell_fused", _grad_of_square_sum(ell_gat), *gat_args,
          bytes_model=models["attn_bwd"])
    ok &= _check("pl fused ell GAT vs composed", ell_gat(*gat_args),
                 seg_gat(*gat_args), records)
    ok &= _check("pl fused ell attention vs composed", ell_attn(q, k, v),
                 seg_attn(q, k, v), records)
    return records, ok


# ---------------------------------------------------------------------------
# Grid regime
# ---------------------------------------------------------------------------

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
              device=None) -> GridCase:
    """Build the grid, its tile-aligned order and 128×128 tiling on the
    host, then move them to ``device`` (default: the CUDA device); inputs
    as the reference makes them (``np.random.default_rng(0)``: normal q,
    then uniform edge values)."""
    device = cuda_device() if device is None else device
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
    """The grid suite on ``case``'s device, else on ``device`` (default:
    the CUDA device). Returns (records, all_ok). Times the rows only on a
    CUDA device."""
    if case is None:
        case = grid_case(rows, cols, d, device=device)
    dev = case.q.device
    records, ok = [], True
    n, e = case.n, case.e
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"Grid {rows}x{cols} (n={n}, e={e}, T={case.tg.num_tiles}, "
          f"d={case.d}) on {where}")
    models = byte_models(case)
    bench = _timer(records, dev, warmup=warmup, iters=iters,
                   repeats=repeats, edges=e)

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
    ap.add_argument("--powerlaw", action="store_true",
                    help="run the power-law (general-graph) suite")
    ap.add_argument("--grid", action="store_true",
                    help="run the grid (locality-rich) suite")
    ap.add_argument("--small", action="store_true",
                    help="the power-law suite at n=2048, e=16384, d=32, or "
                    "a 48x48 grid at d=32")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA device, and fail "
                    "without one); cpu runs the checks with the kernels' "
                    "plain versions and times nothing, --small only")
    ap.add_argument("--json", type=str, default=None,
                    help="write the records to this file")
    args = ap.parse_args(argv)
    if args.powerlaw == args.grid:
        ap.error("pick one suite: --powerlaw or --grid (the clique suite "
                 "waits for ROADMAP M5 and M13)")
    if args.device == "cpu" and not args.small:
        print("bench_suite: the full-size suites run on the CUDA device "
              "only", file=sys.stderr)
        return 1
    try:
        device = (torch.device("cpu") if args.device == "cpu"
                  else cuda_device())
    except RuntimeError as err:
        print(f"bench_suite: {err} (pass --device cpu to run a --small suite "
              "on the CPU)", file=sys.stderr)
        return 1
    if args.powerlaw:
        size = (2048, 16384, 32) if args.small else ()
        records, ok = run_powerlaw_suite(*size, device=device)
    else:
        size = (48, 48, 32) if args.small else ()
        records, ok = run_grid_suite(*size, device=device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"suite_ok": ok,
                      "checks": sum(1 for r in records if "check" in r),
                      "benches": sum(1 for r in records if "bench" in r)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
