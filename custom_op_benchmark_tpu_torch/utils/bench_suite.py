"""The benchmark and validation suite: its clique, power-law and grid
regimes.

Counterparts of ``run_suite``, ``run_powerlaw_suite`` and
``run_grid_suite`` in custom_op_benchmark_tpu/utils/bench_suite.py:

- **cliques** (the default): the reference workload, 512 disjoint
  30-cliques, where every op of the family runs through the dense bmm
  view, the segment oracle, the tile kernels (K1–K4, also on the
  tile-aligned order) and the dense blocks, forward and backward, single
  head at d = 1024 and 8 heads of 64, under the reference's row and check
  names;
- **power law** (``--powerlaw``): a random graph with Zipf-skewed sources
  and no locality, the general-graph regime, packed into degree buckets
  (ELL). Every op of the family runs on the segment oracle and on the ELL
  path (packed-weight SpMM, the copy-SpMM on the CUDA kernel S3, fused
  attention, edge-bias attention single- and multi-head, fused GAT),
  forward and backward;
- **grid** (``--grid``): the 4-neighbour 2-D grid (locality-rich, no dense
  components), tile-aligned and cut into 128×128 tiles, where the tile
  strategy is meant to win: SpMM and dst-normalised attention, forward and
  backward, on the segment oracle and the tiled strategy, with the
  strategy ``describe()`` recommends for the graph as its first record.

Each suite checks the strategies against each other with ``allclose`` at
the reference's ``RTOL = ATOL = 2e-3`` (dense oracles with TF32 off, the
reference's ``"highest"`` precision) and times each row on the CUDA device
(``benchlib.bench_fn``: CUDA events, median of repeats). The power-law and
grid rows add the roofline fractions of two byte models against the
measured copy bandwidth. The byte models are bounds computed from shapes
(``unique``: every node row and edge value moved once; ``refetch``: one
neighbour row per edge), not measured traffic.

The suites run on the CUDA device (``cuda_device()``, which raises where
there is none) unless the caller asks for the CPU: ``device="cpu"`` or a
case built there, and ``--device cpu`` on the command line, for the
``--small`` sizes only. On the CPU the checks run (the kernels' plain
versions stand in) and the rows are recorded as not measured: a CPU run
gives no device time.

Run:  python -m custom_op_benchmark_tpu_torch.utils.bench_suite [--small]
      python -m custom_op_benchmark_tpu_torch.utils.bench_suite --powerlaw [--small]
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
    block_graph,
    clique_batch,
    grid_graph,
    random_graph,
    reorder_graph,
    tile_aligned_order,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops import (
    block_attention,
    block_sddmm,
    block_softmax,
    block_spmm,
    edge_softmax,
    ell_attention,
    ell_copy_spmm,
    ell_dual,
    ell_edge_bias_attention,
    ell_gat_attention,
    ell_pack_weights,
    ell_spmm,
    gat_attention,
    gspmm,
    node_mul_edge,
    sddmm,
    tiled_attention,
    tiled_sddmm,
    tiled_softmax,
    tiled_spmm,
    vector_spmm,
)
from custom_op_benchmark_tpu_torch.utils.benchlib import (
    bench_ms,
    hbm_bandwidth_bytes,
)
from custom_op_benchmark_tpu_torch.utils.device import cuda_device, exact_f32
from custom_op_benchmark_tpu_torch.utils.summary import describe

# The reference's gate (wrapper.py's allclose defaults, loosened for f32
# sums taken in other orders over up to 5 tiles of 128 products).
RTOL, ATOL = 2e-3, 2e-3
# The clique suite's --small size (the reference's): batch, length,
# single-head width, heads, multi-head width.
SMALL_CLIQUES = (8, 16, 128, 2, 64)


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


def _grad_of(loss):
    """``args → ∂loss(args)/∂args`` for tensor arguments, or for a
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
        return torch.autograd.grad(loss(*call), leaves)

    return grad


def _grad_of_square_sum(fn):
    """``args → ∂(Σ fn(args)²)/∂args``."""
    return _grad_of(lambda *args: (fn(*args) ** 2).sum())


def _timer(records, dev, *, warmup, iters, repeats, edges):
    """The suites' ``bench(name, fn, *args, bytes_model)``: a timed row on
    a CUDA device, a "not measured" row elsewhere."""
    timed = dev.type == "cuda"
    peak = hbm_bandwidth_bytes(dev) if timed else None
    if timed:
        records.append({"copy_bandwidth_bytes_per_s": peak})

    def bench(name, fn, *args, bytes_model=None):
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
# Clique regime (the default suite)
# ---------------------------------------------------------------------------

def run_suite(batch_size=512, length=30, d_single=1024, heads=8, d_multi=64,
              *, device=None, warmup=1, iters=5, repeats=3):
    """The reference's clique suite (its ``run_suite``): every op of the
    family on ``batch_size`` disjoint ``length``-cliques through the dense
    bmm view, the segment oracle, the tile kernels and the dense blocks,
    forward and backward, single-head at ``d_single`` and multi-head at
    ``heads`` × ``d_multi``, with the reference's rows and gates. Runs on
    ``device`` (default: the CUDA device); times the rows only there.
    Returns (records, all_ok)."""
    device = cuda_device() if device is None else torch.device(device)
    on_card = device.type == "cuda"
    records, ok = [], True
    b, l = batch_size, length
    g_host = clique_batch(b, l)
    n, e = g_host.n_nodes, g_host.n_edges
    g = g_host.to(device)
    tg = tile_graph(g_host, 128, 128, device=device)
    bg = block_graph(g, max_block=max(128, l))
    # The tile-aligned order: no component straddles a 128-row tile.
    ro = tile_aligned_order(g_host, block=128)
    g_al, eperm_al = reorder_graph(g_host, ro)
    tg_al = tile_graph(g_al, 128, 128, device=device)
    eperm_al = torch.from_numpy(eperm_al.astype(np.int64)).to(device)
    where = torch.cuda.get_device_name(device) if on_card else device
    bench = _timer(records, device, warmup=warmup, iters=iters,
                   repeats=repeats, edges=e)
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(device)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(size=shape).astype(
            np.float32)).to(device)

    def check(name, got, want):
        return _check(name, got[: want.shape[0]], want, records)

    # ---------------- single head ----------------
    print(f"Single head (batch={b}, length={l}, dim={d_single}, tiles "
          f"{tg.num_tiles} / aligned {tg_al.num_tiles}) on {where}")
    A, B = normal(n, d_single), normal(n, d_single)
    dy_e = normal(e)
    Ab, Bb = bg.scatter_nodes(A), bg.scatter_nodes(B)

    def f_bmm(A, B):
        return torch.einsum("bxd,byd->bxy", A.reshape(b, l, -1),
                            B.reshape(b, l, -1)).reshape(-1)

    def f_seg(A, B):
        return sddmm(g, A, B, impl="xla")

    def f_til(A, B):
        return tg.gather_edges(tiled_sddmm(tg, A, B))

    def f_blk(Ab, Bb):
        return block_sddmm(bg, Ab, Bb)

    bench("maskedmm/dense_bmm", f_bmm, A, B)
    bench("maskedmm/xla_segment", f_seg, A, B)
    bench("maskedmm/pallas_tiled", f_til, A, B)
    bench("maskedmm/dense_block", f_blk, Ab, Bb)
    with exact_f32():
        y0 = f_bmm(A, B)
        ok &= check("maskedmm fwd xla vs bmm", f_seg(A, B), y0)
        ok &= check("maskedmm fwd tiled vs bmm", f_til(A, B), y0)
        ok &= check("maskedmm fwd block vs bmm",
                    bg.gather_edges(f_blk(Ab, Bb)), y0)
        if on_card:
            ok &= _compiled_attention_check(l, device, normal, records)
    del y0

    def loss_seg(A, B):
        return (f_seg(A, B)[:e] * dy_e).sum()

    def loss_til(A, B):
        return (f_til(A, B)[:e] * dy_e).sum()

    def loss_bmm(A, B):
        return (f_bmm(A, B) * dy_e).sum()

    bench("maskedmm_bwd/dense_bmm", _grad_of(loss_bmm), A, B)
    bench("maskedmm_bwd/xla_segment", _grad_of(loss_seg), A, B)
    bench("maskedmm_bwd/pallas_tiled", _grad_of(loss_til), A, B)
    with exact_f32():
        g_bmm = _grad_of(loss_bmm)(A, B)
        for lf, tag in ((loss_seg, "xla"), (loss_til, "tiled")):
            ga, gb = _grad_of(lf)(A, B)
            ok &= check(f"maskedmm dA {tag} vs bmm", ga, g_bmm[0])
            ok &= check(f"maskedmm dB {tag} vs bmm", gb, g_bmm[1])
    del g_bmm, ga, gb, A, B, Ab, Bb

    # Edge softmax, both directions.
    x_e = normal(e)
    xe_blk = bg.scatter_edges(x_e)

    def f_soft_ref(x):
        return torch.softmax(x.reshape(b, l, l), -1).reshape(-1)

    def f_soft_seg(x):
        return edge_softmax(g, x, by="src", impl="xla")

    def f_soft_til(x):
        return tg.gather_edges(tiled_softmax(
            tg, tg.scatter_edges(x)[: tg.num_tiles], by="src"))

    def f_soft_blk(xb):
        return block_softmax(bg, xb, by="src")

    def f_gather_seg(x):
        return edge_softmax(g, x, by="dst", impl="xla")

    bench("softmax_scatter/dense_view", f_soft_ref, x_e)
    bench("softmax_scatter/xla_segment", f_soft_seg, x_e)
    bench("softmax_scatter/pallas_tiled", f_soft_til, x_e)
    bench("softmax_scatter/dense_block", f_soft_blk, xe_blk)
    y0 = f_soft_ref(x_e)
    ok &= check("softmax scatter xla", f_soft_seg(x_e), y0)
    ok &= check("softmax scatter tiled", f_soft_til(x_e), y0)
    ok &= check("softmax scatter block",
                bg.gather_edges(f_soft_blk(xe_blk)), y0)
    ok &= check("softmax gather xla", f_gather_seg(x_e),
                torch.softmax(x_e.reshape(b, l, l), -2).reshape(-1))
    bench("softmax_gather/xla_segment", f_gather_seg, x_e)

    dy_soft = normal(e)

    def loss_soft_til(x):
        return (f_soft_til(x)[:e] * dy_soft).sum()

    def loss_soft_seg(x):
        return (f_soft_seg(x)[:e] * dy_soft).sum()

    bench("softmax_bwd/pallas_tiled", _grad_of(loss_soft_til), x_e)
    bench("softmax_bwd/xla_segment", _grad_of(loss_soft_seg), x_e)
    ok &= check("softmax bwd tiled vs segment",
                _grad_of(loss_soft_til)(x_e)[0],
                _grad_of(loss_soft_seg)(x_e)[0])

    # Vector SpMM.
    edata, xn = uniform(e), normal(n, d_single)
    vals = tg.scatter_edges(edata)[: tg.num_tiles]
    ed_blk, xn_blk = bg.scatter_edges(edata), bg.scatter_nodes(xn)

    def f_spmm_bmm(ed, x):
        return torch.einsum("bxy,byd->bxd", ed.reshape(b, l, l),
                            x.reshape(b, l, -1)).reshape(n, -1)

    def f_spmm_seg(ed, x):
        return vector_spmm(g, ed, x, impl="xla")

    def f_spmm_til(v, x):
        return tiled_spmm(tg, v, x)

    def f_spmm_al(v, x):
        return tiled_spmm(tg_al, v, x)

    def f_spmm_blk(ed, x):
        return block_spmm(bg, ed, x)

    bench("spmm/dense_bmm", f_spmm_bmm, edata, xn)
    bench("spmm/xla_segment", f_spmm_seg, edata, xn)
    bench("spmm/pallas_tiled", f_spmm_til, vals, xn)
    vals_al = tg_al.scatter_edges(edata[eperm_al])[: tg_al.num_tiles]
    xn_al = ro.scatter_nodes(xn)
    bench("spmm/pallas_tiled_aligned", f_spmm_al, vals_al, xn_al)
    with exact_f32():
        y0 = f_spmm_bmm(edata, xn)
        ok &= check("spmm fwd tiled_aligned vs bmm",
                    ro.gather_nodes(f_spmm_al(vals_al, xn_al)), y0)
    bench("spmm/dense_block", f_spmm_blk, ed_blk, xn_blk)
    with exact_f32():
        ok &= check("spmm fwd xla vs bmm", f_spmm_seg(edata, xn), y0)
        ok &= check("spmm fwd tiled vs bmm", f_spmm_til(vals, xn), y0)
        ok &= check("spmm fwd block vs bmm",
                    bg.gather_nodes(f_spmm_blk(ed_blk, xn_blk)), y0)
    del y0, vals_al, xn_al

    dy_sm = normal(e)

    def sm_loss_seg(x):
        return (f_soft_seg(x)[:e] * dy_sm).sum()

    def sm_loss_ref(x):
        return (f_soft_ref(x) * dy_sm).sum()

    bench("softmax_bwd/dense_view", _grad_of(sm_loss_ref), x_e)
    bench("softmax_bwd/xla_segment", _grad_of(sm_loss_seg), x_e)
    ok &= check("softmax grad xla vs dense", _grad_of(sm_loss_seg)(x_e)[0],
                _grad_of(sm_loss_ref)(x_e)[0])

    dy_n = normal(n, d_single)

    def spmm_loss_seg(ed, x):
        return (f_spmm_seg(ed, x) * dy_n).sum()

    def spmm_loss_bmm(ed, x):
        return (f_spmm_bmm(ed, x) * dy_n).sum()

    def spmm_loss_blk(ed, x):
        y = block_spmm(bg, bg.scatter_edges(ed), bg.scatter_nodes(x))
        return (bg.gather_nodes(y) * dy_n).sum()

    bench("spmm_bwd/dense_bmm", _grad_of(spmm_loss_bmm), edata, xn)
    bench("spmm_bwd/xla_segment", _grad_of(spmm_loss_seg), edata, xn)
    bench("spmm_bwd/dense_block", _grad_of(spmm_loss_blk), edata, xn)
    with exact_f32():
        g_bmm = _grad_of(spmm_loss_bmm)(edata, xn)
        for lf, tag in ((spmm_loss_seg, "xla"), (spmm_loss_blk, "block")):
            ga, gb = _grad_of(lf)(edata, xn)
            ok &= check(f"spmm dedata {tag} vs bmm", ga, g_bmm[0])
            ok &= check(f"spmm dx {tag} vs bmm", gb, g_bmm[1])
    del g_bmm, ga, gb, edata, xn, vals, ed_blk, xn_blk, dy_n

    # Fused attention: one K4 launch on the tiles against the composed
    # segment pipeline.
    q, kk, vv = normal(n, 128), normal(n, 128), normal(n, 128)

    def attn_ref(q, k, v):
        s = sddmm(g, q, k, impl="xla") / math.sqrt(128.0)
        a = edge_softmax(g, s, by="src", impl="xla")
        return vector_spmm(g, a, v, impl="xla")

    def attn_til(q, k, v):
        return tiled_attention(tg, q, k, v, normalize="src")

    bench("attention_fused/pallas", attn_til, q, kk, vv)
    bench("attention_composed/xla", attn_ref, q, kk, vv)
    with exact_f32():
        ok &= check("fused attention vs composed", attn_til(q, kk, vv),
                    attn_ref(q, kk, vv))
    del q, kk, vv

    # ---------------- multi head ----------------
    print(f"Multi head (batch={b}, length={l}, heads={heads}, "
          f"dim={d_multi})")
    Ah, Bh = normal(n, heads, d_multi), normal(n, heads, d_multi)
    Be = normal(e, d_multi)

    def nme_seg(A, B):
        return node_mul_edge(g, A, B, impl="xla")

    bench("node_mul_edge/xla_segment", nme_seg, Ah, Be)
    src = g.src.long()[:e].clamp(max=n - 1)
    with exact_f32():
        ok &= check("node_mul_edge fwd", nme_seg(Ah, Be),
                    torch.einsum("ehd,ed->eh", Ah[src], Be))

    def mh_seg(A, B):
        return sddmm(g, A, B, impl="xla")

    bench("maskedmm_multihead/xla_segment", mh_seg, Ah, Bh)
    with exact_f32():
        ok &= check("maskedmm multihead fwd", mh_seg(Ah, Bh), torch.einsum(
            "bxhd,byhd->bxyh", Ah.reshape(b, l, heads, d_multi),
            Bh.reshape(b, l, heads, d_multi)).reshape(e, heads))

    xh = normal(e, heads)

    def sm_mh(x):
        return edge_softmax(g, x, by="src", impl="xla")

    bench("softmax_multihead/xla_segment", sm_mh, xh)
    ok &= check("softmax multihead", sm_mh(xh), torch.softmax(
        xh.reshape(b, l, l, heads), -2).reshape(e, heads))

    edh = uniform(e, heads)

    def spmm_mh_seg(ed, x):
        return vector_spmm(g, ed, x, impl="xla")

    bench("spmm_multihead/xla_segment", spmm_mh_seg, edh, Ah)
    bench("spmm_multihead/dense_block", f_spmm_blk, bg.scatter_edges(edh),
          bg.scatter_nodes(Ah))
    with exact_f32():
        y0 = torch.einsum("bxyh,byhd->bxhd", edh.reshape(b, l, l, heads),
                          Ah.reshape(b, l, heads, d_multi)).reshape(
                              n, heads, d_multi)
        ok &= check("spmm multihead fwd", spmm_mh_seg(edh, Ah), y0)
        ok &= check("spmm multihead block", bg.gather_nodes(f_spmm_blk(
            bg.scatter_edges(edh), bg.scatter_nodes(Ah))), y0)

    def attn_blk(q, k, v):
        return block_attention(bg, q, k, v, normalize="src")

    bench("attention_fused_multihead/pallas", attn_til, Ah, Bh, Ah)
    qb, kb = bg.scatter_nodes(Ah), bg.scatter_nodes(Bh)
    bench("attention_multihead/dense_block", attn_blk, qb, kb, qb)
    with exact_f32():
        ok &= check("attention multihead block vs tiled",
                    bg.gather_nodes(attn_blk(qb, kb, qb)),
                    attn_til(Ah, Bh, Ah))

    # Additive (GAT) attention through the one-call dispatch op.
    a_l, a_r = normal(heads, d_multi) * 0.1, normal(heads, d_multi) * 0.1

    def gat_blk(a, c, z):
        return gat_attention(g, a, c, z, impl="dense_block")

    def gat_seg(a, c, z):
        return gat_attention(g, a, c, z, impl="xla")

    bench("gat_fused/dense_block", gat_blk, a_l, a_r, Ah)
    bench("gat_composed/xla", gat_seg, a_l, a_r, Ah)
    with exact_f32():
        ok &= check("gat fused block vs composed", gat_blk(a_l, a_r, Ah),
                    gat_seg(a_l, a_r, Ah))
    return records, ok


def _compiled_attention_check(length, device, normal, records):
    """K4 compiled on the card (``tiled_attention``, normalize="dst", d =
    128) on ``clique_batch(8, length)`` against a dense masked-softmax
    oracle: the reference's TPU-only check of its compiled Pallas kernel."""
    gs = clique_batch(8, length)
    tgs = tile_graph(gs, 128, 128, device=device)
    qs = normal(gs.n_nodes, 128)
    y_kernel = tiled_attention(tgs, qs, qs, qs, normalize="dst")
    adj = torch.zeros(gs.n_nodes, gs.n_nodes, dtype=torch.bool,
                      device=device)
    adj[gs.src.long()[: gs.n_edges], gs.dst.long()[: gs.n_edges]] = True
    sd = torch.where(adj, qs @ qs.T / math.sqrt(128.0), -1e30)
    alpha = torch.where(adj, torch.softmax(sd, dim=0), 0.0)
    return _check("fused attention kernel (compiled) vs dense", y_kernel,
                  alpha.T @ qs, records)


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
    rec_strategy = describe(case.g).recommended
    print(f"Grid {rows}x{cols} (n={n}, e={e}, T={case.tg.num_tiles}, "
          f"d={case.d}; describe → {rec_strategy!r}) on {where}")
    records.append({"describe_recommended": rec_strategy})
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
                    help="run the power-law (general-graph) suite instead")
    ap.add_argument("--grid", action="store_true",
                    help="run the grid (locality-rich) suite instead")
    ap.add_argument("--small", action="store_true",
                    help="the clique suite at 8x16 cliques, d=128, 2 heads "
                    "of 64; the power-law suite at n=2048, e=16384, d=32; "
                    "a 48x48 grid at d=32")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA device, and fail "
                    "without one); cpu runs the checks with the kernels' "
                    "plain versions and times nothing, --small only")
    ap.add_argument("--json", type=str, default=None,
                    help="write the records to this file")
    args = ap.parse_args(argv)
    if args.powerlaw and args.grid:
        ap.error("pick one suite: --powerlaw, --grid or neither (cliques)")
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
    elif args.grid:
        size = (48, 48, 32) if args.small else ()
        records, ok = run_grid_suite(*size, device=device)
    else:
        size = SMALL_CLIQUES if args.small else ()
        records, ok = run_suite(*size, device=device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print(json.dumps({"suite_ok": ok,
                      "checks": sum(1 for r in records if "check" in r),
                      "benches": sum(1 for r in records if "bench" in r)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
