"""Headline benchmark: SpMM on the reference workload, against the copy
bandwidth.

    python -m custom_op_benchmark_tpu_torch.bench [--device cpu]

Counterpart of the JAX package's ``bench.py``. Prints one JSON line with
its keys: ``{"metric": "spmm_hbm_roofline_frac", "value", "unit",
"vs_baseline", "edges_per_s", "time_s", "impl", "auto_impl",
"kernel_parity_ok", "device", "peak_gb_s", ...}`` (the reference's
``pallas_parity_ok`` is ``kernel_parity_ok`` here).

- workload: 512 disjoint 30-cliques (n = 15,360, e = 460,800), single
  head, d = 1024, f32;
- timed op: ``block_spmm`` on ``block_graph(g, max_block=128)`` (the dense
  blocks ``impl="auto"`` picks for this graph), by CUDA events, the median
  of repeats (``benchlib.bench_fn``);
- value: the bytes the dense layout must move, ``(2·xb + vals)·4`` (x read
  and y written at the padded block shape, the (B, L, L) values read),
  over the time, as a fraction of the card's measured copy bandwidth
  (``benchlib.hbm_bandwidth_bytes``); ``vs_baseline`` is that fraction
  over the 0.70 north-star target;
- checks: ``dispatch.resolve(g, "auto") == "dense_block"`` and
  ``vector_spmm(impl="auto")`` against the timed form at 2e-2; K1
  (``tiled_sddmm``) compiled on the card on 8×30 cliques at d = 128
  against a dense oracle (TF32 off) at 5e-3 (``kernel_parity_ok``);
- secondary rows: the fused ELL attention on a power-law graph (n =
  131,072, 2M edges, d = 128) with its unique and refetch byte fractions
  over the card's L2 gather rate (``benchlib.l2_gather_rate``, printed as
  ``powerlaw_gather_ceiling_gb_s``), and the clique GAT train step (3
  layers, 8 heads of 64, 128-d features, dense blocks, one AdamW update)
  as ``clique_gat_step_ms``.

A failing check or row raises. ``--device cpu`` runs the reference's
smoke size (32×30 cliques, d = 128) on the segment path with the kernels'
plain versions; it times nothing, and the device numbers are null.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

FULL = (512, 30, 1024)
SMOKE = (32, 30, 128)
NORTH_STAR = 0.70           # BASELINE.json's target fraction
AUTO_TOL = 2e-2             # vector_spmm(impl="auto") vs the timed form
KERNEL_TOL = 5e-3           # K1 vs the dense oracle (rtol = atol)
POWERLAW = (131072, 2_000_000, 128)
CLIQUE_GAT = dict(hidden_dim=64, out_dim=10, num_layers=3, num_heads=8)
CLIQUE_GAT_FEAT = 128


def spmm_workload(batch: int, length: int, d: int, device, seed: int = 0):
    """The clique batch on ``device``, edge values uniform in [0, 1) and
    node features standard normal, from ``np.random.default_rng(seed)``."""
    from custom_op_benchmark_tpu_torch.graph import clique_batch

    g = clique_batch(batch, length).to(device)
    rng = np.random.default_rng(seed)
    edata = torch.from_numpy(rng.uniform(size=g.num_edges_padded).astype(
        np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal(
        (g.n_nodes, d), dtype=np.float32)).to(device)
    return g, edata, x


def dense_block_form(g, edata, x):
    """The timed form on the dense blocks: (block graph, fn, args, bytes
    the layout must move)."""
    from custom_op_benchmark_tpu_torch.graph import block_graph
    from custom_op_benchmark_tpu_torch.ops import block_spmm

    bg = block_graph(g, max_block=128)
    if bg is None:
        raise ValueError("the workload's components do not fit dense blocks")
    vals, xb = bg.scatter_edges(edata), bg.scatter_nodes(x)

    def fn(vals, xb):
        return block_spmm(bg, vals, xb)

    return bg, fn, (vals, xb), (2 * xb.numel() + vals.numel()) * 4


def check_auto(g, edata, x, y_timed) -> str:
    """``impl="auto"``'s strategy for ``g``, with ``vector_spmm(impl=
    "auto")`` held against ``y_timed`` (node order) at AUTO_TOL."""
    from custom_op_benchmark_tpu_torch.ops import dispatch, vector_spmm

    auto_impl = dispatch.resolve(g, "auto")
    y_auto = vector_spmm(g, edata, x, impl="auto")
    torch.testing.assert_close(y_auto, y_timed, rtol=AUTO_TOL, atol=AUTO_TOL)
    return auto_impl


def kernel_parity(device) -> bool:
    """K1 compiled on the card: ``tiled_sddmm`` on 8×30 cliques at d = 128
    against the dense per-edge dot products (TF32 off) at KERNEL_TOL."""
    from custom_op_benchmark_tpu_torch.graph import clique_batch, tile_graph
    from custom_op_benchmark_tpu_torch.ops import tiled_sddmm
    from custom_op_benchmark_tpu_torch.utils.device import exact_f32

    gs = clique_batch(8, 30)
    tgs = tile_graph(gs, 128, 128, device=device)
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(
        (gs.n_nodes, 128), dtype=np.float32)).to(device) for _ in range(2))
    src = gs.src.long()[: gs.n_edges].to(device)
    dst = gs.dst.long()[: gs.n_edges].to(device)
    with exact_f32():
        y = tgs.gather_edges(tiled_sddmm(tgs, a, b))[: gs.n_edges]
        oracle = torch.einsum("ed,ed->e", a[src], b[dst])
    return bool(torch.allclose(y, oracle, rtol=KERNEL_TOL, atol=KERNEL_TOL))


def powerlaw_attention(device, gather_ceiling: float) -> dict:
    """The fused ELL attention on the power-law graph, timed, with two byte
    models over ``gather_ceiling`` (bytes/s): ``unique`` (every node row of
    q, k, v read and y written once: a lower bound on the traffic, so its
    fraction is at most 1) and ``refetch`` (a k and a v row fetched for
    every padded ELL slot: an upper bound)."""
    from custom_op_benchmark_tpu_torch.graph import random_graph
    from custom_op_benchmark_tpu_torch.ops import ell_attention, ell_dual
    from custom_op_benchmark_tpu_torch.utils.benchlib import bench_fn

    n, e, d = POWERLAW
    g = random_graph(n, e, seed=0, power_law=True)
    se, de = (p.to(device) for p in ell_dual(g))
    q = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, d), dtype=np.float32)).to(device)
    rec = bench_fn(lambda q: ell_attention(de, se, q, q, q), (q,), warmup=1,
                   iters=5, repeats=3, name="pl_attn", edges=g.n_edges)
    slots = sum(b.cols.numel() for b in de.buckets)
    refetch = (2 * slots * d + 2 * n * d) * 4
    unique = 4 * n * d * 4
    return {
        "powerlaw_fused_attention_medges_s": rec.edges_per_s / 1e6,
        "powerlaw_fused_attention_ms": rec.time_s * 1e3,
        "powerlaw_attention_roofline_frac_unique":
            unique / rec.time_s / gather_ceiling,
        "powerlaw_attention_roofline_frac_refetch":
            refetch / rec.time_s / gather_ceiling,
        "powerlaw_bytes_model_gb": refetch / 1e9,
        "powerlaw_gather_ceiling_gb_s": gather_ceiling / 1e9,
    }


def clique_gat_step(g, bg, seed: int = 0):
    """The clique GAT's train step on the dense blocks (forward, backward
    and one AdamW update of ``GAT(hidden 64, out 10, 3 layers, 8 heads)``
    on 128-d features, every node labelled): returns ``(step, x)`` with
    ``step(x)`` running one step on the graph's device."""
    from custom_op_benchmark_tpu_torch.models import GAT
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    device, n = bg.device, g.n_nodes
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (n, CLIQUE_GAT_FEAT), dtype=np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(
        0, CLIQUE_GAT["out_dim"], size=n)).to(device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    model = GAT(**CLIQUE_GAT, in_dim=CLIQUE_GAT_FEAT,
                generator=torch.Generator().manual_seed(seed)).to(device)
    state = create_train_state(model)
    train_step = make_train_step(apply_kwargs={"block": bg})

    def step(x):
        return train_step(state, g, x, labels, mask)

    return step, x


def run(device=None) -> dict:
    """The headline record on ``device`` (default: the CUDA device; raises
    where there is none). On the CPU: the smoke size on the segment path,
    nothing timed."""
    from custom_op_benchmark_tpu_torch.ops import vector_spmm
    from custom_op_benchmark_tpu_torch.utils.benchlib import (
        bench_fn,
        hbm_bandwidth_bytes,
        l2_gather_rate,
    )
    from custom_op_benchmark_tpu_torch.utils.device import cuda_device

    device = cuda_device() if device is None else torch.device(device)
    on_card = device.type == "cuda"
    batch, length, d = FULL if on_card else SMOKE
    g, edata, x = spmm_workload(batch, length, d, device)
    n, e = g.n_nodes, g.n_edges
    if on_card:
        impl = "dense_block"
        bg, fn, args, strategy_bytes = dense_block_form(g, edata, x)
        y_timed = bg.gather_nodes(fn(*args))
    else:
        impl = "xla"
        y_timed = vector_spmm(g, edata, x, impl="xla")
    auto_impl = check_auto(g, edata, x, y_timed)
    del y_timed
    out = {"metric": "spmm_hbm_roofline_frac", "value": None,
           "unit": "fraction_of_hbm_roofline", "vs_baseline": None,
           "edges_per_s": None, "time_s": None, "impl": impl,
           "auto_impl": auto_impl, "kernel_parity_ok": None,
           "device": str(device), "peak_gb_s": None, "n": n, "e": e, "d": d}
    if not on_card:
        return out
    if auto_impl != "dense_block":
        raise AssertionError(f"impl='auto' resolved to {auto_impl!r}, not "
                             "'dense_block'")
    out["kernel_parity_ok"] = kernel_parity(device)
    if not out["kernel_parity_ok"]:
        raise AssertionError("K1 on the card disagrees with the dense oracle")
    rec = bench_fn(fn, args, warmup=3, iters=20, repeats=5,
                   name=f"vector_spmm_{impl}", bytes_moved=strategy_bytes,
                   edges=e)
    peak = hbm_bandwidth_bytes(device)
    frac = rec.roofline_fraction(peak)
    out.update(value=frac, vs_baseline=frac / NORTH_STAR,
               edges_per_s=rec.edges_per_s, time_s=rec.time_s,
               device=torch.cuda.get_device_name(device),
               peak_gb_s=peak / 1e9, strategy_bytes=strategy_bytes)
    del args, fn
    out.update(powerlaw_attention(device, l2_gather_rate(device)))
    step, xg = clique_gat_step(g, bg)
    out["clique_gat_step_ms"] = bench_fn(
        step, (xg,), warmup=1, iters=10, repeats=3,
        name="clique_gat_step").time_s * 1e3
    if not all(math.isfinite(v) for v in out.values()
               if isinstance(v, float)):
        raise AssertionError(f"a non-finite number in {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA device, and fail "
                    "without one); cpu runs the 32x30, d=128 smoke size on "
                    "the segment path and times nothing")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        from custom_op_benchmark_tpu_torch.utils.device import cuda_device

        try:
            device = cuda_device()
        except RuntimeError as err:
            print(f"bench: {err} (pass --device cpu for the smoke size)",
                  file=sys.stderr)
            return 1
    print(json.dumps(run(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
