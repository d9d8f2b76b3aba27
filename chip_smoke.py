#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three main paths and checks them. The first: AdamW train
steps of ``GraphTransformer(dim=512, num_heads=8, num_layers=3,
out_dim=10)`` on the 512×30 clique batch through its 128×128 tile view.
The second: the grid regime at full size — the tile-aligned 1024×1024 grid
graph at d = 128, through the grid suite (``utils/bench_suite.py``) and
the two grid experiments (``experiments/``), which run S1, S2, S4 and S5.
The third: the ELL strategy — the power-law graph of the reference's
power-law suite (n = 131,072, 2M edges, d = 128) through that suite and
the S3 experiment, and the arxiv configuration (160,000 nodes, 40
classes) trained full-graph on the ELL path by GAT (3 layers, 4 heads of
128), GCN and GraphSAGE (hidden 128), the last two on S3.

1. device: a CUDA device is present; print its name and power limit, then
   build the CUDA kernels from ``custom_op_benchmark_tpu_torch/csrc`` (one
   nvcc for each source, all started together);
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the slice's shapes, K2/K3 also at d=1024, and on a small
   irregular graph with an empty row block and an empty column block;
3. the slice at full width: logits, loss and every parameter's gradient
   on the card against the same module copied to the CPU, where the
   wrappers run the plain versions;
4. train: three AdamW steps with finite losses, K1–K4 launched;
5. times: each kernel against its plain version, and one train step;
6. grid build: the graph, its tile-aligned order and tiling on the host,
   moved to the card;
7. grid kernel parity: S1, S2, S4, S5 (all four switch settings) and K4 at
   d = 128 and d = 40 against their plain versions at the grid's shapes,
   K4 and S5 also at d = 200, and all of them again on the small irregular
   graph at d = 128, 40, 33 and 200;
8. the grid path: S1 and S2 against the segment oracle, then the grid
   suite (its allclose gates at 2e-3 and its timed rows, with roofline
   fractions against the measured copy bandwidth) and the two experiments'
   rows, with every launch counter set to 0 before and read after;
9. grid times: S1, S2, S4, S5 and K4 at d = 128 against their plain
   versions, and the peak memory of the grid attention backward;
10. power-law build: the graph and its dual ELL packing on both ladders on
    the host (seconds and padding waste), moved to the card;
11. S3 parity against its plain version, bit-for-bit repeats: at the
    experiment's shape, on every bucket of both packings of both ladders
    at d = 128, at d = 1, 33 and 200, at an R that is not a multiple of 8
    and on a bucket of padding only;
12. the power-law path: the suite's gates at 2e-3 and its timed rows, and
    the S3 experiment's rows, with the counters set to 0 before and read
    after;
13. the arxiv configuration: for GAT, GCN and GraphSAGE at full width, the
    ELL path against the segment path on the card from the same weights
    (logits, loss, every gradient), S3 launched in the forward and the
    backward of GCN and SAGE, then three AdamW steps through
    ``fit_full_graph(strategy="ell")`` with finite losses, the step time
    and the peak memory of each path;
14. S3 times: S3 against its plain version at the experiment's shape.

Exits non-zero on any failure, and at once when no CUDA device is present.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain version, both f32 with f32 accumulation: they sum the
# same products (at most 3·128 per output) in other orders, so they agree
# to about 1e-6 relative. Elementwise:
# |kernel − plain| ≤ ATOL + RTOL·|plain|.
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# Whole model, card vs CPU: three layers of f32 matmuls (cuBLAS vs the
# CPU's BLAS, TF32 off), LayerNorms and kernels vs plain versions, and
# weight gradients summed over 15,360 nodes in other orders. The check is
# max|card − cpu| ≤ MODEL_RTOL · max|cpu| for each tensor.
MODEL_RTOL = 1e-3
SEED = 0
# The slice: the clique batch, the model, and the wide SpMM width.
CLIQUES = (512, 30)
MODEL = dict(dim=512, num_heads=8, num_layers=3, out_dim=10)
WIDE = 1024
# The grid path: the reference's run_grid_suite shape.
GRID = (1024, 1024)
GRID_D = 128
# Each grid kernel call is tens of ms: fewer timed calls than the slice's.
GRID_TIMING = dict(warmup=1, iters=3, repeats=3)
# The power-law path: the reference's run_powerlaw_suite shape.
POWERLAW = (131072, 2_000_000, 128)
# The arxiv_gat configuration (custom_op_benchmark_tpu/train/run.py:106-118)
# and its model; GCN and GraphSAGE at its width (reddit_sage's too).
ARXIV = dict(num_classes=40, nodes_per_class=4000, feat_dim=128,
             avg_degree=13)
ARXIV_MODELS = {"GAT": dict(hidden_dim=128, num_layers=3, num_heads=4),
                "GCN": dict(hidden_dim=128, num_layers=2),
                "GraphSAGE": dict(hidden_dim=128, num_layers=2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-12))


def normal(rng, *shape, device):
    return torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(device)


def phase_device():
    from custom_op_benchmark_tpu_torch.ops.kernels import _build
    from custom_op_benchmark_tpu_torch.utils import cuda_device

    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s: {so}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return dev


class Kernels:
    """The nine kernels, their plain versions and where they came from."""

    def __init__(self):
        from custom_op_benchmark_tpu_torch.ops.kernels import attention as ka
        from custom_op_benchmark_tpu_torch.ops.kernels import gather_sum as ks
        from custom_op_benchmark_tpu_torch.ops.kernels import grid_dma as kg
        from custom_op_benchmark_tpu_torch.ops.kernels import (
            tiled_kernels as kt,
        )

        tk = "custom_op_benchmark_tpu_torch/csrc/tiled_kernels.cu"
        tp = "custom_op_benchmark_tpu/ops/pallas/tiled_kernels.py"
        self.table = {
            "sddmm_tiles": (kt.sddmm_tiles, kt.sddmm_tiles_plain, tk,
                            f"{tp}:58"),
            "spmm_row_sweep": (kt.spmm_row_sweep, kt.spmm_row_sweep_plain,
                               tk, f"{tp}:117"),
            "spmm_col_sweep": (kt.spmm_col_sweep, kt.spmm_col_sweep_plain,
                               tk, f"{tp}:174"),
            "fused_attention_rows": (
                ka.fused_attention_rows, ka.fused_attention_rows_plain,
                "custom_op_benchmark_tpu_torch/csrc/attention.cu",
                "custom_op_benchmark_tpu/ops/pallas/attention.py:86"),
            "spmm_row_sweep_dma": (
                kg.spmm_row_sweep_dma, kg.spmm_row_sweep_dma_plain,
                "custom_op_benchmark_tpu_torch/csrc/grid_dma.cu",
                "scripts/exp_grid_dma.py:74"),
            "spmm_row_sweep_dma_v2": (
                kg.spmm_row_sweep_dma_v2, kt.spmm_row_sweep_plain,
                "custom_op_benchmark_tpu_torch/csrc/grid_dma.cu",
                "scripts/exp_grid_dma.py:159"),
            "spmm_dotonly": (kt.spmm_dotonly, kt.spmm_dotonly_plain, tk,
                             "scripts/exp_grid_bisect.py:86"),
            "attn_variant": (
                ka.attn_variant, ka.attn_variant_plain,
                "custom_op_benchmark_tpu_torch/csrc/attention.cu",
                "scripts/exp_grid_bisect.py:152"),
            "gather_sum": (
                ks.gather_sum, ks.gather_sum_plain,
                "custom_op_benchmark_tpu_torch/csrc/gather_sum.cu",
                "scripts/exp_pallas_gather.py:63"),
        }

    def reset(self):
        for fn, *_ in self.table.values():
            fn.launches = 0

    def launches(self):
        return {name: fn.launches for name, (fn, *_) in self.table.items()}


SLICE_KERNELS = ("sddmm_tiles", "spmm_row_sweep", "spmm_col_sweep",
                 "fused_attention_rows")
GRID_KERNELS = ("spmm_row_sweep_dma", "spmm_row_sweep_dma_v2",
                "spmm_dotonly", "attn_variant")
S5_SETTINGS = {f"attn_variant:{'exp' if e else 'noexp'},"
               f"{'mask' if m else 'nomask'}": dict(use_exp=e, use_mask=m)
               for e in (True, False) for m in (True, False)}


def kernel_calls(tg, q, k, v, vals):
    """Each kernel's arguments as the main path gives them."""
    return {
        "sddmm_tiles": (tg.tile_rows, tg.tile_cols, tg.mask, q, k),
        "spmm_row_sweep": (tg.tile_ptr, tg.tile_cols, vals, k, q.shape[0]),
        "spmm_col_sweep": (tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows, vals,
                           q, k.shape[0]),
        "fused_attention_rows": (tg.tile_ptr, tg.tile_cols, tg.mask, q, k, v,
                                 q.shape[-1] ** -0.5),
    }


def split_kwargs(args):
    """A call's positional arguments and the keyword arguments its last
    element holds, if that is a dict."""
    if args and isinstance(args[-1], dict):
        return args[:-1], args[-1]
    return args, {}


def check_kernels(kern, calls, label, only=None):
    """Kernel vs plain on the card; also checks that two kernel runs agree
    bit for bit. A call's key is the kernel's name, or ``name:tag``; a dict
    as its last argument holds keyword arguments (the same for the plain
    version). Returns the max abs error per key."""
    errs = {}
    for key, args in calls.items():
        name = key.partition(":")[0]
        if only is not None and name not in only:
            continue
        args, kwargs = split_kwargs(args)
        fn, plain = kern.table[name][:2]
        got, again = fn(*args, **kwargs), fn(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert torch.equal(got, again), f"{name} is not deterministic"
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        log(f"[parity] {label:28s} {key:26s} shape {tuple(got.shape)} "
            f"max_abs_err {err:.3e} max|plain| "
            f"{float(want.abs().max()):.3e} {'ok' if ok else 'FAIL'}")
        assert ok, f"{key} disagrees with its plain version ({label})"
        errs[key] = err
    return errs


def phase_parity(kern, dev, tg):
    from custom_op_benchmark_tpu_torch.graph import from_coo, tile_graph

    rng = np.random.default_rng(SEED)
    n, h, d = tg.n_nodes, 8, 64
    tgt = tg.transpose()  # the attention layers' view (normalize="dst")
    q, k, v = (normal(rng, n, h, d, device=dev) for _ in range(3))
    vals = torch.where(tgt.mask, normal(rng, h, tgt.num_tiles, 128, 128,
                                        device=dev), 0.0)
    errs = check_kernels(kern, kernel_calls(tgt, q, k, v, vals),
                         "slice h=8 d=64")
    torch.cuda.synchronize()

    x = normal(rng, n, WIDE, device=dev)
    check_kernels(kern, kernel_calls(tgt, x, x, x, vals[0]),
                  f"slice h=1 d={WIDE}", only=("spmm_row_sweep",
                                            "spmm_col_sweep"))
    torch.cuda.synchronize()

    # n = 300 is not a multiple of 128; row block 1 has no out-edges and
    # column block 2 no in-edges.
    n_small = 300
    src = rng.choice(np.r_[0:128, 256:n_small], size=4000)
    dst = rng.choice(np.r_[0:256], size=4000)
    small = tile_graph(from_coo(src, dst, n_small), 128, 128, device=dev)
    assert int(torch.diff(small.tile_ptr)[1]) == 0
    assert int(torch.diff(small.tile_ptr_c)[2]) == 0
    for hh, dd, only in ((2, 64, None),
                         (3, 40, ("sddmm_tiles", "spmm_row_sweep",
                                  "spmm_col_sweep"))):
        qs, ks, vs = (normal(rng, n_small, hh, dd, device=dev)
                      for _ in range(3))
        sv = normal(rng, hh, small.num_tiles, 128, 128, device=dev)
        check_kernels(kern, kernel_calls(small, qs, ks, vs, sv),
                      f"irregular n=300 h={hh} d={dd}", only=only)
    torch.cuda.synchronize()
    return errs, (tgt, q, k, v, vals, x)


def build_slice(dev):
    from custom_op_benchmark_tpu_torch.graph import clique_batch, tile_graph
    from custom_op_benchmark_tpu_torch.models import GraphTransformer

    g = clique_batch(*CLIQUES)
    tg_cpu = tile_graph(g, 128, 128)
    tg = tg_cpu.to(dev)
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((g.n_nodes, MODEL["dim"]), dtype=np.float32)
    labels = rng.integers(0, MODEL["out_dim"], size=g.n_nodes)
    model_cpu = GraphTransformer(
        **MODEL, generator=torch.Generator().manual_seed(SEED))
    log(f"[slice] n={g.n_nodes} e={g.n_edges} tiles={tg.num_tiles} "
        f"row_blocks={tg.num_row_blocks} max_tiles_per_row="
        f"{tg.max_tiles_per_row} density={tg.density:.4f}")
    return g, tg_cpu, tg, x, labels, model_cpu


def phase_slice(dev, g, tg_cpu, tg, x, labels, model_cpu):
    from custom_op_benchmark_tpu_torch.train import masked_cross_entropy

    def fwd_bwd(model, tiled, device):
        xx = torch.from_numpy(x).to(device)
        yy = torch.from_numpy(labels).to(device)
        mm = torch.ones(g.n_nodes, dtype=torch.bool, device=device)
        model.zero_grad(set_to_none=True)
        logits = model(g, xx, tiled=tiled)
        loss = masked_cross_entropy(logits, yy, mm)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        return logits.detach(), loss.detach(), grads

    model = copy.deepcopy(model_cpu).to(dev)
    logits, loss, grads = fwd_bwd(model, tg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_c, loss_c, grads_c = fwd_bwd(model_cpu, tg_cpu, "cpu")
    log(f"[slice] CPU reference forward+backward took "
        f"{time.perf_counter() - t0:.1f} s")
    assert logits.shape == (g.n_nodes, MODEL["out_dim"])
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
    worst = ("", 0.0)
    for name, got, want in ([("logits", logits, logits_c),
                             ("loss", loss, loss_c)]
                            + [(n, grads[n], grads_c[n]) for n in grads_c]):
        e = rel_err(got, want)
        assert e <= MODEL_RTOL, f"{name}: card vs CPU rel err {e:.3e}"
        worst = max(worst, (name, e), key=lambda t: t[1])
    log(f"[slice] card vs CPU: loss {float(loss):.6f} vs "
        f"{float(loss_c):.6f}; {len(grads_c)} gradients, logits and loss "
        f"within {MODEL_RTOL:g} of max|cpu| (worst {worst[0]} "
        f"{worst[1]:.3e})")
    return model


def phase_train(kern, dev, g, tg, x, labels, model):
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    state = create_train_state(model)
    step = make_train_step(apply_kwargs={"tiled": tg})
    xx = torch.from_numpy(x).to(dev)
    yy = torch.from_numpy(labels).to(dev)
    mm = torch.ones(g.n_nodes, dtype=torch.bool, device=dev)
    kern.reset()
    results = [step(state, g, xx, yy, mm) for _ in range(3)]
    torch.cuda.synchronize()
    launches = kern.launches()
    losses = [float(loss) for loss, _ in results]
    log(f"[train] losses {losses} acc {[float(a) for _, a in results]}")
    log(f"[train] launches in 3 steps: {launches}")
    assert all(np.isfinite(losses)), losses
    assert all(launches[k] > 0 for k in SLICE_KERNELS), launches
    return launches, lambda: step(state, g, xx, yy, mm)


def well_posed_s5(tg, n, d, device, seed):
    """Inputs on which S5 without ``exp`` is well posed (the same design as
    tests/test_torch_grid_kernels.py). Without ``exp`` the recurrence is
    ``l = l·(m_prev − m) + Σ(s − m)``, a sign-changing sum, and the masked
    −1e30 terms overflow once multiplied, so on general inputs rounding
    decides the sign of ``l`` and whether a row reads 0. Here:

    - every live row is a whole tile row (the even rows of each tile); the
      odd rows are masked out everywhere (their m stays −1e9, so
      m_prev − m = 0 and they read 0). Where n is not a multiple of 128,
      the keys past n (zero) score 0 in a row's last tile and their −m
      terms make ``l`` negative, so those rows read 0 in both variants:
      only the grid's check (n a multiple of 128) sees non-zero outputs;
    - q is 1 in features 0 and 1; k holds 16 × the key's column block in
      feature 0 and ±1 in feature 1; v holds two entries of ±1; scale 1/8.
      So every score is exact in f32, a tile's scores spread by 1/4, and
      the row maxima rise by at least 2 from one of a row's tiles to the
      next: |l·(m_prev − m)| outgrows |Σ(s − m)| and no rounding can flip
      the sign of l.
    """
    gen = torch.Generator(device=device).manual_seed(seed)

    def pm1(shape):
        return torch.randint(0, 2, shape, device=device,
                             generator=gen).float() * 2 - 1

    q = torch.zeros(n, d, device=device)
    q[:, :2] = 1.0
    k = torch.zeros(n, d, device=device)
    k[:, 0] = (torch.arange(n, device=device) // 128).float() * 16
    k[:, 1] = pm1((n,))
    v = torch.zeros(n, d, device=device)
    v[:, :2] = pm1((n, 2))
    live = torch.arange(128, device=device) % 2 == 0
    mask = live[None, :, None].expand(tg.num_tiles, 128, 128).contiguous()
    return mask, q, k, v, 0.125


def grid_kernel_calls(tg, x, vals, x40, wp=None):
    """The grid kernels' arguments as the grid path gives them: ``tg`` the
    row-sorted tiling (SpMM), its transpose the attention's. ``wp`` (from
    :func:`well_posed_s5`) feeds S5 without ``exp``; without it those two
    settings take the grid's own inputs (for timing)."""
    from custom_op_benchmark_tpu_torch.ops.kernels.grid_dma import pad_layout

    tgt = tg.transpose()
    cols_pad, vals_pad = pad_layout(tg, vals)
    scale = x.shape[-1] ** -0.5
    att = (tgt.tile_ptr, tgt.tile_cols, tgt.mask, x, x, x, scale)
    calls = {
        "spmm_row_sweep_dma": (cols_pad, vals_pad, x),
        "spmm_row_sweep_dma_v2": (tg.tile_ptr, tg.tile_cols, vals, x),
        "spmm_dotonly": (tg.tile_ptr, tg.tile_cols, x),
        f"fused_attention_rows:d={x.shape[-1]}": att,
    }
    if x40 is not None:
        calls["fused_attention_rows:d=40"] = (
            tgt.tile_ptr, tgt.tile_cols, tgt.mask, x40, x40, x40, 40 ** -0.5)
    for key, kw in S5_SETTINGS.items():
        if kw["use_exp"] or wp is None:
            calls[key] = att + (kw,)
        else:
            calls[key] = (tgt.tile_ptr, tgt.tile_cols) + wp + (kw,)
    return calls


def time_ms(fn, warmup=3, iters=10, repeats=5):
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
    from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

    return statistics.median(time_cuda(fn, warmup=warmup, iters=iters,
                                       repeats=repeats)) * 1e3


def phase_times(kern, slice_inputs, train_step):
    tgt, q, k, v, vals, x = slice_inputs
    times = {}
    for label, calls in (("h=8 d=64", kernel_calls(tgt, q, k, v, vals)),
                         (f"h=1 d={WIDE}", kernel_calls(tgt, x, x, x,
                                                        vals[0]))):
        for name, args in calls.items():
            if label != "h=8 d=64" and name in ("sddmm_tiles",
                                                "fused_attention_rows"):
                continue
            fn, plain = kern.table[name][:2]
            # Plain, kernel, kernel, plain: each time is the mean of two.
            p1 = time_ms(lambda: plain(*args))
            k1 = time_ms(lambda: fn(*args))
            k2 = time_ms(lambda: fn(*args))
            p2 = time_ms(lambda: plain(*args))
            times[(name, label)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            log(f"[time] {name:22s} {label:11s} kernel {k1:.4f}/{k2:.4f} ms"
                f"  plain {p1:.4f}/{p2:.4f} ms")
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(train_step, warmup=1, iters=3, repeats=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] train step (3-layer GraphTransformer, tiled, AdamW) "
        f"{step_ms:.3f} ms, peak memory {peak:.2f} GiB")
    return times


def phase_grid_build(dev):
    from custom_op_benchmark_tpu_torch.utils.bench_suite import grid_case

    t0 = time.perf_counter()
    case = grid_case(*GRID, GRID_D, device=dev)
    torch.cuda.synchronize()
    tg = case.tg
    log(f"[grid] {GRID[0]}x{GRID[1]} n={case.n} e={case.e} T={tg.num_tiles} "
        f"nrb={tg.num_row_blocks} max_tiles_per_row={tg.max_tiles_per_row} "
        f"density={tg.density:.4f}; host build {case.host_s:.2f} s, with "
        f"the move to the card {time.perf_counter() - t0:.2f} s")
    return case


def phase_grid_parity(kern, dev, case):
    rng = np.random.default_rng(SEED + 2)
    tg = case.tg
    x40 = normal(rng, tg.n_nodes, 40, device=dev)
    wp = well_posed_s5(tg, tg.n_nodes, GRID_D, dev, SEED + 3)
    errs = check_kernels(kern, grid_kernel_calls(tg, case.q_al, case.vals,
                                                 x40, wp), f"grid d={GRID_D}")
    del wp, x40
    # K4/S5's D = 256 instantiation at the grid's shapes (d = 200).
    x200 = normal(rng, tg.n_nodes, 200, device=dev)
    wp = well_posed_s5(tg, tg.n_nodes, 200, dev, SEED + 5)
    check_kernels(kern, grid_kernel_calls(tg, x200, case.vals, None, wp),
                  "grid d=200", only=("fused_attention_rows", "attn_variant"))
    del wp, x200
    torch.cuda.synchronize()
    # The irregular graph of phase 2: an empty row and column block.
    n_small = 300
    src = rng.choice(np.r_[0:128, 256:n_small], size=4000)
    dst = rng.choice(np.r_[0:256], size=4000)
    from custom_op_benchmark_tpu_torch.graph import from_coo, tile_graph
    small = tile_graph(from_coo(src, dst, n_small), 128, 128, device=dev)
    # d = 33 moves x through S1/S2's 4-byte copies (rows not 16-byte
    # aligned); d = 200 runs K4/S5's D = 256 instantiation.
    for d in (GRID_D, 40, 33, 200):
        xs = normal(rng, n_small, d, device=dev)
        sv = torch.where(small.mask, normal(rng, small.num_tiles, 128, 128,
                                            device=dev), 0.0)
        wp = well_posed_s5(small, n_small, d, dev, SEED + 4)
        check_kernels(kern, grid_kernel_calls(
            small, xs, sv, normal(rng, n_small, 40, device=dev), wp),
            f"irregular n=300 d={d}")
    torch.cuda.synchronize()
    return errs


def phase_grid_path(kern, case):
    """The grid path, counted: S1/S2 against the segment oracle, the grid
    suite, and the two experiments' rows."""
    from custom_op_benchmark_tpu_torch.experiments import (
        exp_grid_bisect,
        exp_grid_dma,
    )
    from custom_op_benchmark_tpu_torch.ops import vector_spmm
    from custom_op_benchmark_tpu_torch.ops.kernels.grid_dma import (
        pad_layout,
        spmm_row_sweep_dma,
        spmm_row_sweep_dma_v2,
    )
    from custom_op_benchmark_tpu_torch.utils.bench_suite import (
        _check,
        run_grid_suite,
    )

    kern.reset()
    records, ok = [], True
    ro, tg = case.ro, case.tg
    y0 = vector_spmm(case.g, case.ed, case.q, impl="xla")
    cols_pad, vals_pad = pad_layout(tg, case.vals)
    y1 = spmm_row_sweep_dma(cols_pad, vals_pad, case.q_al, ro.n_new)
    ok &= _check("grid spmm S1 vs segment", ro.gather_nodes(y1), y0, records)
    y2 = spmm_row_sweep_dma_v2(tg.tile_ptr, tg.tile_cols, case.vals,
                               case.q_al, ro.n_new)
    ok &= _check("grid spmm S2 vs segment", ro.gather_nodes(y2), y0, records)
    del y0, y1, y2, cols_pad, vals_pad
    suite, suite_ok = run_grid_suite(*GRID, GRID_D, case=case,
                                     **GRID_TIMING)
    records += suite
    for r in records:
        if "check" in r:
            log(f"[grid] gate {r['check']:40s} max_diff {r['max_diff']:.3e} "
                f"{'ok' if r['ok'] else 'FAIL'}")
    dma = exp_grid_dma.run(case, **GRID_TIMING)
    bisect = exp_grid_bisect.run(case, **GRID_TIMING)
    torch.cuda.synchronize()
    launches = kern.launches()
    log(f"[grid] launches on the grid path: {launches}")
    log(json.dumps({"grid_suite": records}))
    log(json.dumps({"grid_dma": dma}))
    log(json.dumps({"grid_bisect": bisect}))
    assert ok and suite_ok, "a grid gate failed"
    assert dma["allclose"] and dma["allclose_v2"], dma
    assert all(launches[k] > 0 for k in SLICE_KERNELS + GRID_KERNELS), \
        launches
    return launches


def phase_grid_times(kern, case):
    from custom_op_benchmark_tpu_torch.utils.bench_suite import (
        tiled_grid_attention,
    )

    times = {}
    calls = grid_kernel_calls(case.tg, case.q_al, case.vals, None)
    for key in ("spmm_row_sweep_dma", "spmm_row_sweep_dma_v2", "spmm_dotonly",
                f"fused_attention_rows:d={GRID_D}", *S5_SETTINGS):
        args, kwargs = split_kwargs(calls[key])
        fn, plain = kern.table[key.partition(":")[0]][:2]
        p1 = time_ms(lambda: plain(*args, **kwargs), **GRID_TIMING)
        k1 = time_ms(lambda: fn(*args, **kwargs), **GRID_TIMING)
        k2 = time_ms(lambda: fn(*args, **kwargs), **GRID_TIMING)
        p2 = time_ms(lambda: plain(*args, **kwargs), **GRID_TIMING)
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[time] {key:30s} grid d={GRID_D} kernel {k1:.4f}/{k2:.4f} ms"
            f"  plain {p1:.4f}/{p2:.4f} ms")
    del calls
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    q = case.q_al.detach().requires_grad_()
    (tiled_grid_attention(case, q) ** 2).sum().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[time] grid attention backward (d={GRID_D}): peak memory "
        f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held before it")
    return times


def sync_peak_gib() -> float:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def phase_powerlaw_build(dev):
    from custom_op_benchmark_tpu_torch.ops import ell_dual
    from custom_op_benchmark_tpu_torch.utils.bench_suite import powerlaw_case

    t0 = time.perf_counter()
    case = powerlaw_case(*POWERLAW, device=dev)
    torch.cuda.synchronize()
    moved_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = ell_dual(case.g, profile="train")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    for ladder, (se, de) in (("pow2", (case.se, case.de)), ("train", train)):
        log(f"[powerlaw] {ladder} ladder: src {len(se.buckets)} buckets, "
            f"{se.total_slots} slots, waste {se.padding_waste:.3f}; dst "
            f"{len(de.buckets)} buckets, {de.total_slots} slots, waste "
            f"{de.padding_waste:.3f}")
    log(f"[powerlaw] n={case.n} e={case.e} d={case.d}; host build (graph "
        f"and pow-2 packing) {case.host_s:.2f} s, {moved_s:.2f} s with the "
        f"inputs and the move to the card; train-ladder packing "
        f"{train_s:.2f} s")
    return case, train


def phase_s3_parity(kern, dev, case, train):
    from custom_op_benchmark_tpu_torch.experiments import exp_pallas_gather

    rng = np.random.default_rng(SEED + 6)
    cols, x = exp_pallas_gather.inputs(dev)
    calls = {"gather_sum:experiment": (cols, x)}
    for ladder, pair in (("pow2", (case.se, case.de)), ("train", train)):
        for eg in pair:
            for b in eg.buckets:
                calls[f"gather_sum:{ladder},{eg.direction},D={b.width}"] = (
                    b.cols, case.q)
    widest = max(case.de.buckets, key=lambda b: b.num_rows)
    for d in (1, 33, 200):
        calls[f"gather_sum:d={d}"] = (widest.cols,
                                      normal(rng, case.n, d, device=dev))
    calls["gather_sum:R=1001"] = (cols[:1001], x)
    calls["gather_sum:padding"] = (
        torch.full((64, 16), case.n, dtype=torch.int32, device=dev), case.q)
    errs = check_kernels(kern, calls, "power law / S3")
    torch.cuda.synchronize()
    return errs, (cols, x)


def phase_powerlaw_path(kern, case, s3_inputs):
    """The power-law path, counted: the suite and the S3 experiment."""
    from custom_op_benchmark_tpu_torch.experiments import exp_pallas_gather
    from custom_op_benchmark_tpu_torch.utils.bench_suite import (
        run_powerlaw_suite,
    )

    kern.reset()
    torch.cuda.reset_peak_memory_stats()
    records, ok = run_powerlaw_suite(case=case, **GRID_TIMING)
    peak = sync_peak_gib()
    for r in records:
        if "check" in r:
            log(f"[powerlaw] gate {r['check']:44s} max_diff "
                f"{r['max_diff']:.3e} {'ok' if r['ok'] else 'FAIL'}")
    gather = exp_pallas_gather.run(*s3_inputs, **GRID_TIMING)
    torch.cuda.synchronize()
    launches = kern.launches()
    log(f"[powerlaw] launches on the power-law path: {launches}; peak "
        f"memory of the suite {peak:.2f} GiB")
    log(json.dumps({"powerlaw_suite": records}))
    log(json.dumps({"exp_pallas_gather": gather}))
    assert ok, "a power-law gate failed"
    assert gather["allclose"] and gather["allclose_full"], gather
    assert launches["gather_sum"] > 0, launches
    return launches


def arxiv_model(name, num_classes, in_dim):
    from custom_op_benchmark_tpu_torch import models

    return getattr(models, name)(
        out_dim=num_classes, in_dim=in_dim, **ARXIV_MODELS[name],
        generator=torch.Generator().manual_seed(SEED))


def phase_arxiv(dev):
    """The arxiv configuration on the ELL path: parity against the segment
    path, S3 counted in the forward and the backward, three AdamW steps
    through fit_full_graph, step times and peak memory."""
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.ops import ell_dual
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
        gather_sum,
    )
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        fit_full_graph,
        make_train_step,
        masked_cross_entropy,
    )

    t0 = time.perf_counter()
    ds = planted_partition(**ARXIV)
    g = ds.graph.to(dev)
    ell = ell_dual(g, profile="train")
    torch.cuda.synchronize()
    se, de = ell
    log(f"[arxiv] n={g.n_nodes} e={g.n_edges} classes={ds.num_classes}; "
        f"train-ladder waste src {se.padding_waste:.3f} dst "
        f"{de.padding_waste:.3f}; host build {time.perf_counter() - t0:.2f} s")
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    results = {"s3_launches": 0}

    for name in ARXIV_MODELS:
        model = arxiv_model(name, ds.num_classes, x.shape[1]).to(dev)
        runs = {}
        for path, views in (("segment", {}), ("ell", {"ell": ell})):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model.zero_grad(set_to_none=True)
            gather_sum.launches = 0
            logits = model(g, x, **views)
            loss = masked_cross_entropy(logits, labels, mask)
            torch.cuda.synchronize()
            n_fwd = gather_sum.launches
            loss.backward()
            peak = sync_peak_gib()
            n_bwd = gather_sum.launches - n_fwd
            runs[path] = (logits.detach(), loss.detach(),
                          {k: p.grad for k, p in model.named_parameters()})
            log(f"[arxiv] {name} {path:7s} forward+backward: loss "
                f"{loss.item():.6f}, peak memory {peak:.2f} GiB, S3 "
                f"launches forward {n_fwd} backward {n_bwd}")
            if path == "ell" and name != "GAT":
                assert n_fwd > 0 and n_bwd > 0, (name, n_fwd, n_bwd)
            del logits, loss
        (lg_s, ls_s, gr_s), (lg_e, ls_e, gr_e) = runs["segment"], runs["ell"]
        assert torch.isfinite(lg_e).all() and lg_e.shape == lg_s.shape
        worst = ("", 0.0)
        for key, got, want in ([("logits", lg_e, lg_s), ("loss", ls_e, ls_s)]
                               + [(k, gr_e[k], gr_s[k]) for k in gr_s]):
            e = rel_err(got, want)
            assert e <= MODEL_RTOL, f"{name} {key}: ELL vs segment {e:.3e}"
            worst = max(worst, (key, e), key=lambda t: t[1])
        log(f"[arxiv] {name} ELL vs segment: logits, loss and {len(gr_s)} "
            f"gradients within {MODEL_RTOL:g} of max|segment| (worst "
            f"{worst[0]} {worst[1]:.3e})")
        del runs, lg_s, ls_s, gr_s, lg_e, ls_e, gr_e

        gather_sum.launches = 0
        _, metrics = fit_full_graph(model, ds, epochs=3, log_every=1,
                                    learning_rate=2e-3, strategy="ell")
        torch.cuda.synchronize()
        n_s3 = gather_sum.launches
        results["s3_launches"] += n_s3
        losses = [h["loss"] for h in metrics["history"]]
        log(f"[arxiv] {name} fit_full_graph(strategy='ell'), 3 epochs: "
            f"losses {losses} val_acc {metrics['val_acc']:.4f}; S3 launches "
            f"{n_s3}")
        assert len(losses) == 3 and all(np.isfinite(losses)), losses
        if name != "GAT":
            assert n_s3 > 0, (name, n_s3)

        for path, views in (("ell", {"ell": ell}), ("segment", {})):
            state = create_train_state(model, learning_rate=2e-3)
            step = make_train_step(apply_kwargs=views)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: step(state, g, x, labels, mask), warmup=1,
                         iters=3, repeats=3)
            peak = sync_peak_gib()
            results[(name, path)] = (ms, peak)
            log(f"[time] arxiv {name} train step ({path}) {ms:.3f} ms, "
                f"peak memory {peak:.2f} GiB")
            del state, step
        del model
    return results


def phase_s3_times(kern, s3_inputs):
    fn, plain = kern.table["gather_sum"][:2]
    p1 = time_ms(lambda: plain(*s3_inputs))
    k1 = time_ms(lambda: fn(*s3_inputs))
    k2 = time_ms(lambda: fn(*s3_inputs))
    p2 = time_ms(lambda: plain(*s3_inputs))
    log(f"[time] gather_sum (S3) 125000x16 d=128 kernel {k1:.4f}/{k2:.4f} ms"
        f"  plain {p1:.4f}/{p2:.4f} ms")
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = phase_device()
    kern = Kernels()
    g, tg_cpu, tg, x, labels, model_cpu = build_slice(dev)
    errs, slice_inputs = phase_parity(kern, dev, tg)
    model = phase_slice(dev, g, tg_cpu, tg, x, labels, model_cpu)
    torch.cuda.synchronize()
    launches, train_step = phase_train(kern, dev, g, tg, x, labels, model)
    times = phase_times(kern, slice_inputs, train_step)
    torch.cuda.synchronize()
    del slice_inputs, train_step, model
    torch.cuda.empty_cache()
    case = phase_grid_build(dev)
    grid_errs = phase_grid_parity(kern, dev, case)
    grid_launches = phase_grid_path(kern, case)
    grid_times = phase_grid_times(kern, case)
    torch.cuda.synchronize()
    del case
    torch.cuda.empty_cache()
    pl_case, train = phase_powerlaw_build(dev)
    s3_errs, s3_inputs = phase_s3_parity(kern, dev, pl_case, train)
    del train
    phase_powerlaw_path(kern, pl_case, s3_inputs)
    del pl_case
    torch.cuda.empty_cache()
    arxiv = phase_arxiv(dev)
    s3_times = phase_s3_times(kern, s3_inputs)
    torch.cuda.synchronize()
    report = []
    for name, (_, _, source, replaces) in kern.table.items():
        if name in SLICE_KERNELS:
            (ms, plain_ms), err = times[(name, "h=8 d=64")], errs[name]
            n, shape = launches[name], "GraphTransformer slice, h=8 d=64"
        elif name == "gather_sum":
            (ms, plain_ms), err = s3_times, s3_errs["gather_sum:experiment"]
            n = arxiv["s3_launches"]
            shape = ("ELL bucket 125000x16, d=128 (exp_pallas_gather); "
                     "launches: GCN and GraphSAGE fit_full_graph, arxiv")
        else:
            # S5 with exp and mask: well posed on the grid's own inputs, so
            # its error and its time come from the same call.
            key = ("attn_variant:exp,mask" if name == "attn_variant"
                   else name)
            (ms, plain_ms), err = grid_times[key], grid_errs[key]
            n, shape = grid_launches[name], f"grid 1024x1024, d={GRID_D}"
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": n,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "shape": shape})
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
