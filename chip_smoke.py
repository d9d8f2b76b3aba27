#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths and checks them. The first: AdamW train steps
of ``GraphTransformer(dim=512, num_heads=8, num_layers=3, out_dim=10)`` on
the 512×30 clique batch through its 128×128 tile view. The second: the
dense-block path on the same clique batch, where ``impl="auto"`` resolves
to the dense blocks: the reference's clique GAT step (3 layers, 8 heads of
64, 128-d features) through ``fit_full_graph(strategy="auto")``. The
third: the grid regime at full size — the tile-aligned 1024×1024 grid
graph at d = 128, through the grid suite (``utils/bench_suite.py``) and
the two grid experiments (``experiments/``), which run S1, S2, S4 and S5.
The fourth: the ELL strategy — the power-law graph of the reference's
power-law suite (n = 131,072, 2M edges, d = 128) through that suite and
the S3 experiment, and the arxiv configuration (160,000 nodes, 40
classes) trained full-graph on the ELL path by GAT (3 layers, 4 heads of
128), GCN and GraphSAGE (hidden 128), the last two on S3, one launch per
copy-sum over all of a packing's buckets.

1. device: a CUDA device is present; print its name and power limit, then
   build the CUDA kernels from ``custom_op_benchmark_tpu_torch/csrc`` (one
   nvcc for each source, all started together);
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the slice's shapes, K1-K3 also at d=1024, K1 on masks with
   empty 16×8 fragments, strips and tiles and on a dense mask (its skip of
   empty fragments), and on a small irregular graph with an empty row
   block and an empty column block (K1-K3 also at d = 40, 33 and 200);
3. the slice at full width: logits, loss and every parameter's gradient
   on the card against the same module copied to the CPU, where the
   wrappers run the plain versions;
4. train: three AdamW steps with finite losses, each step launching K4
   3 times, K1 and K3 6 times and K2 3 times (3 layers);
5. times: each kernel against its plain version (K1-K3 also at
   d = 1024), its bound on these inputs (bytes at 3.35 TB/s or
   f32-accurate products at 165 TFLOP/s, whichever is longer) and its
   library yardstick (one PyTorch call that computes the same function,
   timed here and used nowhere in the port); the tensor-core K4 against
   S5 with exp and mask (the CUDA-core K4); then one train step;
6. bf16: K1-K4 on bf16 inputs against their plain versions (one bf16
   rounding) at the slice's shapes and on the irregular graph (d = 64, 33,
   200); the op family and the attention through ``impl="tiled"`` in bf16
   against f32 at 2e-2, forward and backward, counted; times with bounds
   at bf16 bytes and the bf16 tensor-core peak;
7. K4 at heads wider than 128 (d = 300 and 1024, the wide form) on the
   irregular graph against its plain version at 1e-4, bit for bit on
   repeat, through ``attention(impl="tiled")`` counted, and timed;
8. the dense-block path: ``resolve(g, "auto") == "dense_block"``, the
   clique GAT's logits, loss and gradients on the block layout against
   the segment path on the card, three steps of
   ``fit_full_graph(strategy="auto")``, the block step's time and peak
   memory, and ``vector_spmm`` at d = 1024 through auto (dense blocks),
   tiled (K2) and xla, agreeing at 2e-3;
9. grid build: the graph, its tile-aligned order and tiling on the host,
   moved to the card;
10. grid kernel parity: S1, S2, S4, S5 (all four switch settings), K4 at
    d = 128 and d = 40 and K1-K3 at d = 128 against their plain versions
    at the grid's shapes, K4 and S5 also at d = 200, and S1, S2, S4, S5
    and K4 again on the small irregular graph at d = 128, 100, 40, 33 and
    200;
11. the grid path: S1 and S2 against the segment oracle, then the grid
    suite (its allclose gates at 2e-3 and its timed rows, with roofline
    fractions against the measured copy bandwidth) and the two
    experiments' rows, with every launch counter set to 0 before and read
    after;
12. grid times: S1, S2, S4, S5, K4 and K1–K3 at d = 128 against their
    plain versions, with bounds and library yardsticks as in 5, and the
    peak memory of the grid attention backward;
13. power-law build: the graph and its dual ELL packing on both ladders on
    the host (seconds and padding waste), moved to the card;
14. S3 parity against its plain version, bit-for-bit repeats: at the
    experiment's shape, on every bucket of both packings of both ladders
    at d = 128 and on each packing's whole table, at d = 1, 33 and 200,
    at an R that is not a multiple of 8 and on a bucket of padding only;
    the one-launch copy-sum against the per-bucket result, bit for bit,
    one launch each;
15. the power-law path: the suite's gates at 2e-3 and its timed rows, and
    the S3 experiment's rows, with the counters set to 0 before and read
    after;
16. the arxiv configuration: the one-launch copy-sum against the
    per-bucket result on its training ladder; for GAT, GCN and GraphSAGE
    at full width, the ELL path against the segment path on the card from
    the same weights (logits, loss, every gradient), S3 launched in the
    forward and the backward of GCN and SAGE, then three AdamW steps
    through ``fit_full_graph(strategy="ell")`` with finite losses, the
    step time, the S3 launches of a step (one per copy-sum) and the peak
    memory of each path;
17. S3 times: S3 against its plain version and ``F.embedding_bag`` at the
    experiment's shape, and a second bound: its gathered bytes at the
    card's L2 gather rate, measured on a table that fits the 50 MB L2.

The line before the last is the ``kernels`` JSON: for each of the nine
kernels, and for K1-K4 in bf16 and K4 at d = 300 and 1024, its source,
the TPU kernel it replaces, its launches on its path, its error, time,
plain time, bound and library time.

Exits non-zero on any failure, and at once when no CUDA device is present.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import copy
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain version, both f32 with f32 accumulation (K3 and K4 take
# their products in 3xTF32, good to 2^-22 of each product): they sum the
# same products (at most 3·128 per output) in other orders, so they agree
# to about 1e-6 relative. Elementwise:
# |kernel − plain| ≤ ATOL + RTOL·|plain|.
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# bf16 kernel vs its plain version: both sum in f32 and round once to bf16,
# so they differ by one bf16 rounding (2^-7 of the value) above the f32
# gate's floor, which takes the f32 sums' other order (a result that
# cancels to near 0 keeps their absolute difference). Elementwise:
# |kernel − plain| ≤ BF16_RTOL·|plain| + KERNEL_ATOL.
BF16_RTOL = 2.0 ** -7
# The op family in bf16 against f32 (tests/test_dtypes.py:54-57).
DTYPE_RTOL = DTYPE_ATOL = 2e-2
# Strategies against each other (the suites' and bench.py's gate).
SUITE_TOL = 2e-3
# Whole model, card vs CPU: three layers of f32 matmuls (cuBLAS vs the
# CPU's BLAS, TF32 off), LayerNorms and kernels vs plain versions, and
# weight gradients summed over 15,360 nodes in other orders. The check is
# max|card − cpu| ≤ MODEL_RTOL · max|cpu| for each tensor.
MODEL_RTOL = 1e-3
# Peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet) for the
# kernels' bounds: HBM bandwidth; f32-accurate products on the tensor
# cores (3xTF32: three passes at the 495 TFLOP/s TF32 rate); f32 outside
# the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_MMA_F32 = 495e12 / 3
PEAK_F32 = 67e12
# bf16 products on the tensor cores (the kernels take them as one exact
# TF32 pass, but the card's least time for bf16 work is at this rate).
PEAK_BF16 = 989e12
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
# The dense-block path: the reference's clique GAT step (bench.py:224-262),
# uncut: 128-d features on the 512×30 clique batch, 10 classes.
BLOCK_GAT = dict(hidden_dim=64, out_dim=10, num_layers=3, num_heads=8)
BLOCK_FEAT = 128
# K4 at heads wider than 128 (the wide form), on the irregular graph.
K4_WIDE = (300, 1024)
# The L2 gather rate: rows of a table that fits the 50 MB L2 (8 MiB), at
# S3's row width, gathered in the experiment's pattern.
L2_TABLE_ROWS = 16384


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-12))


def live_share(mask):
    """The share of a tile view's 16×8 score fragments that hold an edge:
    the fragments K1 does not skip."""
    t = mask.shape[0]
    return float(mask.reshape(t, 8, 16, 16, 8).any(dim=(2, 4)).float().mean())


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


TILE_KERNELS = ("sddmm_tiles", "spmm_row_sweep", "spmm_col_sweep")
SLICE_KERNELS = TILE_KERNELS + ("fused_attention_rows",)
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


def skip_calls(tg, a, b, device):
    """K1 on masks that test its skip of fragments with no edge: one where
    about half of the 16×8 fragments, a quarter of the 16-row strips and a
    tenth of the tiles are empty and the rest random, and a dense one."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    t = tg.num_tiles

    def keep(*shape, p):
        return torch.rand(shape, device=device, generator=gen) < p

    live = (keep(t, 8, 1, 16, 1, p=0.5) & keep(t, 8, 1, 1, 1, p=0.75)
            & keep(t, 1, 1, 1, 1, p=0.9))
    bits = keep(t, 8, 16, 16, 8, p=0.5)
    holes = (live & bits).reshape(t, 128, 128).contiguous()
    dense = torch.ones((t, 128, 128), dtype=torch.bool, device=device)
    return {"sddmm_tiles:empty fragments": (tg.tile_rows, tg.tile_cols, holes,
                                            a, b),
            "sddmm_tiles:dense mask": (tg.tile_rows, tg.tile_cols, dense, a,
                                       b)}


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
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if got.dtype == torch.bfloat16:
            ok = bool((diff <= BF16_RTOL * want.float().abs()
                       + KERNEL_ATOL).all())
        else:
            ok = torch.allclose(got, want, rtol=KERNEL_RTOL,
                                atol=KERNEL_ATOL)
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
                  f"slice h=1 d={WIDE}", only=TILE_KERNELS)
    torch.cuda.synchronize()
    check_kernels(kern, skip_calls(tgt, q, k, dev), "slice h=8 d=64")
    torch.cuda.synchronize()

    # n = 300 is not a multiple of 128; row block 1 has no out-edges and
    # column block 2 no in-edges.
    n_small = 300
    src = rng.choice(np.r_[0:128, 256:n_small], size=4000)
    dst = rng.choice(np.r_[0:256], size=4000)
    small = tile_graph(from_coo(src, dst, n_small), 128, 128, device=dev)
    assert int(torch.diff(small.tile_ptr)[1]) == 0
    assert int(torch.diff(small.tile_ptr_c)[2]) == 0
    # d = 40 and 33: K1/K2's 16- and 4-byte copies with a partial 32- or
    # 64-feature chunk; d = 200: K1's contraction over seven chunks, K2/K3
    # over two feature slices.
    for hh, dd, only in ((2, 64, None), (3, 40, TILE_KERNELS),
                         (2, 33, TILE_KERNELS), (1, 200, TILE_KERNELS)):
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
        f"{tg.max_tiles_per_row} density={tg.density:.4f} live 16x8 "
        f"fragments {live_share(tg.mask):.4f}")
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
    # Per step, each of the 3 layers runs K4 once forward and K1 twice, K3
    # twice and K2 once in its backward (ops/tiled.py).
    layers = MODEL["num_layers"]
    per_step = {"sddmm_tiles": 2 * layers, "spmm_row_sweep": layers,
                "spmm_col_sweep": 2 * layers, "fused_attention_rows": layers}
    assert all(launches[k] == 3 * n for k, n in per_step.items()), launches
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


# ---------------------------------------------------------------------------
# Bounds and library yardsticks
# ---------------------------------------------------------------------------

def work(name, args, out):
    """(bytes, operations, peak operations/s, tile-dense operations) that
    kernel ``name``'s function needs on these inputs: each distinct input
    tensor read once and the output written once; tile products counted
    where the data is nonzero (the mask's edges, nonzero tile values; S4's
    constant tiles are dense), at the f32-accurate tensor-core peak; S3's
    adds over its valid slots at the CUDA-core f32 peak. The last entry
    counts every tile product whole, as the tile kernels take them."""
    pos, kw = split_kwargs(args)
    distinct = {t.data_ptr(): t for t in (*pos, out) if torch.is_tensor(t)}
    nbytes = sum(t.numel() * t.element_size() for t in distinct.values())
    if name == "gather_sum":
        cols, x = pos
        cols = cols if torch.is_tensor(cols) else cols.cols
        if not torch.is_tensor(pos[0]):
            table = pos[0]
            nbytes = sum(t.numel() * t.element_size() for t in (
                table.buckets, table.cols, table.nodes, table.zero_nodes, x,
                out))
        ops = int(((cols >= 0) & (cols < x.shape[0])).sum()) * x[0].numel()
        return nbytes, ops, PEAK_F32, cols.numel() * x[0].numel()
    if name in ("sddmm_tiles", "fused_attention_rows", "attn_variant"):
        mask, a = pos[2], pos[3]
        hd = a.shape[-1] * (a.shape[1] if a.dim() == 3 else 1)
        live = (int(mask.sum()) if kw.get("use_mask", True)
                else mask.numel())
        per = 2 if name == "sddmm_tiles" else 4
        ops, dense = per * live * hd, per * mask.numel() * hd
    elif name == "spmm_dotonly":
        tile_cols, x = pos[1], pos[2]
        ops = dense = 2 * tile_cols.numel() * 128 * 128 * x[0].numel()
    else:   # K2, K3, S1, S2: the nonzero tile values times d
        vals = next(t for t in pos if torch.is_tensor(t) and t.dim() >= 3
                    and t.is_floating_point())
        ops = 2 * int((vals != 0).sum()) * out.shape[-1]
        dense = 2 * vals.numel() * out.shape[-1]
    peak = PEAK_BF16 if out.dtype == torch.bfloat16 else PEAK_MMA_F32
    return nbytes, ops, peak, dense


def bound(name, args, out):
    """The least time on the card (ms), what sets it, the bytes and
    operations, and the tile-dense operations."""
    nbytes, ops, peak, dense = work(name, args, out)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops, dense)


def _heads_first(x, rows):
    """(n, [H,] d) → (H, rows, d) contiguous, rows past n zero."""
    xh = x if x.dim() == 3 else x[:, None]
    out = xh.new_zeros((xh.shape[1], rows, xh.shape[2]))
    out[:, : xh.shape[0]] = xh.permute(1, 0, 2)
    return out


def _edges(ptr, cols, mask, rows=None):
    """Global (row, col) of every edge of a tile view, and the (t, r, c)
    of each, in row-major order of (row, col)."""
    if rows is None:
        rows = torch.repeat_interleave(
            torch.arange(ptr.numel() - 1, device=ptr.device),
            torch.diff(ptr.long()))
    t, r, c = mask.nonzero(as_tuple=True)
    gr, gc = rows.long()[t] * 128 + r, cols.long()[t] * 128 + c
    order = torch.argsort(gr * (int(gc.max()) + 1) + gc)
    return gr[order], gc[order], (t[order], r[order], c[order])


def bsr_yardstick(ptr, cols, vals, x):
    """``torch.sparse_bsr_tensor(ptr, cols, vals[h]) @ x[:, h]``, one call
    per head (PyTorch refuses a BSR product batched over heads: "expand is
    unsupported for SparseBsr tensors")."""
    v = vals if vals.dim() == 4 else vals[None]
    h, nrb = v.shape[0], ptr.numel() - 1
    ncb = -(-x.shape[0] // 128)
    xp = _heads_first(x, ncb * 128)                      # (H, N, d)
    per_head = [torch.sparse_bsr_tensor(ptr, cols, v[i],
                                        size=(nrb * 128, ncb * 128))
                for i in range(h)]

    def fn():
        return [m @ xp[i] for i, m in enumerate(per_head)]

    def check(want):
        got = torch.stack(fn()).permute(1, 0, 2)[: want.shape[0]]
        return float((got - want.reshape(got.shape)).abs().max())

    return f"torch.sparse_bsr_tensor @ dense ({h} calls, one a head)", \
        fn, check


def col_bsr_yardstick(ptr_c, perm, rows, vals, y):
    """K3's function as the BSR product of the transposed tile view."""
    v = vals if vals.dim() == 4 else vals[None]
    p = perm.long()
    vt = v[:, p].transpose(-1, -2).contiguous()
    what, fn, check = bsr_yardstick(ptr_c, rows[p].contiguous(), vt, y)
    return what.replace("@", "(transposed view) @"), fn, check


def sampled_yardstick(rows, cols, mask, a, b):
    """``torch.sparse.sampled_addmm`` on the edges as a CSR of ones, per
    head."""
    gr, gc, (t, r, c) = _edges(None, cols, mask, rows)
    ones = torch.ones(gr.numel(), device=a.device, dtype=a.dtype)
    csr = torch.sparse_coo_tensor(torch.stack([gr, gc]), ones,
                                  size=(a.shape[0], b.shape[0])
                                  ).coalesce().to_sparse_csr()
    ah = _heads_first(a, a.shape[0])
    bt = _heads_first(b, b.shape[0]).transpose(1, 2).contiguous()

    def fn():
        return [torch.sparse.sampled_addmm(csr, ah[i], bt[i], beta=0.0)
                for i in range(ah.shape[0])]

    def check(want):
        got = torch.stack([m.values() for m in fn()])
        want = want if want.dim() == 4 else want[None]
        return float((got - want[:, t, r, c]).abs().max())

    return f"torch.sparse.sampled_addmm (CSR, per head, {ah.shape[0]} " \
           f"calls)", fn, check


def sdpa_yardstick(ptr, cols, mask, q, k, v, scale):
    """``F.scaled_dot_product_attention`` with the tile view's dense boolean
    mask, and the backend PyTorch takes for these f32 inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gr, gc, _ = _edges(ptr, cols, mask)
    dense = torch.zeros(q.shape[0], k.shape[0], dtype=torch.bool,
                        device=q.device)
    dense[gr, gc] = True
    q4, k4, v4 = (_heads_first(t, t.shape[0])[None] for t in (q, k, v))

    def fn():
        return sdpa(q4, k4, v4, attn_mask=dense, scale=scale)

    backend = "none"
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]):
                fn()
            backend = be.name
            break
        except RuntimeError:
            continue

    def check(want):
        got = fn()[0].permute(1, 0, 2)
        return float((got - want.reshape(got.shape)).abs().max())

    return (f"F.scaled_dot_product_attention, dense bool mask "
            f"{q.shape[0]}x{k.shape[0]} ({backend} backend)", fn, check)


def embedding_bag_yardstick(cols, x):
    """``F.embedding_bag(cols, x with a zero row appended, mode="sum")``."""
    xz = torch.cat([x, x.new_zeros(1, x.shape[1])])

    def fn():
        return torch.nn.functional.embedding_bag(cols, xz, mode="sum")

    def check(want):
        return float((fn() - want).abs().max())

    return "F.embedding_bag(mode='sum')", fn, check


def yardstick(name, args):
    """One PyTorch call computing kernel ``name``'s function on these
    inputs, built outside the timing: (what, fn, check), or (why there is
    none, None, None)."""
    pos, _ = split_kwargs(args)
    if name in ("spmm_row_sweep", "spmm_row_sweep_dma_v2"):
        return bsr_yardstick(*pos[:4])
    if name == "spmm_col_sweep":
        return col_bsr_yardstick(*pos[:5])
    if name == "spmm_dotonly":
        from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
            DOTONLY_VALUE,
        )

        ptr, cols, x = pos[:3]
        full = torch.full((cols.numel(), 128, 128), DOTONLY_VALUE,
                          device=x.device)
        return bsr_yardstick(ptr, cols, full, x)
    if name == "sddmm_tiles":
        return sampled_yardstick(*pos[:5])
    if name == "fused_attention_rows":
        return sdpa_yardstick(*pos[:7])
    if name == "gather_sum":
        cols, x = pos[:2]
        if not torch.is_tensor(cols):
            if cols.buckets.shape[0] != 1:
                return "n/a (embedding_bag takes one width)", None, None
            cols = cols.cols.reshape(cols.n_out, -1)
        return embedding_bag_yardstick(cols, x)
    return "n/a (a diagnostic)", None, None


def time_library(label, key, lib, want, timing):
    """Time a yardstick twice and check it against the plain version's
    output ``want``; returns its ms or None."""
    what, fn, check = lib
    if fn is None:
        log(f"[library] {key:30s} {label}: {what}")
        return None
    try:
        err = check(want)
    except RuntimeError as exc:     # PyTorch has no such call for these
        log(f"[library] {key:30s} {label}: {what} refused these inputs: "
            f"{str(exc).splitlines()[0]}")
        return None
    ms = [time_ms(fn, **timing) for _ in range(2)]
    log(f"[library] {key:30s} {label}: {what} {ms[0]:.4f}/{ms[1]:.4f} ms, "
        f"max abs err vs plain {err:.3e}")
    return sum(ms) / 2


def time_row(kern, key, args, label, timing, lib=None):
    """A kernel and its plain version on the same inputs, in turns (plain,
    kernel, kernel, plain: each time the mean of two), its bound on these
    inputs and, if ``lib`` is given, the library yardstick's time."""
    name = key.partition(":")[0]
    pos, kw = split_kwargs(args)
    fn, plain = kern.table[name][:2]
    want = plain(*pos, **kw)
    bound_ms, bound_by, nbytes, ops, dense = bound(name, args, want)
    p1 = time_ms(lambda: plain(*pos, **kw), **timing)
    k1 = time_ms(lambda: fn(*pos, **kw), **timing)
    k2 = time_ms(lambda: fn(*pos, **kw), **timing)
    p2 = time_ms(lambda: plain(*pos, **kw), **timing)
    row = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, library="n/a")
    log(f"[time] {key:30s} {label:11s} kernel {k1:.4f}/{k2:.4f} ms  plain "
        f"{p1:.4f}/{p2:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP) share "
        f"{bound_ms / row['ms']:.3f}; tile-dense {dense / 1e9:.3f} GFLOP, "
        f"bound {dense / PEAK_MMA_F32 * 1e3:.4f} ms, "
        f"{dense / row['ms'] / 1e9:.1f} TFLOP/s")
    if lib:
        built = yardstick(name, args) if lib is True else lib
        row["library"] = built[0]
        row["library_ms"] = time_library(label, key, built, want, timing)
        if row["library_ms"] is None and built[1] is not None:
            row["library"] = f"n/a ({built[0]} refused these inputs)"
    del want
    return row


def phase_times(kern, slice_inputs, train_step):
    """Each slice kernel against its plain version and its library
    yardstick at h=8 d=64 (K4 also against S5 with exp and mask, the
    CUDA-core kernel), K2/K3 at d=1024; then one train step."""
    tgt, q, k, v, vals, x = slice_inputs
    times = {}
    narrow = kernel_calls(tgt, q, k, v, vals)
    narrow["attn_variant:exp,mask"] = narrow["fused_attention_rows"]
    wide = kernel_calls(tgt, x, x, x, vals[0])
    for label, calls in (("h=8 d=64", narrow), (f"h=1 d={WIDE}", wide)):
        for key, args in calls.items():
            if label != "h=8 d=64" and key == "fused_attention_rows":
                continue
            times[(key, label)] = time_row(
                kern, key, args, label, {},
                lib=label == "h=8 d=64" and key in SLICE_KERNELS)
            torch.cuda.empty_cache()
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
        f"density={tg.density:.4f} live 16x8 fragments "
        f"{live_share(tg.mask):.4f}; host build {case.host_s:.2f} s, with "
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
    # K1-K3 as the grid attention's backward runs them.
    errs.update(check_kernels(
        kern, kernel_calls(tg, case.q_al, case.q_al, case.q_al, case.vals),
        f"grid d={GRID_D}", only=TILE_KERNELS))
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
    # d = 33 moves x through S1/S2's and K4's 4-byte copies (rows not
    # 16-byte aligned); d = 100 leaves K4's second 64-feature chunk partly
    # empty; d = 200 runs K4/S5's D = 256 instantiation.
    for d in (GRID_D, 100, 40, 33, 200):
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
    """The grid kernels against their plain versions and library
    yardsticks at d = 128: S1, S2, S4, K4 (new, and old as S5 with exp and
    mask), every S5 setting, and K1-K3 at the grid's shapes."""
    from custom_op_benchmark_tpu_torch.utils.bench_suite import (
        tiled_grid_attention,
    )

    times = {}
    calls = grid_kernel_calls(case.tg, case.q_al, case.vals, None)
    sweep = kernel_calls(case.tg, case.q_al, case.q_al, case.q_al, case.vals)
    bsr = yardstick("spmm_row_sweep_dma_v2", calls["spmm_row_sweep_dma_v2"])
    no_sdpa = ("n/a (dense mask of 1.1 TB)", None, None)
    label = f"grid d={GRID_D}"
    for key, args, lib in (
            ("spmm_row_sweep_dma", calls["spmm_row_sweep_dma"], bsr),
            ("spmm_row_sweep_dma_v2", calls["spmm_row_sweep_dma_v2"], bsr),
            ("spmm_dotonly", calls["spmm_dotonly"], True),
            (f"fused_attention_rows:d={GRID_D}",
             calls[f"fused_attention_rows:d={GRID_D}"], no_sdpa),
            *((k, calls[k], None) for k in S5_SETTINGS),
            ("sddmm_tiles", sweep["sddmm_tiles"], True),
            ("spmm_row_sweep", sweep["spmm_row_sweep"], bsr),
            ("spmm_col_sweep", sweep["spmm_col_sweep"], True)):
        times[key] = time_row(kern, key, args, label, GRID_TIMING, lib=lib)
        torch.cuda.empty_cache()
    del bsr, sweep
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
    from custom_op_benchmark_tpu_torch.graph.ell import one_bucket_table

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
    packings = [(f"{ladder},{eg.direction}", eg)
                for ladder, pair in (("pow2", (case.se, case.de)),
                                     ("train", train)) for eg in pair]
    for name, eg in packings:
        calls[f"gather_sum:{name},table"] = (eg.gather_table, case.q)
    errs = check_kernels(kern, calls, "power law / S3")
    torch.cuda.synchronize()
    s3_table_checks(kern, "power law", packings, case.q)
    return errs, (one_bucket_table(cols), x)


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
    table, x = s3_inputs
    gather = exp_pallas_gather.run(table.cols.reshape(table.n_out, -1), x,
                                   **GRID_TIMING)
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


def irregular_graph(rng, dev):
    """n = 300 (not a multiple of 128); row block 1 has no out-edges and
    column block 2 no in-edges. Returns the graph and its tile view."""
    from custom_op_benchmark_tpu_torch.graph import from_coo, tile_graph

    n_small = 300
    src = rng.choice(np.r_[0:128, 256:n_small], size=4000)
    dst = rng.choice(np.r_[0:256], size=4000)
    g = from_coo(src, dst, n_small, device=dev)
    return g, tile_graph(g, 128, 128, device=dev)


def phase_bf16(kern, dev, g, slice_inputs):
    """K1-K4 on bf16 inputs against their plain versions (one bf16
    rounding) at the slice's shapes and on the irregular graph; the op
    family and the attention through ``impl="tiled"`` in bf16 against f32,
    forward and backward, with the launch counters set to 0 before and
    read after; times at the slice's shapes."""
    from custom_op_benchmark_tpu_torch import ops

    tgt, q, k, v, vals, _ = slice_inputs
    b16 = [t.bfloat16() for t in (q, k, v, vals)]
    calls = kernel_calls(tgt, *b16)
    errs = check_kernels(kern, calls, "slice h=8 d=64 bf16")
    rng = np.random.default_rng(SEED + 8)
    _, small = irregular_graph(rng, dev)
    for hh, dd in ((2, 64), (1, 33), (1, 200)):
        qs, ks, vs = (normal(rng, small.n_nodes, hh, dd,
                             device=dev).bfloat16() for _ in range(3))
        sv = normal(rng, hh, small.num_tiles, 128, 128, device=dev)
        sv = torch.where(small.mask, sv, 0.0).bfloat16()
        check_kernels(kern, kernel_calls(small, qs, ks, vs, sv),
                      f"irregular n=300 h={hh} d={dd} bf16")
    torch.cuda.synchronize()

    # The op family (tests/test_dtypes.py) and the attention on the
    # clique batch, h=8 d=64, through the tile strategy. Inputs of scale
    # 0.35 keep the scores near 1, where 2e-2 holds a bf16 sum of 64
    # products.
    gd = g.to(dev)
    a32, b32 = (0.35 * normal(rng, g.n_nodes, 8, 64, device=dev)
                for _ in range(2))

    def family(a, b):
        a, b = a.detach().requires_grad_(), b.detach().requires_grad_()
        s = ops.sddmm(gd, a, b, impl="tiled")
        al = ops.edge_softmax(gd, s, by="src", impl="tiled")
        y = ops.vector_spmm(gd, al, b, impl="tiled")
        att = ops.attention(gd, a, b, b, impl="tiled")
        (y.float().sum() + att.float().sum()).backward()
        return [t.detach() for t in (s[: g.n_edges], al[: g.n_edges], y,
                                     att, a.grad, b.grad)]

    want = family(a32, b32)
    kern.reset()
    got = family(a32.bfloat16(), b32.bfloat16())
    torch.cuda.synchronize()
    launches = kern.launches()
    names = ("scores", "alpha", "spmm", "attention", "grad a", "grad b")
    for i, (name, lo, hi) in enumerate(zip(names, got, want)):
        assert lo.dtype == torch.bfloat16, (name, lo.dtype)
        assert torch.isfinite(lo.float()).all(), name
        # The forward outputs are gated; the gradients, sums of many bf16
        # roundings, are reported.
        ok = i >= 4 or torch.allclose(lo.float(), hi, rtol=DTYPE_RTOL,
                                      atol=DTYPE_ATOL)
        log(f"[bf16] op family via tiled, {name:9s} bf16 vs f32 max abs diff "
            f"{float((lo.float() - hi).abs().max()):.3e} (max|f32| "
            f"{float(hi.abs().max()):.3e}) "
            f"{'reported' if i >= 4 else 'ok' if ok else 'FAIL'}")
        assert ok, f"bf16 {name} disagrees with f32"
    log(f"[bf16] launches of the bf16 op family and attention, forward and "
        f"backward: {launches}")
    assert all(launches[n] > 0 for n in SLICE_KERNELS), launches
    del got, want
    times = {}
    for key in SLICE_KERNELS:
        times[key] = time_row(kern, key, calls[key], "h=8 d=64 bf16", {},
                              lib=True)
        torch.cuda.empty_cache()
    return errs, launches, times


def phase_wide_k4(kern, dev, tg):
    """K4 at heads wider than 128 (the wide form): against its plain
    version at 1e-4, bit for bit on repeat, on the irregular graph; the
    attention op through ``impl="tiled"`` counted; times. Then the same
    widths, one head, on the slice's tiles (n = 15,360), checked and timed
    beside SDPA: the irregular graph is small enough for a dense mask to
    win, the slice shows the kernel where the graph is real."""
    from custom_op_benchmark_tpu_torch import ops

    rng = np.random.default_rng(SEED + 9)
    g, small = irregular_graph(rng, dev)
    errs, launches, times = {}, {}, {}
    for d in K4_WIDE:
        key = f"fused_attention_rows:slice d={d}"
        args = (tg.tile_ptr, tg.tile_cols, tg.mask,
                *(normal(rng, tg.n_nodes, d, device=dev) for _ in range(3)),
                d ** -0.5)
        check_kernels(kern, {key: args}, "slice h=1 wide K4")
        time_row(kern, key, args, f"slice d={d}", {}, lib=True)
        del args
        torch.cuda.empty_cache()
    for d in K4_WIDE:
        qs, ks, vs = (normal(rng, small.n_nodes, d, device=dev)
                      for _ in range(3))
        key = f"fused_attention_rows:d={d}"
        call = {key: (small.tile_ptr, small.tile_cols, small.mask, qs, ks,
                      vs, d ** -0.5)}
        errs.update(check_kernels(kern, call, "irregular n=300 wide K4"))
        kern.reset()
        y = ops.attention(g, qs, ks, vs, impl="tiled")
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and y.shape == qs.shape
        launches[key] = kern.launches()["fused_attention_rows"]
        log(f"[wide] attention(impl='tiled') at d={d}: K4 launches "
            f"{launches[key]}")
        assert launches[key] == 1, launches
        times[key] = time_row(kern, key, call[key], f"n=300 d={d}", {},
                              lib=True)
    return errs, launches, times


def phase_block(kern, dev, g):
    """The dense-block path at full width: ``impl="auto"`` resolves to the
    dense blocks; the clique GAT step (3 layers, 8 heads of 64) on the
    block layout against the segment path on the card; three steps of
    ``fit_full_graph(strategy="auto")``; the step time and peak memory;
    ``vector_spmm`` at d = 1024 through auto, tiled (K2) and xla."""
    from custom_op_benchmark_tpu_torch import ops
    from custom_op_benchmark_tpu_torch.data.synthetic import (
        NodeClassificationDataset,
    )
    from custom_op_benchmark_tpu_torch.models import GAT
    from custom_op_benchmark_tpu_torch.ops import dispatch
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        fit_full_graph,
        make_train_step,
        masked_cross_entropy,
    )

    gd = g.to(dev)
    t0 = time.perf_counter()
    strategy = dispatch.resolve(gd, "auto")
    bg = dispatch.get_block(gd)
    log(f"[block] resolve(clique_batch{CLIQUES}, 'auto') = {strategy!r}; "
        f"{dispatch.summary(gd)}; B={bg.num_blocks} L={bg.block_len}; host "
        f"build {time.perf_counter() - t0:.2f} s")
    assert strategy == "dense_block", strategy
    rng = np.random.default_rng(SEED + 10)
    n, c = g.n_nodes, BLOCK_GAT["out_dim"]
    ds = NodeClassificationDataset(
        graph=g,
        features=rng.standard_normal((n, BLOCK_FEAT), dtype=np.float32),
        labels=rng.integers(0, c, size=n).astype(np.int32),
        train_mask=(train := rng.random(n) < 0.6), val_mask=~train,
        test_mask=np.zeros(n, bool), num_classes=c, name="cliques")
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    model = GAT(**BLOCK_GAT, in_dim=BLOCK_FEAT,
                generator=torch.Generator().manual_seed(SEED)).to(dev)
    runs = {}
    for path, views in (("segment", {}), ("block", {"block": bg})):
        model.zero_grad(set_to_none=True)
        logits = model(gd, x, **views)
        loss = masked_cross_entropy(logits, labels, mask)
        loss.backward()
        runs[path] = (logits.detach(), loss.detach(),
                      {k: p.grad for k, p in model.named_parameters()})
    (lg_s, ls_s, gr_s), (lg_b, ls_b, gr_b) = runs["segment"], runs["block"]
    assert torch.isfinite(lg_b).all() and lg_b.shape == (n, c)
    worst = ("", 0.0)
    for key, got, want in ([("logits", lg_b, lg_s), ("loss", ls_b, ls_s)]
                           + [(k, gr_b[k], gr_s[k]) for k in gr_s]):
        e = rel_err(got, want)
        assert e <= MODEL_RTOL, f"block GAT {key}: block vs segment {e:.3e}"
        worst = max(worst, (key, e), key=lambda t: t[1])
    log(f"[block] GAT block vs segment on the card: logits, loss and "
        f"{len(gr_s)} gradients within {MODEL_RTOL:g} of max|segment| "
        f"(worst {worst[0]} {worst[1]:.3e})")
    del runs, lg_s, ls_s, gr_s, lg_b, ls_b, gr_b

    kern.reset()
    _, metrics = fit_full_graph(model, ds, epochs=3, log_every=1,
                                strategy="auto")
    torch.cuda.synchronize()
    losses = [h["loss"] for h in metrics["history"]]
    log(f"[block] fit_full_graph(strategy='auto'), 3 epochs: losses {losses} "
        f"val_acc {metrics['val_acc']:.4f}; kernel launches "
        f"{kern.launches()}")
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    state = create_train_state(model)
    step = make_train_step(apply_kwargs={"block": bg})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, gd, x, labels, mask), warmup=1,
                      iters=3, repeats=3)
    peak = sync_peak_gib()
    log(f"[time] clique GAT train step (block, 3 layers, 8x64, AdamW) "
        f"{step_ms:.3f} ms, peak memory {peak:.2f} GiB")
    del state, step, model

    # The headline bench's workload and gate (bench.py:51-145).
    xw = normal(rng, n, WIDE, device=dev)
    ed = torch.rand(gd.num_edges_padded, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    kern.reset()
    ys = {impl: ops.vector_spmm(gd, ed, xw, impl=impl)
          for impl in ("auto", "tiled", "xla")}
    torch.cuda.synchronize()
    k2 = kern.launches()["spmm_row_sweep"]
    for impl in ("auto", "tiled"):
        ok = torch.allclose(ys[impl], ys["xla"], rtol=SUITE_TOL,
                            atol=SUITE_TOL)
        log(f"[block] vector_spmm d={WIDE} impl={impl!r} vs 'xla': max abs "
            f"diff {float((ys[impl] - ys['xla']).abs().max()):.3e} "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, impl
    assert k2 == 1, k2
    spmm_ms = {impl: time_ms(lambda: ops.vector_spmm(gd, ed, xw, impl=impl))
               for impl in ("auto", "tiled")}
    log(f"[time] vector_spmm d={WIDE} on 512x30 cliques: dense_block "
        f"{spmm_ms['auto']:.4f} ms, tiled (K2) {spmm_ms['tiled']:.4f} ms")
    return dict(step_ms=step_ms, peak=peak, spmm_ms=spmm_ms)


def l2_gather_rate(dev):
    """Bytes per second that S3 gathers from a table resident in the 50 MB
    L2 (8 MiB: L2_TABLE_ROWS rows of 128 floats), in the experiment's
    pattern (125,000 rows of 16 random slots): the rate that bounds a
    gather whose rows mostly hit L2."""
    from custom_op_benchmark_tpu_torch.graph.ell import one_bucket_table
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
        gather_sum,
    )

    rng = np.random.default_rng(SEED + 11)
    x = normal(rng, L2_TABLE_ROWS, POWERLAW[2], device=dev)
    cols = torch.from_numpy(rng.integers(
        0, L2_TABLE_ROWS, size=(125_000, 16)).astype(np.int32)).to(dev)
    table = one_bucket_table(cols)
    ms = time_ms(lambda: gather_sum(table, x))
    rate = cols.numel() * x.shape[1] * 4 / (ms / 1e3)
    log(f"[s3] L2 gather rate: {cols.numel()} rows of {x.shape[1]} floats "
        f"from an {x.numel() * 4 / 2**20:.0f} MiB table in {ms:.4f} ms: "
        f"{rate / 1e12:.3f} TB/s")
    return rate


def s3_table_checks(kern, label, packings, x):
    """S3 over each packing's table in one launch against the per-bucket
    result (S3 on each bucket alone, assembled through row_pos), bit for
    bit; one launch per copy-sum."""
    from custom_op_benchmark_tpu_torch.ops import ell
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
        gather_sum,
    )

    for name, eg in packings:
        kern.reset()
        new = ell._copy_agg_raw(eg, x)
        torch.cuda.synchronize()
        assert kern.launches()["gather_sum"] == 1, kern.launches()
        old = ell.ell_combine_rows(eg, [gather_sum(b.cols, x)
                                        for b in eg.buckets])
        same = torch.equal(new, old)
        log(f"[s3] {label} {name}: {len(eg.buckets)} buckets in one launch "
            f"(table {tuple(eg.gather_table.buckets.shape)}), same bits as "
            f"per bucket: {same}")
        assert same, (label, name)


def counted_copy_sums(ell_module, fn):
    """Run ``fn`` with S3's launch counter at 0, and return how many ELL
    copy-sums (``ops.ell._copy_agg_raw`` calls) it made."""
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
        gather_sum,
    )

    real, calls = ell_module._copy_agg_raw, []

    def counted(*a):
        calls.append(1)
        return real(*a)

    gather_sum.launches = 0
    ell_module._copy_agg_raw = counted
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ell_module._copy_agg_raw = real
    return len(calls)


def arxiv_model(name, num_classes, in_dim):
    from custom_op_benchmark_tpu_torch import models

    return getattr(models, name)(
        out_dim=num_classes, in_dim=in_dim, **ARXIV_MODELS[name],
        generator=torch.Generator().manual_seed(SEED))


def phase_arxiv(kern, dev):
    """The arxiv configuration on the ELL path: parity against the segment
    path, S3 counted in the forward and the backward, three AdamW steps
    through fit_full_graph, step times and peak memory."""
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.ops import ell as ell_ops
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
    s3_table_checks(kern, "arxiv train", [("src", se), ("dst", de)], x)
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
            sums = counted_copy_sums(ell_ops, lambda: step(state, g, x,
                                                           labels, mask))
            launches = gather_sum.launches
            results[(name, path)] = (ms, peak, launches)
            log(f"[time] arxiv {name} train step ({path}) {ms:.3f} ms, "
                f"peak memory {peak:.2f} GiB, S3 launches a step {launches} "
                f"({sums} copy-sums)")
            assert launches == sums, (name, path, launches, sums)
            del state, step
        del model
    return results


def phase_s3_times(kern, s3_inputs, l2_rate):
    """S3 at the experiment's shape (a one-bucket table) against its plain
    version and embedding_bag, with a second bound: the gathered bytes at
    the card's L2 gather rate."""
    row = time_row(kern, "gather_sum", s3_inputs, "125000x16 d=128", {},
                   lib=True)
    table, x = s3_inputs
    gathered = table.cols.numel() * x.shape[1] * 4
    row["bound_l2_ms"] = gathered / l2_rate * 1e3
    log(f"[time] gather_sum gathers {gathered / 1e9:.3f} GB: at the L2 "
        f"gather rate {l2_rate / 1e12:.3f} TB/s that takes "
        f"{row['bound_l2_ms']:.4f} ms (share "
        f"{row['bound_l2_ms'] / row['ms']:.3f})")
    return row


def kernel_row(name, source, replaces, n, err, row, shape):
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": n, "max_abs_err": err,
           "ms": row["ms"], "plain_ms": row["plain_ms"],
           "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
           "library_ms": row["library_ms"], "library": row["library"],
           "shape": shape}
    if "bound_l2_ms" in row:
        out["bound_l2_ms"] = row["bound_l2_ms"]
    return out


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
    del train_step, model
    torch.cuda.empty_cache()
    bf16_errs, bf16_launches, bf16_times = phase_bf16(kern, dev, g,
                                                      slice_inputs)
    del slice_inputs
    torch.cuda.empty_cache()
    wide_errs, wide_launches, wide_times = phase_wide_k4(kern, dev, tg)
    phase_block(kern, dev, g)
    gc.collect()
    torch.cuda.empty_cache()
    case = phase_grid_build(dev)
    grid_errs = phase_grid_parity(kern, dev, case)
    grid_launches = phase_grid_path(kern, case)
    grid_times = phase_grid_times(kern, case)
    torch.cuda.synchronize()
    del case
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[grid] device memory still allocated after the grid: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pl_case, train = phase_powerlaw_build(dev)
    s3_errs, s3_inputs = phase_s3_parity(kern, dev, pl_case, train)
    del train
    phase_powerlaw_path(kern, pl_case, s3_inputs)
    del pl_case
    torch.cuda.empty_cache()
    arxiv = phase_arxiv(kern, dev)
    s3_times = phase_s3_times(kern, s3_inputs, l2_gather_rate(dev))
    torch.cuda.synchronize()
    report = []
    for name, (_, _, source, replaces) in kern.table.items():
        if name in SLICE_KERNELS:
            row, err = times[(name, "h=8 d=64")], errs[name]
            n, shape = launches[name], "GraphTransformer slice, h=8 d=64"
        elif name == "gather_sum":
            row, err = s3_times, s3_errs["gather_sum:experiment"]
            n = arxiv["s3_launches"]
            shape = ("ELL bucket 125000x16, d=128 (exp_pallas_gather, a "
                     "one-bucket table); launches: GCN and GraphSAGE "
                     "fit_full_graph, arxiv, one per copy-sum")
        else:
            # S5 with exp and mask: well posed on the grid's own inputs, so
            # its error and its time come from the same call.
            key = ("attn_variant:exp,mask" if name == "attn_variant"
                   else name)
            row, err = grid_times[key], grid_errs[key]
            n, shape = grid_launches[name], f"grid 1024x1024, d={GRID_D}"
        report.append(kernel_row(name, source, replaces, n, err, row,
                                 shape))
    for name in SLICE_KERNELS:
        _, _, source, replaces = kern.table[name]
        report.append(kernel_row(
            f"{name}:bf16", source, replaces, bf16_launches[name],
            bf16_errs[name], bf16_times[name],
            "slice h=8 d=64, bf16; launches: the bf16 op family and "
            "attention through impl='tiled', forward and backward"))
    _, _, source, replaces = kern.table["fused_attention_rows"]
    for key, row in wide_times.items():
        report.append(kernel_row(
            key, source, replaces, wide_launches[key], wide_errs[key], row,
            "irregular n=300, one head; launches: attention(impl='tiled')"))
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
