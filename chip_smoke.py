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
copy-sum over all of a packing's buckets. The fifth: the repo's own
entry points at full size — the headline bench (``bench.run``), the clique
suite (``bench_suite.run_suite``), ``experiments/bench_models.py`` and the
command line (``train/run.py``) on cora_gat, arxiv_gat and
arxiv_transformer — and GIN on the arxiv configuration. The sixth: the
dtype policy (the transformer slice and the arxiv GAT in bf16, GraphSAGE
on bf16 features with S3 in bf16), the flagship ``entry()`` and the
native graphcore library. The seventh: the segment path's sums on S3's
CSR entry, repeated bit for bit, and reddit_sage (GraphSAGE on fanout
25/10 neighbour samples) through the command line, with checkpoints and
resilient steps. The eighth: the distributed plans, P shards of a local
mesh on the one card — the products-like graph (244,400 nodes, ~10M
edges) on the halo plan of 8 shards, every plan's op against the
single-device op, a one-rank NCCL process mesh, the three ``*_dist``
configurations through the command line, ``fit_sampled_dp`` on
reddit_sage's dataset and ``dryrun_multichip``.

1. device: a CUDA device is present; print its name and power limit, then
   build the CUDA kernels from ``custom_op_benchmark_tpu_torch/csrc`` (one
   nvcc for each source, all started together); the L2 gather rate
   (``benchlib.l2_gather_rate``: the probe kernel csrc/l2_probe.cu), the
   bound of S3's rows, printed beside S3's own rate on the same
   L2-resident table (the earlier definition);
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
5. times: each kernel against its plain version, its bound on these
   inputs (bytes at 3.35 TB/s or f32-accurate products at 165 TFLOP/s,
   whichever is longer) and its library yardstick (one PyTorch call that computes the same function,
   timed here and used nowhere in the port); then one train step;
6. bf16: K1-K4 on bf16 inputs against their plain versions (one bf16
   rounding) at the slice's shapes and on the irregular graph (d = 64, 33,
   40, 200); the op family and the attention through ``impl="tiled"`` in bf16
   against f32 at 2e-2, forward and backward, counted; times with bounds
   at bf16 bytes and the bf16 tensor-core peak;
7. K4 at heads wider than 128 (the cluster form, its layout printed) on
   the irregular graph at d = 129, 200, 300, 1024 and 1100 (two clusters
   a row block) against its plain version at 1e-4, bit for bit on repeat,
   and in bf16 at d = 129, 200, 300 and 1100 (one bf16 rounding); through
   ``attention(impl="tiled")`` counted; d = 300 and 1024 timed on the
   irregular graph and on the slice's tiles beside SDPA;
8. the dense-block path: ``resolve(g, "auto") == "dense_block"``, the
   clique GAT's logits, loss and gradients on the block layout against
   the segment path on the card, three steps of
   ``fit_full_graph(strategy="auto")``, and ``vector_spmm`` at d = 1024
   through auto (dense blocks), tiled (K2) and xla, agreeing at 2e-3;
   then the entry points on the clique batch, each with the launch
   counters set to 0 before it and read after: the headline bench (its
   JSON line, ``auto_impl == "dense_block"``, ``kernel_parity_ok``, the
   clique GAT step, the power-law ELL attention over the L2 gather
   rate, also printed over S3's own rate),
   the clique suite (every gate and row; its K1-K4 launches are the
   suite rows' counts), K1-K4 at the suite's new shapes (K1-K3 one head
   at d = 1024, K4 one head at d = 128) against their plain versions,
   timed beside bounds and library calls, and ``bench_models`` (every
   row timed, the GAT's block and ELL outputs within 2e-3 of segment);
9. grid build: the graph, its tile-aligned order and tiling on the host,
   moved to the card;
10. grid kernel parity: S1, S2, S4, S5 (all four switch settings), K4 at
    d = 128 and d = 40 and K1-K3 at d = 128 against their plain versions
    at the grid's shapes, S1, S2 and K1-K4 also in bf16, K4 and S5 also
    at d = 200 and 300, and S1, S2 (f32 and bf16, with the copy path each
    d takes), S4, S5 and K4 again on the small irregular graph at d = 128,
    100, 40, 33, 200 and 300 (at 128 and 33 also with no tile at all and
    with x of no rows: zeros); S2 equal to K2 bit for bit at one head at every d in
    f32 and bf16, and S1 equal to S2 on the grid; S5 with exp and mask
    equal to K4 bit for bit at d = 40, 128 and 300;
11. the grid path: S1 and S2 against the segment oracle, then the grid
    suite (its allclose gates at 2e-3 and its timed rows, with roofline
    fractions against the measured copy bandwidth) and the two
    experiments' rows, with every launch counter set to 0 before and read
    after, float32 and bfloat16 launches apart;
12. grid times: S1, S2 (also in bf16), S4, S5, K4 and K1–K3 at d = 128
    against their plain versions, K1-K4 also in bf16 (K2 beside the bf16
    BSR call, K3 beside that of the transposed view), with bounds and
    library yardsticks as in 5, each S5
    setting beside K4's time, and the peak memory of the grid attention
    backward;
13. power-law build: the graph and its dual ELL packing on both ladders on
    the host (seconds and padding waste), moved to the card;
14. S3 parity against its plain version, bit-for-bit repeats: at the
    experiment's shape, on every bucket of both packings of both ladders
    at d = 128 and on each packing's whole table, at d = 1, 4, 8, 33, 64
    and 200, the src table also at d = 1, 4, 8 and 64, the src side's
    CSR rows (``pl_spmm/xla_segment``'s forward sum over identity slots)
    at d = 128 and 4, at an R that is not a multiple of 8 and on a bucket
    of padding only; the 27,565-slot hub of the src table and of the src
    CSR rows within 1e-4 relative of its f64 sum; the one-launch copy-sum
    against the per-bucket result, bit for bit, one launch each; S3 in
    bf16 (one rounding of f32 sums) at the experiment's shape, on every
    pow-2 bucket, every table, at d = 4, 33, 64 and 200 and on the src
    CSR rows, and ``ell_copy_spmm`` on bf16 features as one bf16 launch;
    then the two hub shapes timed (as in 18, ``embedding_bag`` with
    offsets over the table's rows and ``torch.segment_reduce``);
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
    memory of each path; one epoch of GIN (width 128) on the ELL path
    with its S3 launches;
17. the command line on cora_gat (with ``layer_allclose_ok``), arxiv_gat
    and arxiv_transformer at ``--scale 1``, ``--epochs 2``: finite
    losses, launches counted;
18. S3 times: S3 against its plain version and ``F.embedding_bag`` at the
    experiment's shape, in f32 and in bf16, and a second bound: its
    gathered bytes at the probe's L2 gather rate (phase 1);
19. dtype (after 16, with its arxiv data): the transformer slice in bf16
    on its tiles (K1-K4 in bf16 only), the arxiv GAT in bf16 on the ELL
    path and GraphSAGE on bf16 features (S3 in bf16), each against the f32
    model from the same weights at rtol 0.1 / atol 0.15, one counted bf16
    AdamW step, f32 and bf16 step times in turns and peak memory;
20. native: the graphcore library built from the port's own source and
    called by the graph builds so far; the dual CSR and both ELL packings
    of the power-law graph (2M edges) and of the arxiv graph, native
    against numpy, identical arrays, each timed on the host;
21. entry: ``entry()`` at its own size (32,768 nodes, 250,000 edges),
    logits and the packed edge-bias attention against a CPU copy (bf16
    tolerance, 1e-4), the forward timed, one backward through the remat'd
    bf16 GAT with finite gradients. 17 (the command line) runs after it;
22. csr (after 16, with its arxiv data): S3's CSR entry (``csr_sum``, the
    sorted segment sum of the segment path) against its plain version at
    the arxiv segment shapes (the copy form through ``src_csc`` at d = 128
    and 64, edge data by src and through the CSC permutation at d = 4 and
    8, one feature wide, bf16), bit for bit on repeat, timed at the copy
    shape and the narrow ones beside its bounds and ``embedding_bag`` with
    offsets; its launches in a GCN and a GAT segment step;
23. reddit build: reddit_sage's dataset at ``--scale 1`` (233,700 nodes,
    300-d features), features and labels on the card;
24. determinism: the cases of ``experiments/determinism.py`` (the segment
    pipeline forward and backward, ELL and block attention,
    ``fit_full_graph`` of a GAT with strategy None, "ell" and "block")
    and two full-width reddit_sage steps from one state and batch, each
    run twice and compared with ``torch.equal``;
25. sampled: S3 at a reddit_sage batch's shape (in_cols 70,656 × 32, d =
    300 and 128) and the CSR entry at its backward's shape against their
    plain versions, timed; prefetched batches against the same batches
    made in line; 20 steps of ``fit_sampled``'s step through the prefetch
    pipeline under ``torch.profiler`` (the device's idle share); then the
    command line on reddit_sage at ``--scale 1`` for its 2 epochs, the
    counters set to 0 before and read after: S3, the CSR entry and the
    native sampler ran, a finite loss, its step, sampling and evaluation
    times and peak memory;
26. dp (after 25, with its data): ``fit_sampled_dp`` (GraphSAGE 128, 2
    layers, fanouts (25, 10), batches of 256) over a local mesh of 4
    shards for 12 steps, the counters set to 0 before and read after (S3
    8 and the CSR entry 4 launches a step), step and sampling times, peak
    memory; two steps twice from one seed, bit for bit;
27. resilient: ``resilient_steps`` on cora_gat's GAT, N steps straight
    against k steps, a checkpoint and a resume from it in a fresh state,
    and a non-finite loss restored from the last checkpoint, bit for bit;
28. dist build: the products-like graph at ``--scale 1`` and its halo plan
    over 8 shards as the command line builds it (``build_plan``, order and
    hub threshold "auto"), each host step timed (both orders, both
    ``plan_stats``, ``halo_graph``, ``halo_ell``), the native packing
    against numpy's (identical arrays), the routes and order that ran;
    the plan goes to the cache under ``build/plan_cache``;
29. dist parity: on the card, 4 heads of 16, each op against the
    single-device ELL or segment op on the same renumbered graph, forward
    and every gradient at 1e-4, each twice and compared with
    ``torch.equal``: ``halo_attention_ell`` (hubs; 1-D and through the
    2-D edge × head mesh, whose head axis is a view on the local
    backend), ``halo_spmm_ell``, ``halo_spmm``,
    ``halo_gat_attention``, the gather plan's four ops, ``tp_attention``;
    bf16 per element; S3's CSR entry at the halo shape (d = 64, and 4)
    against its plain version, timed beside its bounds and
    ``torch.segment_reduce``, and its launches in the segment forms;
30. nccl: a one-rank NCCL group; one ``halo_attention_ell`` gradient step
    on the process mesh against the local mesh at P = 1 (1e-5);
31. dist CLI: ``products_gat_dist`` and ``products_transformer_dist`` at
    ``--scale 1`` (8 shards, the cached plan) and ``papers100m_gat_dist``
    at ``--scale 1`` (16 shards) through ``train.run.main``: finite
    losses, step times, peak memory, the plan's host seconds;
32. dryrun: ``dryrun_multichip(8)`` on the card, finite losses.

Each phase's seconds are printed. The line before the last is the
``kernels`` JSON: for each of the nine kernels, for K1-K4, S1, S2 and S3
in bf16, K1-K4 in bf16 on the grid, K4 at d = 300 and 1024, K1-K4 at the
clique suite's shapes, S3's CSR entry at the arxiv copy shape, S3 and the
CSR entry at a reddit_sage batch's shapes, the CSR entry at the halo
plan's shape (d = 64 and 4), S3's two hub shapes on the power-law graph
and the CSR entry at the arxiv narrow widths (d = 1, 4, 8 and the copy at
64), its source, the TPU kernel it replaces, its launches on its path, its
error, time, plain time, bound and library time.

Exits non-zero on any failure, and at once when no CUDA device is present.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import copy
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
# A bf16 model's f32 logits against the f32 model from the same weights
# (tests/test_dtypes.py:100-101): the activations carry bf16 roundings
# through every layer.
DTYPE_MODEL_TOL = dict(rtol=0.1, atol=0.15)
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
# bf16 products on the tensor cores (K1-K4, S1 and S2 take them natively
# at this rate).
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
# K4 at heads wider than 128 (the cluster form): the widths checked on the
# irregular graph (1100 takes two clusters a row block), those also
# checked in bf16, and those timed.
K4_WIDE_CHECKED = (129, 200, 300, 1024, 1100)
K4_WIDE_BF16 = (129, 200, 300, 1100)
K4_WIDE = (300, 1024)
# The clique suite's new kernel shapes (utils/bench_suite.run_suite): K1-K3
# at one head of 1024, K4 at one head of 128.
SUITE_D = 1024
SUITE_ATTN_D = 128
# The command line's ported configurations, run at --scale 1 with their
# depth cut to two epochs.
CLI_CONFIGS = ("cora_gat", "arxiv_gat", "arxiv_transformer")
CLI_EPOCHS = 2
# GIN on the arxiv configuration: width 128, one epoch on the ELL path.
GIN_MODEL = dict(hidden_dim=128, num_layers=2)
# reddit_sage (train/run.py): the command line at full width for its
# default 2 epochs; steps profiled for the device's idle share.
REDDIT_SCALE = 1
PROFILE_STEPS = 20
# resilient_steps on the card: N steps, and the step k of the checkpoint.
RESILIENT_STEPS = (8, 3)
# The distributed plans: the products-like configuration of the command
# line, its shard count and attention width, the plans' cache, the NCCL
# phase's graph (n, e), the configurations the command line runs (with
# their --scale) and the data-parallel run.
PRODUCTS_SCALE = 1
DIST_SHARDS = 8
DIST_HEADS, DIST_HEAD_DIM = 4, 16
DIST_TOL = 1e-4
PLAN_CACHE = Path(__file__).resolve().parent / "build" / "plan_cache"
NCCL_GRAPH = (16384, 200_000)
DIST_CLI = (("products_gat_dist", 1), ("products_transformer_dist", 1),
            ("papers100m_gat_dist", 1))
DP_SHARDS = 4
DP_STEPS = 12


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
    """The nine kernels and S3's CSR entry, their plain versions and where
    they came from."""

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
            # S3's CSR entry: the sorted segment sums of the segment path.
            "csr_sum": (
                ks.csr_sum, ks.csr_sum_plain,
                "custom_op_benchmark_tpu_torch/csrc/gather_sum.cu",
                "scripts/exp_pallas_gather.py:63"),
        }

    def reset(self):
        for fn, *_ in self.table.values():
            fn.launches = 0
            if hasattr(fn, "launches_bf16"):
                fn.launches_bf16 = 0

    def launches(self, bf16=False):
        """Each kernel's launches in float32, or with ``bf16`` in bfloat16,
        since the last reset."""
        attr = "launches_bf16" if bf16 else "launches"
        return {name: getattr(fn, attr, 0)
                for name, (fn, *_) in self.table.items()}


TILE_KERNELS = ("sddmm_tiles", "spmm_row_sweep", "spmm_col_sweep")
SLICE_KERNELS = TILE_KERNELS + ("fused_attention_rows",)
DMA_KERNELS = ("spmm_row_sweep_dma", "spmm_row_sweep_dma_v2")
GRID_KERNELS = DMA_KERNELS + ("spmm_dotonly", "attn_variant")
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


def grid_kernel_calls(tg, x, vals, x40, wp=None):
    """The grid kernels' arguments as the grid path gives them: ``tg`` the
    row-sorted tiling (SpMM), its transpose the attention's. ``wp`` (from
    ``well_posed_s5`` of ops/kernels/attention.py) feeds S5 without
    ``exp``; without it those two
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


def grid_bf16_calls(case):
    """K1-K3 in bf16 as the grid attention's backward runs them, and K4 in
    bf16 on the grid's transposed tiling, keyed ``<name>:bf16`` (K4
    ``fused_attention_rows:d=<d>:bf16``)."""
    x16 = case.q_al.bfloat16()
    calls = {f"{k}:bf16": a for k, a in kernel_calls(
        case.tg, x16, x16, x16, case.vals.bfloat16()).items()
        if k in TILE_KERNELS}
    tgt = case.tg.transpose()
    calls[f"fused_attention_rows:d={GRID_D}:bf16"] = (
        tgt.tile_ptr, tgt.tile_cols, tgt.mask, x16, x16, x16,
        GRID_D ** -0.5)
    return calls


def dma_bf16_calls(tg, x, vals):
    """S1 and S2 on bf16 vals and x, keyed ``<name>:bf16``."""
    from custom_op_benchmark_tpu_torch.ops.kernels.grid_dma import pad_layout

    x16, v16 = x.bfloat16(), vals.bfloat16()
    return {"spmm_row_sweep_dma:bf16": (*pad_layout(tg, v16), x16),
            "spmm_row_sweep_dma_v2:bf16": (tg.tile_ptr, tg.tile_cols, v16,
                                           x16)}


def dma_empty_calls(tg, vals, x):
    """S1 and S2 where no tile reaches the products, in x's dtype: no tile
    at all over ``tg``'s row blocks (S1 with max_tpr = 0, S2 with an empty
    tile list, which write zeros), and ``tg``'s tiles with an x of no
    rows."""
    from custom_op_benchmark_tpu_torch.ops.kernels.grid_dma import pad_layout

    nrb, dev = tg.num_row_blocks, x.device
    vals = vals.to(x.dtype)
    none = vals.new_zeros((0, 128, 128))
    return {
        "spmm_row_sweep_dma:no tiles": (
            torch.zeros((nrb, 0), dtype=torch.int32, device=dev),
            none.reshape(nrb, 0, 128, 128), x),
        "spmm_row_sweep_dma_v2:no tiles": (
            torch.zeros(nrb + 1, dtype=torch.int32, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev), none, x),
        "spmm_row_sweep_dma:n_x=0": (*pad_layout(tg, vals), x[:0]),
        "spmm_row_sweep_dma_v2:n_x=0": (tg.tile_ptr, tg.tile_cols, vals,
                                        x[:0]),
    }


def s2_is_k2(kern, tg, vals, x, label, s1_args=None):
    """S2 against K2 at one head on the same inputs: the same arithmetic,
    stage layout and order of sums, so the same bits; with ``s1_args``, S1
    against S2 as values (its padding tiles add exact zeros)."""
    from custom_op_benchmark_tpu_torch.ops.kernels.grid_dma import copy_path

    args = (tg.tile_ptr, tg.tile_cols, vals, x)
    s2 = kern.table["spmm_row_sweep_dma_v2"][0](*args)
    k2 = kern.table["spmm_row_sweep"][0](*args)
    torch.cuda.synchronize()
    same = torch.equal(s2, k2)
    msg = (f"[parity] {label:28s} S2 == K2 at d={x.shape[-1]} {x.dtype} "
           f"(copies: {copy_path(x)}): "
           f"{'same bits' if same else 'DIFFERENT'}")
    if s1_args is not None:
        s1 = kern.table["spmm_row_sweep_dma"][0](*s1_args)
        torch.cuda.synchronize()
        s1_same = torch.equal(s1.float(), s2.float())
        msg += f"; S1 == S2: {'same values' if s1_same else 'DIFFERENT'}"
        assert s1_same, f"S1 differs from S2 ({label})"
    log(msg)
    assert same, f"S2 differs from K2 ({label}, d={x.shape[-1]})"


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
    if name == "csr_sum":
        ptr, x = pos[:2]
        idx = pos[2] if len(pos) > 2 else None
        lo, hi = int(ptr[0]), int(ptr[-1])
        rows = (idx[lo:hi] if idx is not None
                else torch.arange(lo, hi, device=x.device))
        ops = int(((rows >= 0) & (rows < x.shape[0])).sum()) * x[0].numel()
        return nbytes, ops, PEAK_F32, ops
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
    if name == "csr_sum":
        return csr_yardstick(*pos[:3])
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
    yardstick at h=8 d=64 (K1-K3 at d=1024 are the clique suite's rows,
    timed in phase_suite_kernels); then one train step."""
    tgt, q, k, v, vals, _ = slice_inputs
    times = {}
    for key, args in kernel_calls(tgt, q, k, v, vals).items():
        times[(key, "h=8 d=64")] = time_row(kern, key, args, "h=8 d=64", {},
                                            lib=True)
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
    from custom_op_benchmark_tpu_torch.ops.kernels.attention import (
        well_posed_s5,
    )

    rng = np.random.default_rng(SEED + 2)
    tg = case.tg
    x40 = normal(rng, tg.n_nodes, 40, device=dev)
    wp = well_posed_s5(tg, GRID_D, device=dev, seed=SEED + 3)
    errs = check_kernels(kern, grid_kernel_calls(tg, case.q_al, case.vals,
                                                 x40, wp), f"grid d={GRID_D}")
    del wp
    # K1-K3 as the grid attention's backward runs them.
    errs.update(check_kernels(
        kern, kernel_calls(tg, case.q_al, case.q_al, case.q_al, case.vals),
        f"grid d={GRID_D}", only=TILE_KERNELS))
    b16 = dma_bf16_calls(tg, case.q_al, case.vals)
    errs.update(check_kernels(kern, b16, f"grid d={GRID_D} bf16"))
    # K1-K4 in bf16 at the grid's shapes (their times' error column).
    errs.update(check_kernels(kern, grid_bf16_calls(case),
                              f"grid d={GRID_D} bf16"))
    calls = grid_kernel_calls(tg, case.q_al, case.vals, None, None)
    s2_is_k2(kern, tg, case.vals, case.q_al, "grid",
             calls["spmm_row_sweep_dma"])
    s2_is_k2(kern, tg, *b16["spmm_row_sweep_dma_v2:bf16"][2:], "grid",
             b16["spmm_row_sweep_dma:bf16"])
    del b16, calls
    torch.cuda.empty_cache()
    calls = grid_kernel_calls(tg, case.q_al, case.vals, x40, None)
    s5_is_k4(kern, calls[f"fused_attention_rows:d={GRID_D}"], "grid")
    s5_is_k4(kern, calls["fused_attention_rows:d=40"], "grid")
    del calls, x40
    # K4/S5's cluster form at the grid's shapes (d = 200, 300: clusters of
    # 4 and 5 blocks of 64 features).
    for d in (200, 300):
        xw = normal(rng, tg.n_nodes, d, device=dev)
        wp = well_posed_s5(tg, d, device=dev, seed=SEED + 5)
        calls = grid_kernel_calls(tg, xw, case.vals, None, wp)
        check_kernels(kern, calls, f"grid d={d}",
                      only=("fused_attention_rows", "attn_variant"))
        if d == 300:
            s5_is_k4(kern, calls[f"fused_attention_rows:d={d}"], "grid")
        del wp, xw, calls
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    # The irregular graph of phase 2: an empty row and column block.
    n_small = 300
    src = rng.choice(np.r_[0:128, 256:n_small], size=4000)
    dst = rng.choice(np.r_[0:256], size=4000)
    from custom_op_benchmark_tpu_torch.graph import from_coo, tile_graph
    small = tile_graph(from_coo(src, dst, n_small), 128, 128, device=dev)
    # d = 33 moves x through S1/S2's and K4's 4-byte copies (rows not
    # 16-byte aligned); d = 100 leaves K4's second 64-feature chunk partly
    # empty; d = 200 and 300 run K4/S5's cluster form.
    for d in (GRID_D, 100, 40, 33, 200, 300):
        xs = normal(rng, n_small, d, device=dev)
        sv = torch.where(small.mask, normal(rng, small.num_tiles, 128, 128,
                                            device=dev), 0.0)
        wp = well_posed_s5(small, d, device=dev, seed=SEED + 4)
        check_kernels(kern, grid_kernel_calls(
            small, xs, sv, normal(rng, n_small, 40, device=dev), wp),
            f"irregular n=300 d={d}")
        check_kernels(kern, dma_bf16_calls(small, xs, sv),
                      f"irregular n=300 d={d} bf16")
        s2_is_k2(kern, small, sv, xs, "irregular n=300")
        s2_is_k2(kern, small, sv.bfloat16(), xs.bfloat16(), "irregular n=300")
        if d in (GRID_D, 33):
            for x_in in (xs, xs.bfloat16()):
                check_kernels(kern, dma_empty_calls(small, sv, x_in),
                              f"irregular n=300 d={d} {x_in.dtype}")
    torch.cuda.synchronize()
    return errs


def s5_is_k4(kern, args, label):
    """S5 with exp and mask against K4 on the same inputs: the same kernel
    instantiation and launch, so the same bits."""
    k4 = kern.table["fused_attention_rows"][0](*args)
    s5 = kern.table["attn_variant"][0](*args)
    torch.cuda.synchronize()
    same = torch.equal(k4, s5)
    log(f"[parity] {label:28s} S5(exp, mask) == K4 at d={args[3].shape[-1]}"
        f": {'same bits' if same else 'DIFFERENT'}")
    assert same, f"S5 with exp and mask differs from K4 ({label})"


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
    launches, bf16 = kern.launches(), kern.launches(bf16=True)
    log(f"[grid] launches on the grid path, float32: {launches}; bfloat16: "
        f"{bf16}")
    log(json.dumps({"grid_suite": records}))
    log(json.dumps({"grid_dma": dma}))
    log(json.dumps({"grid_bisect": bisect}))
    assert ok and suite_ok, "a grid gate failed"
    assert dma["allclose"] and dma["allclose_v2"], dma
    assert all(launches[k] > 0 for k in SLICE_KERNELS + GRID_KERNELS), \
        launches
    assert all(bf16[k] > 0 for k in DMA_KERNELS), bf16
    return launches, bf16


def phase_grid_times(kern, case):
    """The grid kernels against their plain versions and library
    yardsticks at d = 128: S1, S2, S4, K4, every S5 setting (each beside
    K4's time), K1-K3 at the grid's shapes, and K1-K4 in bf16 (K2 beside
    the bf16 BSR call, K3 beside the bf16 BSR call of the transposed view,
    K1 with its bytes bound: sampled_addmm takes no bf16; K4 with no
    library call, as in f32)."""
    from custom_op_benchmark_tpu_torch.utils.bench_suite import (
        tiled_grid_attention,
    )

    times = {}
    calls = grid_kernel_calls(case.tg, case.q_al, case.vals, None)
    sweep = kernel_calls(case.tg, case.q_al, case.q_al, case.q_al, case.vals)
    bsr = yardstick("spmm_row_sweep_dma_v2", calls["spmm_row_sweep_dma_v2"])
    b16 = dma_bf16_calls(case.tg, case.q_al, case.vals)
    bsr16 = yardstick("spmm_row_sweep_dma_v2",
                      b16["spmm_row_sweep_dma_v2:bf16"])
    sweep16 = grid_bf16_calls(case)
    no_sdpa = ("n/a (dense mask of 1.1 TB)", None, None)
    label = f"grid d={GRID_D}"
    for key, args, lib in (
            ("spmm_row_sweep_dma", calls["spmm_row_sweep_dma"], bsr),
            ("spmm_row_sweep_dma_v2", calls["spmm_row_sweep_dma_v2"], bsr),
            *((k, b16[k], bsr16) for k in b16),
            ("spmm_dotonly", calls["spmm_dotonly"], True),
            (f"fused_attention_rows:d={GRID_D}",
             calls[f"fused_attention_rows:d={GRID_D}"], no_sdpa),
            *((k, calls[k], None) for k in S5_SETTINGS),
            ("sddmm_tiles", sweep["sddmm_tiles"], True),
            ("spmm_row_sweep", sweep["spmm_row_sweep"], bsr),
            ("spmm_col_sweep", sweep["spmm_col_sweep"], True),
            ("spmm_row_sweep:bf16", sweep16["spmm_row_sweep:bf16"], bsr16),
            ("sddmm_tiles:bf16", sweep16["sddmm_tiles:bf16"], True),
            ("spmm_col_sweep:bf16", sweep16["spmm_col_sweep:bf16"], True),
            (f"fused_attention_rows:d={GRID_D}:bf16",
             sweep16[f"fused_attention_rows:d={GRID_D}:bf16"], no_sdpa)):
        times[key] = time_row(kern, key, args, label, GRID_TIMING, lib=lib)
        torch.cuda.empty_cache()
    k4_ms = times[f"fused_attention_rows:d={GRID_D}"]["ms"]
    for key in S5_SETTINGS:
        log(f"[time] {key:30s} {label:11s} {times[key]['ms']:.4f} ms = "
            f"{times[key]['ms'] / k4_ms:.3f} x K4's {k4_ms:.4f} ms")
    del bsr, bsr16, b16, sweep, sweep16
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


def powerlaw_hubs(case):
    """S3's two hub shapes on the power-law graph: the src side's CSR rows
    over identity slots (``pl_spmm/xla_segment``'s forward sum of its
    (E, d) messages) and the pow-2 src table (the hub's bucket is 32,768
    wide), each with its arguments."""
    from custom_op_benchmark_tpu_torch.ops import xla

    _, ptr, _ = xla._side(case.g, "src")
    return {"csr": (ptr, case.be), "ell": (case.se.gather_table, case.q)}


def hub_rows(name, args):
    """The row of S3's output with the most valid slots, and the rows of x
    those slots name."""
    if name == "csr_sum":
        ptr, x = args[:2]
        length = torch.diff(ptr.long())
        hub = int(length.argmax())
        return hub, torch.arange(int(ptr[hub]), int(ptr[hub + 1]),
                                 device=x.device)
    table, x = args
    off, w, first, rows = table.layout[0]           # the widest bucket
    c = table.cols[off: off + rows * w].reshape(rows, w).long()
    valid = (c >= 0) & (c < x.shape[0])
    i = int(valid.sum(1).argmax())
    return int(table.nodes[first + i]), c[i][valid[i]]


def hub_check(kern, key, args):
    """The hub row of S3's output on ``args`` within 1e-4 relative (of its
    largest value) of the f64 sum of its slots."""
    name = key.partition(":")[0]
    out = kern.table[name][0](*args)
    hub, rows = hub_rows(name, args)
    exact = args[1][rows].double().sum(0)
    rel = float((out[hub].double() - exact).abs().max()
                / exact.abs().max())
    log(f"[s3] {key} hub row {hub} ({rows.numel()} slots): within "
        f"{rel:.3e} of its f64 sum (relative)")
    assert rel < 1e-4, (key, rel)
    return rel


def phase_s3_parity(kern, dev, case, train):
    from custom_op_benchmark_tpu_torch.experiments import exp_pallas_gather
    from custom_op_benchmark_tpu_torch.graph.ell import one_bucket_table
    from custom_op_benchmark_tpu_torch.ops import ell as ell_ops

    rng = np.random.default_rng(SEED + 6)
    cols, x = exp_pallas_gather.inputs(dev)
    calls = {"gather_sum:experiment": (cols, x)}
    for ladder, pair in (("pow2", (case.se, case.de)), ("train", train)):
        for eg in pair:
            for b in eg.buckets:
                calls[f"gather_sum:{ladder},{eg.direction},D={b.width}"] = (
                    b.cols, case.q)
    widest = max(case.de.buckets, key=lambda b: b.num_rows)
    for d in (1, 4, 8, 33, 64, 200):
        calls[f"gather_sum:d={d}"] = (widest.cols,
                                      normal(rng, case.n, d, device=dev))
    # The src side's sums on the CSR entry (pl_spmm/xla_segment's forward:
    # identity slots over the src rows, the 27,565-slot hub among them),
    # also at d = 4, and the src table (the hub padded to 32,768 slots) at
    # narrow widths.
    hub = powerlaw_hubs(case)
    calls["csr_sum:powerlaw src rows"] = hub["csr"]
    calls["csr_sum:powerlaw src rows d=4"] = (
        hub["csr"][0], case.be[:, :4].contiguous())
    for d in (1, 4, 8, 64):
        calls[f"gather_sum:pow2,src,table,d={d}"] = (
            case.se.gather_table, normal(rng, case.n, d, device=dev))
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
    for key in ("csr_sum:powerlaw src rows", "gather_sum:pow2,src,table"):
        hub_check(kern, key, calls[key])
    s3_table_checks(kern, "power law", packings, case.q)

    # S3 in bf16 (one rounding of f32 sums): the experiment's shape, every
    # bucket of the pow-2 packings, every packing's table, the scalar path
    # (d = 33) and two feature chunks (d = 200).
    qb = case.q.bfloat16()
    calls16 = {"gather_sum:experiment,bf16": (cols, x.bfloat16())}
    for eg in (case.se, case.de):
        for b in eg.buckets:
            calls16[f"gather_sum:pow2,{eg.direction},D={b.width},bf16"] = (
                b.cols, qb)
    for name, eg in packings:
        calls16[f"gather_sum:{name},table,bf16"] = (eg.gather_table, qb)
    for d in (4, 33, 64, 200):
        calls16[f"gather_sum:d={d},bf16"] = (
            widest.cols, normal(rng, case.n, d, device=dev).bfloat16())
    calls16["csr_sum:powerlaw src rows,bf16"] = (
        hub["csr"][0], case.be.bfloat16())
    errs.update(check_kernels(kern, calls16, "power law / S3 bf16"))
    # The ELL copy-SpMM on bf16 features takes the bf16 S3 itself: one
    # bf16 launch, no f32 one (no copy of the features to f32).
    kern.reset()
    y = ell_ops.ell_copy_spmm(case.de, case.se, qb)
    torch.cuda.synchronize()
    n16, n32 = (kern.launches(bf16=True)["gather_sum"],
                kern.launches()["gather_sum"])
    log(f"[s3] ell_copy_spmm on bf16 features: output {y.dtype}, S3 "
        f"launches bf16 {n16} f32 {n32}")
    assert y.dtype == torch.bfloat16 and (n16, n32) == (1, 0), (y.dtype, n16,
                                                                 n32)
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
    for hh, dd in ((2, 64), (1, 33), (1, 40), (1, 200)):
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
    launches = kern.launches(bf16=True)
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
    """K4 at heads wider than 128 (the cluster form): against its plain
    version at 1e-4, bit for bit on repeat, on the irregular graph at
    every width of K4_WIDE_CHECKED, and in bf16 within one rounding; the
    attention op through ``impl="tiled"`` counted; times at K4_WIDE. Then
    the same widths, one head, on the slice's tiles (n = 15,360), checked
    and timed beside SDPA: the irregular graph is small enough for a dense
    mask to win, the slice shows the kernel where the graph is real."""
    from custom_op_benchmark_tpu_torch import ops
    from custom_op_benchmark_tpu_torch.ops.kernels.attention import (
        kernel_route,
    )

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
    for d in K4_WIDE_CHECKED:
        form, blocks, clusters, width = kernel_route(d)
        log(f"[wide] d={d}: kernel_route {form!r}, {blocks} blocks of "
            f"{width} features a cluster, {clusters} cluster(s) a row block "
            f"and head")
        assert form == "wide", form
        qs, ks, vs = (normal(rng, small.n_nodes, d, device=dev)
                      for _ in range(3))
        key = f"fused_attention_rows:d={d}"
        call = {key: (small.tile_ptr, small.tile_cols, small.mask, qs, ks,
                      vs, d ** -0.5)}
        errs.update(check_kernels(kern, call, "irregular n=300 wide K4"))
        if d in K4_WIDE_BF16:
            b16 = [t.bfloat16() for t in (qs, ks, vs)]
            check_kernels(kern, {f"{key} bf16": (
                small.tile_ptr, small.tile_cols, small.mask, *b16,
                d ** -0.5)}, "irregular n=300 wide K4 bf16")
        kern.reset()
        y = ops.attention(g, qs, ks, vs, impl="tiled")
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and y.shape == qs.shape
        launches[key] = kern.launches()["fused_attention_rows"]
        log(f"[wide] attention(impl='tiled') at d={d}: K4 launches "
            f"{launches[key]}")
        assert launches[key] == 1, launches
        if d in K4_WIDE:
            times[key] = time_row(kern, key, call[key], f"n=300 d={d}", {},
                                  lib=True)
            ms, lib = times[key]["ms"], times[key]["library_ms"]
            log(f"[wide] d={d} n=300: K4 {ms:.4f} ms against SDPA "
                f"{lib} ms: {'below' if lib and ms < lib else 'NOT below'}")
    return errs, launches, times


def phase_block(kern, dev, g):
    """The dense-block path at full width: ``impl="auto"`` resolves to the
    dense blocks; the clique GAT (3 layers, 8 heads of 64) on the block
    layout against the segment path on the card; three steps of
    ``fit_full_graph(strategy="auto")``; ``vector_spmm`` at d = 1024 on the
    headline bench's inputs through auto, tiled (K2) and xla."""
    from custom_op_benchmark_tpu_torch import bench, ops
    from custom_op_benchmark_tpu_torch.data.synthetic import (
        NodeClassificationDataset,
    )
    from custom_op_benchmark_tpu_torch.models import GAT
    from custom_op_benchmark_tpu_torch.ops import dispatch
    from custom_op_benchmark_tpu_torch.train import (
        fit_full_graph,
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
    del model

    # The headline bench's workload through every impl (its timing and the
    # clique GAT step's are the bench phase's).
    _, ed, xw = bench.spmm_workload(*CLIQUES, WIDE, dev)
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


def phase_bench(kern, dev, rate_ratio):
    """The headline bench (``custom_op_benchmark_tpu_torch.bench.run``) at
    full size: its JSON line, ``auto_impl == "dense_block"`` and
    ``kernel_parity_ok``, the launches of its one run; the power-law ELL
    attention's fractions of the L2 gather ceiling also over the earlier
    ceiling (S3's own rate; ``rate_ratio`` = probe / S3)."""
    from custom_op_benchmark_tpu_torch import bench

    kern.reset()
    rec = bench.run(dev)
    torch.cuda.synchronize()
    launches = kern.launches()
    log(f"[bench] {json.dumps(rec)}")
    log(f"[bench] kernel launches {launches}")
    for model in ("unique", "refetch"):
        frac = rec[f"powerlaw_attention_roofline_frac_{model}"]
        log(f"[bench] power-law ELL attention, {model} bytes: "
            f"{frac:.4f} of the probe's L2 gather ceiling, "
            f"{frac * rate_ratio:.4f} of S3's own (the earlier ceiling)")
    assert rec["auto_impl"] == "dense_block", rec["auto_impl"]
    assert rec["kernel_parity_ok"] is True, rec["kernel_parity_ok"]
    assert launches["sddmm_tiles"] > 0, launches
    assert all(np.isfinite(rec[k]) for k in (
        "value", "time_s", "clique_gat_step_ms",
        "powerlaw_fused_attention_ms", "powerlaw_gather_ceiling_gb_s"))
    return rec


def phase_clique_suite(kern, dev):
    """The clique suite (``bench_suite.run_suite``, the default suite) at
    full size: every row timed, every gate passed; the launches of K1-K4
    in the run (the suite kernel rows' counts)."""
    from custom_op_benchmark_tpu_torch.utils import bench_suite

    kern.reset()
    records, ok = bench_suite.run_suite(device=dev)
    torch.cuda.synchronize()
    launches = kern.launches()
    failed = [r["check"] for r in records if r.get("ok") is False]
    log(f"[suite] clique suite: suite_ok {ok}, "
        f"{sum('check' in r for r in records)} checks (worst "
        f"{max(r['max_diff'] for r in records if 'check' in r):.3e}), "
        f"{sum('bench' in r for r in records)} rows; kernel launches "
        f"{launches}")
    assert ok and not failed, failed
    assert all(launches[k] > 0 for k in SLICE_KERNELS), launches
    return launches


def suite_kernel_calls(tg, rng, dev):
    """K1-K4 at the clique suite's new shapes on its unaligned tiling:
    K1 (maskedmm/pallas_tiled) and K2/K3 (maskedmm_bwd/pallas_tiled: dA and
    dB of the masked product) at one head, d = 1024; K4
    (attention_fused/pallas) at one head, d = 128, normalize="src"."""
    n = tg.n_nodes
    a, b = (normal(rng, n, SUITE_D, device=dev) for _ in range(2))
    ds = torch.where(tg.mask, normal(rng, tg.num_tiles, 128, 128,
                                     device=dev), 0.0)
    wide = kernel_calls(tg, a, b, b, ds)
    q, k, v = (normal(rng, n, SUITE_ATTN_D, device=dev) for _ in range(3))
    calls = {f"{name}:suite d={SUITE_D}": wide[name] for name in TILE_KERNELS}
    calls[f"fused_attention_rows:suite d={SUITE_ATTN_D}"] = kernel_calls(
        tg, q, k, v, ds)["fused_attention_rows"]
    return calls


def phase_suite_kernels(kern, dev, tg):
    """K1-K4 at the clique suite's shapes on its tiling (the slice's
    ``tg``) against their plain versions (the gates of check_kernels),
    timed beside their bounds and library calls."""
    log(f"[suite] unaligned clique tiling: T={tg.num_tiles} live 16x8 "
        f"fragments {live_share(tg.mask):.4f}")
    calls = suite_kernel_calls(tg, np.random.default_rng(SEED + 12), dev)
    errs = check_kernels(kern, calls, "clique suite")
    times = {}
    for key, args in calls.items():
        times[key] = time_row(kern, key, args, "clique suite", {}, lib=True)
        torch.cuda.empty_cache()
    return errs, times


def phase_bench_models(kern, dev):
    """``experiments/bench_models.py`` at full size: every row's forward
    and train step timed, the GAT's block and ELL paths within 2e-3 of its
    segment path."""
    from custom_op_benchmark_tpu_torch.experiments import bench_models

    kern.reset()
    rec = bench_models.run(dev)
    torch.cuda.synchronize()
    log(f"[bench_models] {json.dumps(rec)}")
    log(f"[bench_models] kernel launches {kern.launches()}")
    assert rec["ok"], rec
    assert all(np.isfinite(r["fwd_ms"]) and np.isfinite(r["step_ms"])
               for r in rec["rows"].values()), rec["rows"]
    assert kern.launches()["fused_attention_rows"] > 0
    return rec


def phase_cli(kern, dev):
    """The command line (``train/run.py``) on each ported configuration at
    full width (``--scale 1``), ``--epochs 2`` (depth cut for time): its
    JSON line, ``layer_allclose_ok`` for cora_gat, a finite validation
    loss, the launches of each run."""
    import contextlib
    import io

    from custom_op_benchmark_tpu_torch.train import run

    results = {}
    for config in CLI_CONFIGS:
        out = io.StringIO()
        kern.reset()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--config", config, "--scale", "1", "--epochs",
                           str(CLI_EPOCHS)])
        torch.cuda.synchronize()
        line = out.getvalue().strip().splitlines()[-1]
        log(f"[cli] {line}")
        log(f"[cli] {config} kernel launches {kern.launches()}")
        rec = json.loads(line)
        assert rc == 0 and rec["config"] == config, (rc, rec)
        assert np.isfinite(rec["val_loss"]), rec
        if config == "cora_gat":
            assert rec["layer_allclose_ok"] is True, rec
        results[config] = rec
    return results


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


def arxiv_model(name, num_classes, in_dim, **kw):
    from custom_op_benchmark_tpu_torch import models

    return getattr(models, name)(
        out_dim=num_classes, in_dim=in_dim, **ARXIV_MODELS[name], **kw,
        generator=torch.Generator().manual_seed(SEED))


def arxiv_data(dev):
    """The arxiv configuration on the card: the dataset, its graph and
    training-ladder ELL packing, features, labels and train mask."""
    from custom_op_benchmark_tpu_torch.data import planted_partition
    from custom_op_benchmark_tpu_torch.ops import ell_dual

    t0 = time.perf_counter()
    ds = planted_partition(**ARXIV)
    g = ds.graph.to(dev)
    ell = ell_dual(g, profile="train")
    torch.cuda.synchronize()
    se, de = ell
    log(f"[arxiv] n={g.n_nodes} e={g.n_edges} classes={ds.num_classes}; "
        f"train-ladder waste src {se.padding_waste:.3f} dst "
        f"{de.padding_waste:.3f}; host build {time.perf_counter() - t0:.2f} s")
    return dict(ds=ds, g=g, ell=ell, x=torch.from_numpy(ds.features).to(dev),
                labels=torch.from_numpy(ds.labels).to(dev),
                mask=torch.from_numpy(ds.train_mask).to(dev))


def phase_arxiv(kern, data):
    """The arxiv configuration on the ELL path: parity against the segment
    path, S3 counted in the forward and the backward, three AdamW steps
    through fit_full_graph, step times and peak memory; then one epoch of
    GIN through fit_full_graph with its S3 launches."""
    from custom_op_benchmark_tpu_torch.models import GIN
    from custom_op_benchmark_tpu_torch.ops import ell as ell_ops
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import (
        gather_sum,
    )
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        fit_full_graph,
        make_train_step,
        masked_cross_entropy,
    )

    ds, g, ell, x, labels, mask = (data[k] for k in (
        "ds", "g", "ell", "x", "labels", "mask"))
    se, de = ell
    dev = g.device
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

    # GIN (width 128) through fit_full_graph on the ELL path: S3 does every
    # neighbour sum, forward and backward.
    gin = GIN(**GIN_MODEL, out_dim=ds.num_classes, in_dim=x.shape[1],
              generator=torch.Generator().manual_seed(SEED))
    kern.reset()
    _, metrics = fit_full_graph(gin, ds, epochs=1, log_every=1,
                                learning_rate=2e-3, strategy="ell")
    torch.cuda.synchronize()
    results["gin_s3_launches"] = gather_sum.launches
    log(f"[arxiv] GIN fit_full_graph(strategy='ell'), 1 epoch: loss "
        f"{metrics['history'][0]['loss']:.6f} val_acc "
        f"{metrics['val_acc']:.4f}; kernel launches {kern.launches()}")
    assert np.isfinite(metrics["history"][0]["loss"]), metrics
    assert results["gin_s3_launches"] > 0, results["gin_s3_launches"]
    return results


def s3_l2_rate(dev, table_rows=16384, d=128, rows=125_000, slots=16):
    """The earlier definition of the L2 gather rate, printed beside the
    probe's: S3 itself on an L2-resident table (``table_rows`` rows of
    ``d`` floats, ``rows`` rows of ``slots`` random slots), bytes/s."""
    from custom_op_benchmark_tpu_torch.graph.ell import one_bucket_table

    rng = np.random.default_rng(11)
    x = normal(rng, table_rows, d, device=dev)
    cols = torch.from_numpy(rng.integers(
        0, table_rows, size=(rows, slots)).astype(np.int32)).to(dev)
    table = one_bucket_table(cols)
    fn = Kernels().table["gather_sum"][0]
    return cols.numel() * d * 4 / (time_ms(lambda: fn(table, x)) / 1e3)


def table_bag_yardstick(table, x):
    """``F.embedding_bag`` with offsets over a GatherTable's rows (a zero
    row appended for pad slots): the same sums in table row order, without
    the step to the node rows."""
    xz = torch.cat([x, x.new_zeros(1, x.shape[1])])
    cols = torch.where((table.cols >= 0) & (table.cols < x.shape[0]),
                       table.cols, x.shape[0])
    offsets = torch.cat([torch.arange(
        off, off + rows * w + (w == 0), max(w, 1), device=x.device)[:rows]
        for off, w, _, rows in table.layout]
        + [torch.tensor([cols.numel()], device=x.device)])

    def fn():
        return torch.nn.functional.embedding_bag(
            cols, xz, offsets, mode="sum", include_last_offset=True)

    def check(want):
        return float((fn() - want[table.nodes.long()]).abs().max())

    return "F.embedding_bag(offsets over the table's rows, mode='sum')", \
        fn, check


def l2_bound(row, name, args, l2_rate):
    """The gathered rows' bytes (valid slots times a row) at the probe's
    L2 gather rate, in ms, into ``row``."""
    x = args[1]
    if name == "csr_sum":
        ptr = args[0]
        idx = args[2] if len(args) > 2 else None
        lo, hi = int(ptr[0]), int(ptr[-1])
        rows = (idx[lo:hi] if idx is not None
                else torch.arange(lo, hi, device=x.device))
    else:
        rows = args[0] if torch.is_tensor(args[0]) else args[0].cols
    valid = int(((rows >= 0) & (rows < x.shape[0])).sum())
    gathered = valid * x[0].numel() * x.element_size()
    row["bound_l2_ms"] = gathered / l2_rate * 1e3
    log(f"[time] {name} gathers {gathered / 1e9:.3f} GB: at the L2 gather "
        f"rate {l2_rate / 1e12:.3f} TB/s (the probe) that takes "
        f"{row['bound_l2_ms']:.4f} ms (share "
        f"{row['bound_l2_ms'] / row['ms']:.3f})")
    return row


def phase_s3_hub_times(kern, case, l2_rate):
    """S3's two hub shapes on the power-law graph timed beside their plain
    versions, bytes bound, the probe's L2 bound and library call: the src
    table (``embedding_bag`` with offsets) and the src CSR rows
    (``torch.segment_reduce``)."""
    hub = powerlaw_hubs(case)
    rows = {}
    for key, args, lib in (
            ("gather_sum:powerlaw src table", hub["ell"],
             table_bag_yardstick(*hub["ell"])),
            ("csr_sum:powerlaw src rows", hub["csr"],
             csr_yardstick(*hub["csr"]))):
        rows[key] = l2_bound(
            time_row(kern, key, args, "power law", GRID_TIMING, lib=lib),
            key.partition(":")[0], args, l2_rate)
        torch.cuda.empty_cache()
    return rows


def phase_s3_times(kern, s3_inputs, l2_rate):
    """S3 at the experiment's shape (a one-bucket table) against its plain
    version and embedding_bag, in f32 and in bf16, with a second bound:
    the gathered bytes at the card's L2 gather rate."""
    table, x = s3_inputs
    rows = {}
    for key, xx in (("gather_sum", x), ("gather_sum:bf16", x.bfloat16())):
        row = time_row(kern, key, (table, xx), "125000x16 d=128", {},
                       lib=True)
        rows[key] = l2_bound(row, "gather_sum", (table, xx), l2_rate)
        torch.cuda.empty_cache()
    return rows


def dtype_case(kern, label, make, g, xs, labels, mask, views):
    """One model in f32 and in bf16 from the same weights (``make(None)``,
    ``make(torch.bfloat16)``), each on its features (``xs`` by dtype): the
    bf16 forward's f32 logits against the f32 forward (DTYPE_MODEL_TOL),
    one counted bf16 AdamW step, then both steps timed in turns (f32,
    bf16, bf16, f32) with their peak memory. Returns the bf16 step's
    kernel launches (f32, bf16) and the times."""
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    models = {dt: make(dt).to(g.device) for dt in (None, torch.bfloat16)}
    models[torch.bfloat16].load_state_dict(models[None].state_dict())
    with torch.no_grad():
        want = models[None](g, xs[None], **views)
        got = models[torch.bfloat16](g, xs[torch.bfloat16], **views)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all(), label
    ok = torch.allclose(got, want, **DTYPE_MODEL_TOL)
    log(f"[dtype] {label}: bf16 forward (f32 logits) vs f32 from the same "
        f"weights: max abs diff {float((got - want).abs().max()):.3e} "
        f"(max|f32| {float(want.abs().max()):.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, f"{label}: bf16 disagrees with f32"
    del got, want
    steps = {}
    for dt, model in models.items():
        state = create_train_state(model)
        step = make_train_step(apply_kwargs=views)
        steps[dt] = (lambda st=state, sp=step, x=xs[dt]: sp(st, g, x,
                                                            labels, mask))
    kern.reset()
    loss, _ = steps[torch.bfloat16]()
    torch.cuda.synchronize()
    launches = (kern.launches(), kern.launches(bf16=True))
    assert np.isfinite(float(loss)), label
    log(f"[dtype] {label}: one bf16 AdamW step, loss {float(loss):.6f}; "
        f"launches f32 {launches[0]} bf16 {launches[1]}")
    times = {None: [], torch.bfloat16: []}
    peaks = {}
    for dt in (None, torch.bfloat16, torch.bfloat16, None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times[dt].append(time_ms(steps[dt], warmup=1, iters=3, repeats=3))
        peaks[dt] = sync_peak_gib()
    out = {}
    for dt, name in ((None, "f32"), (torch.bfloat16, "bf16")):
        out[name] = (sum(times[dt]) / 2, peaks[dt])
        log(f"[time] {label} train step {name}: "
            f"{times[dt][0]:.3f}/{times[dt][1]:.3f} ms, peak memory "
            f"{peaks[dt]:.2f} GiB")
    return launches, out


def phase_dtype(kern, dev, g, tg, arxiv):
    """The dtype policy at full width: the transformer slice in bf16 on its
    tiles (K1-K4 in bf16), the arxiv GAT in bf16 on the ELL path, and
    GraphSAGE on bf16 features of the arxiv configuration (S3 in bf16 on
    its first layer's neighbour mean): each against f32 from the same
    weights, one counted AdamW step, step times and peak memory."""
    from custom_op_benchmark_tpu_torch.models import GraphTransformer

    rng = np.random.default_rng(SEED + 14)
    gd = g.to(dev)
    x = torch.from_numpy(rng.standard_normal(
        (g.n_nodes, MODEL["dim"]), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, MODEL["out_dim"],
                                           size=g.n_nodes)).to(dev)
    mask = torch.ones(g.n_nodes, dtype=torch.bool, device=dev)
    slice_launches, slice_times = dtype_case(
        kern, "transformer slice (tiled)",
        lambda dt: GraphTransformer(
            **MODEL, dtype=dt, generator=torch.Generator().manual_seed(SEED)),
        gd, {None: x, torch.bfloat16: x}, labels, mask, {"tiled": tg})
    n32, n16 = slice_launches
    assert all(n16[k] > 0 for k in SLICE_KERNELS), n16
    assert all(n32[k] == 0 for k in SLICE_KERNELS), n32
    del x, labels, mask
    torch.cuda.empty_cache()

    ds = arxiv["ds"]
    views = {"ell": arxiv["ell"]}
    gat_launches, gat_times = dtype_case(
        kern, "arxiv GAT (ELL)",
        lambda dt: arxiv_model("GAT", ds.num_classes, ds.features.shape[1],
                               dtype=dt),
        arxiv["g"], {None: arxiv["x"], torch.bfloat16: arxiv["x"]},
        arxiv["labels"], arxiv["mask"], views)
    torch.cuda.empty_cache()
    # GraphSAGE takes no dtype: it follows its features (f32 weights), so
    # its "bf16" model is the f32 one on bf16 features.
    sage_launches, sage_times = dtype_case(
        kern, "arxiv GraphSAGE (ELL), bf16 features",
        lambda dt: arxiv_model("GraphSAGE", ds.num_classes,
                               ds.features.shape[1]),
        arxiv["g"], {None: arxiv["x"], torch.bfloat16: arxiv["x"].bfloat16()},
        arxiv["labels"], arxiv["mask"], views)
    assert sage_launches[1]["gather_sum"] > 0, sage_launches
    return dict(slice_bf16_launches=n16, slice=slice_times, gat=gat_times,
                gat_launches=gat_launches, sage=sage_times,
                s3_bf16_launches=sage_launches[1]["gather_sum"])


def phase_entry(kern, dev):
    """``entry()`` at its own size on the card: logits (bf16 GAT, f32) and
    the packed edge-bias attention (f32) against the same ``fn`` on a CPU
    copy, the forward timed, then one backward of the logits' sum through
    the remat'd bf16 GAT with finite gradients."""
    from custom_op_benchmark_tpu_torch.entry import entry

    t0 = time.perf_counter()
    fn, args = entry()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kern.reset()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, attn = fn(*args)
    peak = sync_peak_gib()
    assert logits.dtype == attn.dtype == torch.float32
    assert torch.isfinite(logits).all() and torch.isfinite(attn).all()
    with torch.no_grad():
        ms = time_ms(lambda: fn(*args), warmup=1, iters=3, repeats=3)
    t0 = time.perf_counter()
    fn_c, args_c = entry(device="cpu")
    with torch.no_grad():
        want_l, want_a = fn_c(*args_c)
    cpu_s = time.perf_counter() - t0
    lc, ac = logits.cpu(), attn.cpu()
    tol = 2.0 ** -6 * want_l.abs() + 2e-2 * want_l.abs().max()
    ok_l = bool(((lc - want_l).abs() <= tol).all())
    ok_a = torch.allclose(ac, want_a, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    log(f"[entry] graph n={args[1].shape[0]}, logits {tuple(lc.shape)} "
        f"{lc.dtype}, attn {tuple(ac.shape)}; host build {build_s:.2f} s, "
        f"CPU copy {cpu_s:.1f} s; forward {ms:.3f} ms, peak memory "
        f"{peak:.2f} GiB; kernel launches {kern.launches()}")
    log(f"[entry] card vs CPU: logits max abs diff "
        f"{float((lc - want_l).abs().max()):.3e} (bf16 tolerance) "
        f"{'ok' if ok_l else 'FAIL'}; attn max abs diff "
        f"{float((ac - want_a).abs().max()):.3e} {'ok' if ok_a else 'FAIL'}")
    assert ok_l and ok_a, (ok_l, ok_a)
    del fn_c, args_c, want_l, want_a, logits, attn
    logits, _ = fn(*args)
    logits.sum().backward()
    torch.cuda.synchronize()
    bad = [k for k, p in args[0].items()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    log(f"[entry] backward of the logits' sum through the remat'd bf16 "
        f"GAT: {len(args[0])} parameter gradients, non-finite or missing: "
        f"{bad}")
    assert not bad, bad
    return dict(forward_ms=ms, peak_gib=peak)


def phase_native(arxiv):
    """The port's graphcore library: it built and ran (the counts of its
    calls so far), and its dual-CSR and ELL host builds of the power-law
    graph (2M edges) and the arxiv graph give the numpy path's arrays,
    each path timed on the host."""
    from custom_op_benchmark_tpu_torch.graph import ell_pack, from_coo
    from custom_op_benchmark_tpu_torch.graph import native

    so = native.build()
    assert native.available(), "the graphcore library did not load"
    calls = {fn.__name__: fn.calls for fn in native.ENTRY_POINTS}
    log(f"[native] {so}; native calls so far in this run: {calls}")
    assert calls["build_dual_csr"] > 0 and calls["ell_pack_native"] > 0, calls
    rng = np.random.default_rng(SEED + 15)
    n, e, _ = POWERLAW
    w = 1.0 / np.arange(1, n + 1) ** 0.75
    loops = np.arange(n)
    graphs = {"power law": (
        np.concatenate([rng.choice(n, size=e, p=w / w.sum()), loops]),
        np.concatenate([rng.integers(0, n, size=e), loops]), n)}
    ga = arxiv["ds"].graph
    perm = rng.permutation(ga.n_edges)      # the edges in no sorted order
    graphs["arxiv"] = (ga.src.numpy()[: ga.n_edges][perm],
                       ga.dst.numpy()[: ga.n_edges][perm], ga.n_nodes)
    real = native._load
    out = {}
    for name, (src, dst, nn) in graphs.items():
        built, secs = {}, {}
        for path in ("native", "numpy", "numpy", "native"):
            if path == "numpy":
                native._load = lambda: None
            try:
                t0 = time.perf_counter()
                g = from_coo(src, dst, nn)
                t1 = time.perf_counter()
                packs = [ell_pack(g, direction=d) for d in ("src", "dst")]
                t2 = time.perf_counter()
            finally:
                native._load = real
            built[path] = (g, packs)
            secs.setdefault(path, []).append((t1 - t0, t2 - t1))
        (gn, pn), (gp, pp) = built["native"], built["numpy"]
        for f in ("src", "dst", "indptr_r", "csc_perm", "csc_perm_inv",
                  "indptr_c"):
            assert torch.equal(getattr(gn, f), getattr(gp, f)), (name, f)
        for a, b in zip(pn, pp):
            assert len(a.buckets) == len(b.buckets), name
            assert torch.equal(a.row_pos, b.row_pos) and torch.equal(
                a.edge_pos, b.edge_pos), name
            for ba, bb in zip(a.buckets, b.buckets):
                assert all(torch.equal(getattr(ba, f), getattr(bb, f))
                           for f in ("rows", "cols", "eid")), name
        best = {p: [min(t[i] for t in secs[p]) for i in (0, 1)]
               for p in secs}
        log(f"[native] {name} (n={nn}, e={len(src)}): dual CSR native "
            f"{best['native'][0]:.3f} s vs numpy {best['numpy'][0]:.3f} s; "
            f"ELL packing (src and dst, pow-2 ladder) native "
            f"{best['native'][1]:.3f} s vs numpy {best['numpy'][1]:.3f} s; "
            f"identical arrays (the faster of two runs each)")
        out[name] = best
    return out


# ---------------------------------------------------------------------------
# Determinism, S3's CSR entry, the sampled path, resilient steps
# ---------------------------------------------------------------------------

def csr_calls(ptr_r, ptr_c, src_csc, csc_perm, x, edges):
    """The CSR entry's arguments as the segment path gives them: the copy
    form (a node's in-neighbours' rows), the src-side sum of edge data in
    canonical order (idx the identity) and the dst-side one through the
    CSC permutation (d = 8: the edge data's width, and 4); also one
    feature wide, the copy at d = 64, and bf16."""
    return {
        "csr_sum:copy": (ptr_c, x, src_csc),
        "csr_sum:edges src": (ptr_r, edges),
        "csr_sum:edges dst": (ptr_c, edges[:, :4].contiguous(), csc_perm),
        "csr_sum:d=1": (ptr_c, edges[:, :1].contiguous(), csc_perm),
        "csr_sum:edges dst d=8": (ptr_c, edges, csc_perm),
        "csr_sum:copy d=64": (ptr_c, x[:, :64].contiguous(), src_csc),
        "csr_sum:copy,bf16": (ptr_c, x.bfloat16(), src_csc),
    }


def csr_yardstick(ptr, x, idx=None):
    """One PyTorch call for the CSR sum: ``F.embedding_bag`` with offsets
    (a zero row appended for slots outside x), or ``torch.segment_reduce``
    where the slots are the rows themselves."""
    if idx is None:
        def fn():
            return torch.segment_reduce(x, "sum", offsets=ptr.long())
        what = "torch.segment_reduce(offsets)"
    else:
        xz = torch.cat([x, x.new_zeros(1, x.shape[1])])
        ii = idx.clamp(max=x.shape[0])

        def fn():
            return torch.nn.functional.embedding_bag(
                ii, xz, ptr, mode="sum", include_last_offset=True)
        what = "F.embedding_bag(offsets, mode='sum')"

    def check(want):
        return float((fn() - want).abs().max())

    return what, fn, check


def phase_csr(kern, data, l2_rate):
    """S3's CSR entry at the arxiv configuration's segment shapes against
    its plain version (1e-4; bf16 one rounding), bit for bit on repeat,
    timed at the copy shape and at the narrow widths (d = 1, 4, 8 and the
    copy at 64) beside its bound (bytes, and the gathered rows at the
    probe's L2 gather rate) and ``embedding_bag`` with offsets; the
    launches of one segment-path step of the arxiv GCN and of the GAT."""
    from custom_op_benchmark_tpu_torch.models import GCN
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import csr_sum
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    g, x = data["g"], data["x"]
    n = g.n_nodes
    rng = np.random.default_rng(SEED + 20)
    edges = normal(rng, g.num_edges_padded, 8, device=g.device)
    calls = csr_calls(g.indptr_r[: n + 1], g.indptr_c[: n + 1], g.src_csc,
                      g.csc_perm, x, edges)
    errs = check_kernels(kern, calls, "arxiv segment")
    row = l2_bound(time_row(kern, "csr_sum", calls["csr_sum:copy"],
                            "arxiv copy", {},
                            lib=csr_yardstick(*calls["csr_sum:copy"])),
                   "csr_sum", calls["csr_sum:copy"], l2_rate)
    # The narrow sums (the edge softmax's at d = heads, a degree at d = 1)
    # and the copy at d = 64, where a warp takes 32, 8, 4 or 2 rows.
    narrow = {}
    for key in ("csr_sum:d=1", "csr_sum:edges dst", "csr_sum:edges dst d=8",
                "csr_sum:copy d=64"):
        narrow[key] = l2_bound(time_row(
            kern, key, calls[key], "arxiv", {},
            lib=csr_yardstick(*calls[key])), "csr_sum", calls[key], l2_rate)
    model = GCN(**ARXIV_MODELS["GCN"], out_dim=data["ds"].num_classes,
                in_dim=x.shape[1],
                generator=torch.Generator().manual_seed(SEED)).to(g.device)
    state = create_train_state(model, learning_rate=2e-3)
    step = make_train_step()
    step(state, g, x, data["labels"], data["mask"])
    kern.reset()
    step(state, g, x, data["labels"], data["mask"])
    torch.cuda.synchronize()
    launches = csr_sum.launches
    log(f"[csr] one arxiv GCN step on the segment path: CSR entry launches "
        f"{launches} (one per copy-sum, forward and backward)")
    assert launches > 0, launches
    del state, step, model
    # The arxiv GAT (4 heads) on the segment path: its edge softmax sums at
    # d = 4 (and 1) go through the CSR entry.
    model = arxiv_model("GAT", data["ds"].num_classes,
                        x.shape[1]).to(g.device)
    state = create_train_state(model, learning_rate=2e-3)
    step = make_train_step()
    kern.reset()
    step(state, g, x, data["labels"], data["mask"])
    torch.cuda.synchronize()
    gat_launches = csr_sum.launches
    log(f"[csr] one arxiv GAT step on the segment path: CSR entry launches "
        f"{gat_launches}")
    assert gat_launches > 0, gat_launches
    del state, step, model
    return errs, row, narrow, gat_launches


def reddit_data(dev):
    """reddit_sage's dataset at ``--scale 1`` (the command line's own
    builder), features and labels on the card."""
    from custom_op_benchmark_tpu_torch.train import run

    t0 = time.perf_counter()
    ds = run.reddit_dataset(REDDIT_SCALE)
    log(f"[reddit] n={ds.graph.n_nodes} e={ds.graph.n_edges} "
        f"features {ds.features.shape} classes {ds.num_classes}; host "
        f"build {time.perf_counter() - t0:.2f} s")
    return dict(ds=ds, feats=torch.from_numpy(ds.features).to(dev),
                labels=torch.from_numpy(ds.labels.astype(np.int64)).to(dev))


def reddit_batch(reddit, dev, sampler=None):
    """One batch of reddit_sage's sampler on the card: (graph, x, labels,
    seed mask, in_cols), and the batch."""
    from custom_op_benchmark_tpu_torch.data import NeighborSampler
    from custom_op_benchmark_tpu_torch.train import run

    ds = reddit["ds"]
    sampler = sampler or NeighborSampler(ds.graph, run.REDDIT_FANOUTS,
                                         seed=SEED)
    seeds = np.nonzero(ds.train_mask)[0][: run.REDDIT_BATCH]
    b = sampler.sample(seeds)
    ids = torch.from_numpy(b.node_ids.astype(np.int64)).to(dev)
    return (b.graph.to(dev), reddit["feats"][ids],
            reddit["labels"][torch.from_numpy(b.seed_ids).long().to(dev)],
            torch.from_numpy(b.seed_mask).to(dev),
            torch.from_numpy(b.in_cols).to(dev)), b


def reddit_model(ds, dev):
    from custom_op_benchmark_tpu_torch.train import run

    model = run.reddit_sage_model(ds)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model.to(dev)


def phase_determinism(kern, dev, reddit):
    """Each case twice on the card, compared with ``torch.equal``: the
    cases of ``experiments/determinism.py`` (the segment pipeline forward
    and backward, ELL and block attention, ``fit_full_graph`` of a GAT with
    strategy None, ``"ell"`` and ``"block"``), and two full-width
    reddit_sage steps from the same state and batch."""
    from custom_op_benchmark_tpu_torch.experiments import determinism
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        make_sampled_step,
    )
    from custom_op_benchmark_tpu_torch.train.checkpoint import (
        load_payload,
        state_payload,
    )

    kern.reset()
    results = {}
    for name, fn in determinism.cases(dev).items():
        t0 = time.perf_counter()
        results[name] = determinism.repeats(fn)
        log(f"[determinism] {name}: {'same bits' if results[name] else 'DIFFERENT'}"
            f" on a repeat ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()

    args, _ = reddit_batch(reddit, dev)
    state = create_train_state(reddit_model(reddit["ds"], dev),
                               learning_rate=1e-3)
    start = state_payload(state, clone=True)
    step = make_sampled_step()
    runs = []
    for _ in range(2):
        load_payload(state, copy.deepcopy(start))
        loss = step(state, *args)
        runs.append([loss] + [p.detach().clone()
                              for p in state.model.parameters()])
    results["sampled_step"] = determinism.same_bits(*runs)
    log(f"[determinism] sampled_step (reddit_sage, full width): "
        f"{'same bits' if results['sampled_step'] else 'DIFFERENT'}; "
        f"kernel launches in the phase {kern.launches()}")
    bad = [k for k, ok in results.items() if not ok]
    assert not bad, f"not repeated bit for bit: {bad}"
    return results


def device_busy(prof):
    """(busy µs, window µs, device events) of a profiled window: the union
    of the device events' spans, and the span from the first to the
    last."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return busy, window, len(spans)


def phase_sampled(kern, dev, reddit, l2_rate):
    """reddit_sage on the card: S3 at the sampled shape (d = 300 and 128)
    and the CSR entry at the sampled backward's shape against their plain
    versions, S3 timed; 20 steps of ``fit_sampled``'s step and sampler
    through the prefetch pipeline under the profiler (the device's idle
    share), a prefetched epoch's batches against the same batches made in
    line; then the command line at ``--scale 1`` for its 2 epochs with the
    counters set to 0 before and read after: S3 and the CSR entry launched,
    the native sampler ran, finite loss."""
    import contextlib
    import io

    from custom_op_benchmark_tpu_torch.data import NeighborSampler, prefetch
    from custom_op_benchmark_tpu_torch.graph import native
    from custom_op_benchmark_tpu_torch.train import (
        create_train_state,
        make_sampled_step,
        run,
    )
    from custom_op_benchmark_tpu_torch.train.loop import sampled_batches

    ds = reddit["ds"]
    calls0 = native.sample_subgraph_native.calls
    (g, x, y, m, cols), b = reddit_batch(reddit, dev)
    assert native.sample_subgraph_native.calls == calls0 + 1, \
        "the native sampler did not run"
    n = g.n_nodes
    real = int((cols < n).sum())
    log(f"[sampled] batch: {n} nodes ({int(b.node_mask.sum())} real), "
        f"{g.num_edges_padded} edge slots ({g.n_edges} real), in_cols "
        f"{tuple(cols.shape)} with {real} real slots")
    h = normal(np.random.default_rng(SEED + 21), n, 128, device=dev)
    calls = {"gather_sum:sampled d=300": (cols, x),
             "gather_sum:sampled d=128": (cols, h),
             "csr_sum:sampled backward": (g.indptr_r[: n + 1], h, g.dst)}
    errs = check_kernels(kern, calls, "reddit batch")
    rows = {}
    for key in ("gather_sum:sampled d=300", "csr_sum:sampled backward"):
        args = calls[key]
        lib = (True if key.startswith("gather_sum")
               else csr_yardstick(*args))
        rows[key] = time_row(kern, key, args, "reddit batch", {}, lib=lib)
        gathered = real * args[1].shape[1] * 4
        rows[key]["bound_l2_ms"] = gathered / l2_rate * 1e3

    # The prefetched batches equal the batches made in line.
    train_ids = np.nonzero(ds.train_mask)[0][: 8 * run.REDDIT_BATCH]
    made = [NeighborSampler(ds.graph, run.REDDIT_FANOUTS, seed=SEED)
            for _ in range(2)]
    inline = list(sampled_batches(made[0], train_ids, run.REDDIT_BATCH))
    fetched = list(prefetch(sampled_batches(made[1], train_ids,
                                            run.REDDIT_BATCH), 2, device=dev))
    torch.cuda.synchronize()
    same = len(inline) == len(fetched) and all(
        torch.equal(torch.as_tensor(u), v.cpu())
        for bi, bf in zip(inline, fetched)
        for u, v in zip((bi[0].src, bi[0].dst, *bi[1:]),
                        (bf[0].src, bf[0].dst, *bf[1:])))
    log(f"[sampled] {len(fetched)} prefetched batches equal to the same "
        f"batches made in line: {same}")
    assert same

    # 20 steady steps of fit_sampled's step through the pipeline, profiled.
    state = create_train_state(reddit_model(ds, dev), learning_rate=1e-3)
    step = make_sampled_step()
    sampler = NeighborSampler(ds.graph, run.REDDIT_FANOUTS, seed=SEED)
    batches = prefetch(sampled_batches(sampler, np.nonzero(
        ds.train_mask)[0], run.REDDIT_BATCH), 2, device=dev)

    def one():
        gb, ids, seeds, mask, cb = next(batches)
        return step(state, gb, reddit["feats"][ids], reddit["labels"][seeds],
                    mask, cb)

    for _ in range(5):
        one()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            one()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, window, n_events = device_busy(prof)
    idle = None
    if n_events:
        idle = 1.0 - busy / window
        log(f"[sampled] profiled {PROFILE_STEPS} steps: {wall * 1e3:.1f} ms "
            f"of wall time, device busy {busy / 1e3:.1f} ms of a "
            f"{window / 1e3:.1f} ms window: idle share {idle:.3f}; "
            f"{n_events} device events")
    else:
        log("[sampled] the profiler saw no device events: idle share not "
            "measured")
    del batches, state

    # The command line at full width for its default 2 epochs.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kern.reset()
    calls0 = native.sample_subgraph_native.calls
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--config", "reddit_sage", "--scale",
                       str(REDDIT_SCALE)])
    peak = sync_peak_gib()
    line = out.getvalue().strip().splitlines()[-1]
    launches = kern.launches()
    sampled_calls = native.sample_subgraph_native.calls - calls0
    log(f"[cli] {line}")
    log(f"[sampled] reddit_sage --scale {REDDIT_SCALE}: peak memory "
        f"{peak:.2f} GiB; native sampler calls {sampled_calls}; kernel "
        f"launches {launches}")
    rec = json.loads(line)
    assert rc == 0 and rec["config"] == "reddit_sage", (rc, rec)
    assert np.isfinite(rec["final_loss"]) and rec["steps"] > 0, rec
    assert sampled_calls >= rec["steps"], (sampled_calls, rec["steps"])
    assert launches["gather_sum"] > 0 and launches["csr_sum"] > 0, launches
    return dict(errs=errs, rows=rows, cli=rec, peak_gib=peak, idle=idle,
                launches=launches)


def phase_resilient(kern, dev):
    """``resilient_steps`` on the card: cora_gat's GAT on the cora-like
    graph (segment path), N steps straight against k steps with a checkpoint, then
    a fresh state resumed from it for the rest (``torch.equal`` on every
    parameter), and a non-finite loss restored from the last checkpoint."""
    import shutil
    from pathlib import Path

    from custom_op_benchmark_tpu_torch.train import (
        CheckpointManager,
        create_train_state,
        make_train_step,
        resilient_steps,
        run,
    )

    ds = run.cora_dataset(1)
    g = ds.graph.to(dev)
    x, y, m = (torch.from_numpy(a).to(dev)
               for a in (ds.features, ds.labels, ds.train_mask))
    train_step = make_train_step()

    def new_state():
        model = run.cora_gat_model(ds)
        model.reset_parameters(torch.Generator().manual_seed(SEED))
        return create_train_state(model.to(dev), learning_rate=5e-3)

    def step(state, _i):
        loss, _ = train_step(state, g, x, y, m)
        return state, loss

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    n, k = RESILIENT_STEPS
    straight, losses = resilient_steps(step, new_state(), n)
    mgr = CheckpointManager(str(root / "run"), keep=2)
    resilient_steps(step, new_state(), k, manager=mgr)
    events = []
    resumed, rest = resilient_steps(step, new_state(), n, manager=mgr,
                                    on_event=lambda e, s: events.append(e))
    same = rest == losses[k:] and all(
        torch.equal(a, b) for a, b in zip(resumed.model.parameters(),
                                          straight.model.parameters()))
    flaky = {"once": True}

    def bad(state, i):
        state, loss = step(state, i)
        if i == n - 2 and flaky.pop("once", False):
            loss = torch.full_like(loss, float("nan"))
        return state, loss

    mgr2 = CheckpointManager(str(root / "diverge"), keep=2)
    ev2 = []
    replayed, again = resilient_steps(bad, new_state(), n, manager=mgr2,
                                      checkpoint_every=2,
                                      on_event=lambda e, s: ev2.append(e))
    same2 = again == losses and all(
        torch.equal(a, b) for a, b in zip(replayed.model.parameters(),
                                          straight.model.parameters()))
    shutil.rmtree(root, ignore_errors=True)
    log(f"[resilient] cora_gat GAT, {n} steps straight vs {k} + checkpoint "
        f"+ resume ({events}): same bits {same}; a non-finite loss at step "
        f"{n - 2} restored ({ev2.count('restore')} restore): same bits "
        f"{same2}; losses {losses[0]:.6f} .. {losses[-1]:.6f}")
    assert same and same2 and "resume" in events
    assert ev2.count("restore") == 1


# ---------------------------------------------------------------------------
# The distributed plans: P shards of a local mesh on the one card
# ---------------------------------------------------------------------------

def with_numpy_pack(fn):
    """Run ``fn`` with the native halo packer declined (the numpy builder
    runs, as where the library does not build)."""
    from custom_op_benchmark_tpu_torch.graph import native

    real = native.halo_pack_native
    native.halo_pack_native = lambda *a, **k: None
    try:
        return fn()
    finally:
        native.halo_pack_native = real


def same_ell_host(a, b) -> bool:
    """Every array and size of two HaloEllHost packings equal."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "route":
            continue
        if isinstance(x, list):
            if len(x) != len(y) or not all(
                    u.shape == v.shape and np.array_equal(u, v)
                    for u, v in zip(x, y)):
                return False
        elif isinstance(x, np.ndarray):
            if x.shape != y.shape or not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def phase_dist_build(dev):
    """The products-like graph at ``--scale 1`` and its halo plan over 8
    shards, as the command line builds it (``build_plan``: order and hub
    threshold "auto"), each host step timed; the native packing against
    the numpy one (identical arrays); which route and order ran. The plan
    goes to the on-disk cache the command line reads."""
    import shutil

    from custom_op_benchmark_tpu_torch.parallel import halo, make_mesh
    from custom_op_benchmark_tpu_torch.parallel.train_dist import (
        COMM_WEIGHT,
        build_plan,
    )
    from custom_op_benchmark_tpu_torch.train import run

    shutil.rmtree(PLAN_CACHE, ignore_errors=True)
    t0 = time.perf_counter()
    ds = run.products_dataset(PRODUCTS_SCALE)
    g = ds.graph
    log(f"[dist] products-like --scale {PRODUCTS_SCALE}: n={g.n_nodes} "
        f"e={g.n_edges} features {ds.features.shape}; host build "
        f"{time.perf_counter() - t0:.2f} s")
    mesh = make_mesh((DIST_SHARDS,), ("edge",), device=dev)
    t0 = time.perf_counter()
    lay = build_plan(ds, mesh, plan="halo", order="auto",
                     cache_dir=str(PLAN_CACHE))
    total = time.perf_counter() - t0
    info = lay.info
    for name in ("cluster", "balanced"):
        d = info["order_details"][name]
        log(f"[dist] order {name:8s}: order {d['order_s']:.2f} s, "
            f"plan_stats {d['plan_stats_s']:.2f} s; halo {d['halo']} n_hub "
            f"{d['n_hub']} pack_slots {d['pack_slots']} interior "
            f"{d['interior_frac']} halo_fraction {d['halo_fraction']:.3f} "
            f"cost {d['cost']:.0f} (comm weight {COMM_WEIGHT:.3f})")
    hg, he = lay.dg
    log(f"[dist] picked order {info['order_details']['picked']}; reorder "
        f"{info['reorder_s']:.2f} s, halo_graph {info['halo_graph_s']:.2f} s "
        f"({hg.route}, hub threshold {info['hub_threshold']}), halo_ell "
        f"{info['halo_ell_s']:.2f} s ({he.route}); build_plan {total:.2f} s "
        f"with its cache writes")
    log(f"[dist] plan: n_per {hg.n_per} halo M {hg.halo} hubs K {hg.n_hub} "
        f"E_p {hg.edges_per_part}; halo_fraction {hg.halo_fraction:.4f}; "
        f"exchange rows real {info['exchange_rows_real']} padded "
        f"{info['exchange_rows_padded']}; interior row share "
        f"{info['interior_row_share']:.4f}; buckets {he.widths}")
    # The reference's routes: a hub plan is numpy's, the packing native.
    assert hg.route == "numpy" and he.route == "native", (hg.route,
                                                          he.route)
    t0 = time.perf_counter()
    eh_np = with_numpy_pack(lambda: halo.halo_ell_host(hg.host))
    t_np = time.perf_counter() - t0
    same = same_ell_host(he.host, eh_np)
    log(f"[dist] halo_ell native {info['halo_ell_s']:.2f} s vs numpy "
        f"{t_np:.2f} s: identical arrays {same}")
    assert same and eh_np.route == "numpy"
    return dict(ds=ds, mesh=mesh, layout=lay)


def dist_case(label, fn, ref, ins, ref_ins, n, maps=None, tol=DIST_TOL):
    """``fn`` on the mesh twice (output and the gradients of Σ y², equal
    bits) against ``ref`` on one device, rows ``[:n]`` of each, within
    ``tol``; ``maps[i]`` takes the mesh side's output (i = 0) or its i-th
    gradient to the reference's layout (edge data in slot order to
    canonical order). Returns the largest error."""
    def run_once(f, args):
        args = [a.detach().clone().requires_grad_() for a in args]
        y = f(*args)
        grads = torch.autograd.grad((y.float() ** 2).sum(), args)
        return [y.detach()] + list(grads)

    first, again = run_once(fn, ins), run_once(fn, ins)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    want = run_once(ref, ref_ins)
    worst = 0.0
    for i, (a, b) in enumerate(zip(first, want)):
        if maps and maps.get(i):
            a = maps[i](a)
        a, b = a[:n].float(), b[:n].float()
        err = float((a - b).abs().max())
        ok = bool(torch.allclose(a, b, rtol=tol, atol=tol))
        worst = max(worst, err)
        log(f"[dist parity] {label:34s} {'y' if i == 0 else f'grad {i}'}: "
            f"max_abs_err {err:.3e} max|ref| {float(b.abs().max()):.3e} "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, f"{label} disagrees with the single-device op"
    log(f"[dist parity] {label:34s} repeat: "
        f"{'same bits' if same else 'DIFFERENT'}")
    assert same, f"{label} does not repeat bit for bit"
    return worst


def phase_dist_parity(kern, dev, dist, l2_rate):
    """At products width on the card (8 shards, 4 heads of 16), each plan's
    op against the single-device ELL or segment op on the same renumbered
    graph, forward and every gradient at 1e-4, each run twice and
    compared with ``torch.equal``: ``halo_attention_ell`` (the "auto" hub
    plan, 1-D and through the 2-D edge × head mesh, its head axis a view
    on the local backend), ``halo_spmm_ell``,
    ``halo_spmm``, ``halo_gat_attention``, the gather plan's four ops and
    ``tp_attention``; bf16 per element; S3's CSR entry at the halo shape
    against its plain version, timed (also at d = 4, the edge softmax's
    sums), and its launches in the segment forms."""
    from custom_op_benchmark_tpu_torch import ops
    from custom_op_benchmark_tpu_torch.ops.kernels.gather_sum import csr_sum
    from custom_op_benchmark_tpu_torch.parallel import (
        halo,
        make_mesh,
        shard_ops,
        tp,
    )

    lay, mesh = dist["layout"], dist["mesh"]
    hg, he = lay.dg
    g = lay.graph.to(dev)
    n, e = g.n_nodes, g.n_edges
    h, d = DIST_HEADS, DIST_HEAD_DIM
    rng = np.random.default_rng(SEED + 30)
    host = [rng.standard_normal((n, h, d), dtype=np.float32)
            for _ in range(3)]
    one = [torch.from_numpy(a).to(dev) for a in host]
    qkv = [halo.shard_halo_nodes(hg, mesh, a) for a in host]
    t0 = time.perf_counter()
    se, de = ops.ell_dual(g)
    log(f"[dist parity] single-device ELL packing of the renumbered graph "
        f"(n={n}, e={e}): {time.perf_counter() - t0:.2f} s")
    errs = {}

    def seg_attention(q, k, v):
        s = ops.sddmm(g, k, q) / math.sqrt(d)
        a = ops.edge_softmax(g, s, by="dst")
        return ops.vector_spmm(g.reverse(), a[g.csc_perm.long()], v)

    errs["halo_attention_ell"] = dist_case(
        "halo_attention_ell (hubs)",
        lambda q, k, v: halo.halo_attention_ell(hg, he, mesh, q, k, v),
        lambda q, k, v: ops.ell_attention(de, se, q, k, v), qkv, one, n)
    mesh2 = make_mesh((DIST_SHARDS, 2), ("edge", "head"), device=dev)
    hg2 = halo.place_halo(hg.host, mesh2)
    he2 = halo.place_ell(he.host, mesh2)
    # On the local backend the head axis is a view: this runs the 1-D
    # mesh's computation through a 2-D mesh's plan and axis lookups. The
    # exchange of a rank's own heads runs only on a process mesh (the gloo
    # test).
    errs["halo_attention_ell 2-D"] = dist_case(
        "halo_attention_ell (2-D, head a view)",
        lambda q, k, v: halo.halo_attention_ell(hg2, he2, mesh2, q, k, v,
                                                head_axis="head"),
        lambda q, k, v: ops.ell_attention(de, se, q, k, v), qkv, one, n)

    # bf16 per element against f32 from the same rounded inputs.
    b16 = [t.bfloat16() for t in qkv]
    r32 = [t.float() for t in b16]
    y16 = halo.halo_attention_ell(hg, he, mesh, *b16).float()
    y32 = halo.halo_attention_ell(hg, he, mesh, *r32)
    bad = int(((y16 - y32).abs() > 6e-2 * y32.abs() + 5e-2).sum())
    log(f"[dist parity] halo_attention_ell bf16 vs f32: max_abs_err "
        f"{float((y16 - y32).abs().max()):.3e}, elements past 6e-2|f32| + "
        f"5e-2: {bad}")
    assert bad == 0
    del b16, r32, y16, y32

    x = torch.from_numpy(rng.standard_normal((n, h * d), dtype=np.float32))
    ed = rng.uniform(size=g.num_edges_padded).astype(np.float32)
    ed_t = torch.from_numpy(ed).to(dev)
    xs = halo.shard_halo_nodes(hg, mesh, x)
    eds = halo.halo_edge_data(hg, mesh, ed)

    def seg_spmm(e_, x_):
        return ops.vector_spmm(g.reverse(), e_[g.csc_perm.long()], x_)

    errs["halo_spmm_ell"] = dist_case(
        "halo_spmm_ell", lambda x_: halo.halo_spmm_ell(hg, he, mesh, eds, x_),
        lambda x_: seg_spmm(ed_t, x_), [xs], [x.to(dev)], n)
    kern.reset()
    errs["halo_spmm"] = dist_case(
        "halo_spmm", lambda x_: halo.halo_spmm(hg, mesh, eds, x_),
        lambda x_: seg_spmm(ed_t, x_), [xs], [x.to(dev)], n)
    errs["halo_gat_attention"] = dist_case(
        "halo_gat_attention",
        lambda q, k, v: halo.halo_gat_attention(hg, mesh, q, k, v),
        seg_attention, qkv, one, n)
    halo_csr = csr_sum.launches

    # The gather plan on the same graph.
    dg = shard_ops.dist_graph(g, mesh)
    gq = [shard_ops.shard_nodes(dg, mesh, a) for a in host]
    eid = torch.from_numpy(dg.eid.reshape(-1).astype(np.int64)).to(dev)
    real = eid < e

    def canon(y):
        out = y.new_zeros((g.num_edges_padded,) + tuple(y.shape[1:]))
        return out.index_copy(0, eid[real], y[real])

    errs["dist_sddmm"] = dist_case(
        "dist_sddmm", lambda a, b: shard_ops.dist_sddmm(dg, mesh, a, b),
        lambda a, b: ops.sddmm(g, a, b), gq[:2], one[:2], e,
        maps={0: canon})
    sc = rng.standard_normal((e, h), dtype=np.float32)
    sc_t = torch.from_numpy(sc).to(dev)
    errs["dist_edge_softmax"] = dist_case(
        "dist_edge_softmax",
        lambda s_: shard_ops.dist_edge_softmax(dg, mesh, s_, by="dst"),
        lambda s_: ops.edge_softmax(g, s_, by="dst"),
        [shard_ops.shard_edges(dg, mesh, sc)], [sc_t], e,
        maps={0: canon, 1: canon})
    errs["dist_vector_spmm"] = dist_case(
        "dist_vector_spmm", lambda s_, v_: shard_ops.dist_vector_spmm(
            dg, mesh, s_, v_),
        lambda s_, v_: ops.vector_spmm(g, s_, v_),
        [shard_ops.shard_edges(dg, mesh, sc), gq[2]], [sc_t, one[2]], n,
        maps={1: lambda t: canon(t)[:e]})
    errs["dist_gat_attention"] = dist_case(
        "dist_gat_attention",
        lambda q, k, v: shard_ops.dist_gat_attention(dg, mesh, q, k, v),
        seg_attention, gq, one, n)
    seg_csr = csr_sum.launches
    mesh_h = make_mesh((DIST_HEADS,), ("head",), device=dev)
    errs["tp_attention"] = dist_case(
        "tp_attention", lambda q, k, v: tp.tp_attention(de, se, mesh_h, q, k,
                                                        v),
        lambda q, k, v: ops.ell_attention(de, se, q, k, v), one, one, n)
    log(f"[dist parity] CSR-entry launches in the segment forms: halo "
        f"{halo_csr}, with the gather plan {seg_csr}")
    assert halo_csr > 0 and seg_csr > halo_csr
    del dg, gq

    profile_dist_step(dev, dist)

    # S3's CSR entry at the halo shape: the sorted segment sum over dst_loc.
    ri = hg.rows("dst_loc")
    vals = normal(rng, ri.shape[0] * ri.shape[1], h * d, device=dev)
    calls = {"csr_sum:halo": (ri.ptr, vals),
             "csr_sum:halo d=4": (ri.ptr, vals[:, :h].contiguous())}
    errs.update(check_kernels(kern, calls, "halo dst_loc"))
    row = time_row(kern, "csr_sum:halo", calls["csr_sum:halo"],
                   "halo shape", {}, lib=csr_yardstick(ri.ptr, vals))
    # The other library call for the same sums: embedding_bag with
    # offsets over the identity slots.
    ident = torch.arange(vals.shape[0], dtype=torch.int32, device=dev)
    row["embedding_bag_ms"] = time_library(
        "halo shape", "csr_sum:halo", csr_yardstick(ri.ptr, vals, ident),
        kern.table["csr_sum"][1](ri.ptr, vals), {})
    # The halo's edge-softmax sums: one value a head (d = 4).
    key = "csr_sum:halo d=4"
    row4 = l2_bound(time_row(kern, key, calls[key], "halo shape", {},
                             lib=csr_yardstick(*calls[key])),
                    "csr_sum", calls[key], l2_rate)
    l2_bound(row, "csr_sum", calls["csr_sum:halo"], l2_rate)
    return dict(errs=errs, row=row, row4=row4, launches=seg_csr)


def profile_dist_step(dev, dist):
    """One train step of products_gat_dist's model (GAT, hidden 64, 4
    heads, 2 layers, Adam) on the 8-shard halo plan under the profiler:
    its step time, the device's idle share and the device time of the
    largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from custom_op_benchmark_tpu_torch.parallel.train_dist import (
        dist_gat_forward,
        init_dist_gat,
    )

    lay, mesh = dist["layout"], dist["mesh"]
    params = init_dist_gat(SEED, lay.x.shape[1], DIST_HEADS * DIST_HEAD_DIM,
                           dist["ds"].num_classes, DIST_HEADS, 2).to(dev)
    opt = torch.optim.Adam(params.parameters(), lr=1e-2)
    mask = lay.train_mask

    def step():
        opt.zero_grad(set_to_none=True)
        logits = dist_gat_forward(lay.dg, mesh, params, lay.x)
        nll = -torch.log_softmax(logits, -1).gather(
            -1, lay.labels[:, None])[:, 0]
        ((nll * mask).sum() / mask.sum()).backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, window, n_events = device_busy(prof)
    if not n_events:
        log("[dist profile] the profiler saw no device events: not measured")
        return
    log(f"[dist profile] one products_gat_dist step (8 shards): {wall:.1f} "
        f"ms of wall time under the profiler, device busy {busy / 1e3:.1f} "
        f"ms of a {window / 1e3:.1f} ms window (idle share "
        f"{1 - busy / window:.3f})")

    def dev_us(a):
        return getattr(a, "self_device_time_total", None) or getattr(
            a, "self_cuda_time_total", 0.0)

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)[:8]
    for a in rows:
        log(f"[dist profile]   {dev_us(a) / 1e3:9.3f} ms "
            f"({dev_us(a) / busy:.3f} of busy) x{a.count:<5d} "
            f"{a.key[:90]}")


def phase_nccl(dev):
    """A one-rank NCCL group on the card: the process mesh's collectives
    run there, and one ``halo_attention_ell`` gradient step on it equals
    the local mesh at P = 1 (loss, input and projection gradients within
    1e-5, after the ordered gradient sum)."""
    import torch.distributed as dist

    from custom_op_benchmark_tpu_torch.graph import random_graph
    from custom_op_benchmark_tpu_torch.parallel import (
        global_sum,
        halo,
        make_mesh,
        psum_grads,
    )

    store = PLAN_CACHE.parent / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh_p = make_mesh(axis_names=("edge",), group=True)
        local = make_mesh((1,), ("edge",), device=dev)
        log(f"[nccl] backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, {mesh_p}")
        g = random_graph(*NCCL_GRAPH, seed=SEED, power_law=True)
        rng = np.random.default_rng(SEED + 31)
        x = rng.standard_normal((g.n_nodes, 32), dtype=np.float32)
        w0 = torch.from_numpy(rng.normal(0, 0.2, (32, 64)).astype(
            np.float32)).to(dev)
        out = []
        for m in (mesh_p, local):
            hg = halo.halo_graph(g, m, hub_threshold="auto")
            he = halo.halo_ell(hg, m)
            xs = halo.shard_halo_nodes(hg, m, x).requires_grad_()
            w = w0.clone().requires_grad_()
            q = (xs @ w).reshape(xs.shape[0], 4, 16)
            loss = (halo.halo_attention_ell(hg, he, m, q, q, q) ** 2).sum()
            gx, gw = torch.autograd.grad(loss, (xs, w))
            (gw,) = psum_grads(m, "edge", [gw])
            out.append((global_sum(m, "edge", loss.detach()), gx, gw))
        torch.cuda.synchronize()
        for name, a, b in zip(("loss", "input gradient",
                               "projection gradient"), *out):
            err = float((a - b).abs().max())
            ok = bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5))
            log(f"[nccl] process mesh vs local mesh at P = 1, {name}: "
                f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
            assert ok
    finally:
        dist.destroy_process_group()


def phase_dist_cli(kern):
    """The three distributed configurations through ``train.run.main`` on
    local meshes of their shard counts, with the counters set to 0 before
    each and read after: a finite loss, the JAX CLI's keys, the step time,
    peak memory and the plan's host seconds (the products plan comes from
    the cache the dist build wrote)."""
    import contextlib
    import io
    import os

    from custom_op_benchmark_tpu_torch.train import run

    os.environ["COB_CACHE_DIR"] = str(PLAN_CACHE)
    recs = {}
    for config, scale in DIST_CLI:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kern.reset()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--config", config, "--scale", str(scale)])
        wall = time.perf_counter() - t0
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        plan = rec["plan"]
        picked = plan.get("order_details", {}).get("picked", "cached")
        log(f"[dist cli] {config} --scale {scale}: loss {rec['loss']:.6f} "
            f"train_acc {rec['train_acc']:.4f} val_acc {rec['val_acc']:.4f} "
            f"on {rec['num_devices']} shards; {rec['steps']} steps, step "
            f"{rec['step_ms']:.3f} ms, peak {rec['peak_gib']:.2f} GiB; "
            f"{wall:.1f} s in all; plan host seconds: order "
            f"{plan['order_s']:.2f} reorder {plan['reorder_s']:.2f} "
            f"halo_graph {plan['halo_graph_s']:.2f} halo_ell "
            f"{plan['halo_ell_s']:.2f}; order {picked}, hub threshold "
            f"{plan['hub_threshold']}, halo_fraction "
            f"{plan['halo_fraction']:.4f}; launches {kern.launches()}")
        assert rc == 0 and rec["config"] == config
        assert np.isfinite(rec["loss"]) and rec["num_devices"] == (
            16 if config.startswith("papers") else 8)
        recs[config] = dict(rec, wall_s=wall)
    return recs


def phase_dp(kern, dev, reddit):
    """``fit_sampled_dp`` on reddit_sage's dataset at ``--scale 1``:
    GraphSAGE(128, 2 layers), fanouts (25, 10), batches of 256 over a
    local mesh of 4 shards for ``DP_STEPS`` steps, the counters set to 0
    before and read after (S3 twice and the CSR entry once a shard a step,
    besides the final full-graph evaluation's), the step and sampling
    times and peak memory; then two steps twice from one seed, equal bits.
    """
    from custom_op_benchmark_tpu_torch.parallel import make_mesh
    from custom_op_benchmark_tpu_torch.train import fit_sampled_dp, run

    ds = reddit["ds"]
    mesh = make_mesh((DP_SHARDS,), ("batch",), device=dev)
    kw = dict(fanouts=run.REDDIT_FANOUTS, batch_size=run.REDDIT_BATCH,
              epochs=1, learning_rate=1e-3, seed=SEED)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kern.reset()
    model = reddit_model(ds, dev)
    t0 = time.perf_counter()
    _, met = fit_sampled_dp(model, ds, mesh, max_steps=DP_STEPS, **kw)
    wall = time.perf_counter() - t0
    peak = sync_peak_gib()
    total = kern.launches()
    # The final evaluation's launches: the same full-graph forward.
    kern.reset()
    with torch.no_grad():
        model(ds.graph.to(dev), reddit["feats"])
    torch.cuda.synchronize()
    evals = kern.launches()
    steps = met["steps"]
    s3 = (total["gather_sum"] - evals["gather_sum"]) / steps
    csr = (total["csr_sum"] - evals["csr_sum"]) / steps
    log(f"[dp] fit_sampled_dp on {DP_SHARDS} shards: {steps} steps, step "
        f"{met['step_ms']:.3f} ms, sampling a group {met['sample_ms']:.3f} "
        f"ms (host), peak {peak:.2f} GiB, {wall:.1f} s in all; losses "
        f"{met['losses'][0]:.4f} .. {met['losses'][-1]:.4f}; val_acc "
        f"{met['val_acc']:.4f}; launches a step: S3 {s3} (expected "
        f"{2 * DP_SHARDS}), CSR entry {csr} (expected {DP_SHARDS}); the "
        f"evaluation {evals['gather_sum']} S3, {evals['csr_sum']} CSR")
    assert steps == DP_STEPS and np.isfinite(met["losses"]).all()
    assert s3 == 2 * DP_SHARDS and csr == DP_SHARDS, (s3, csr)
    runs = []
    for _ in range(2):
        m2 = reddit_model(ds, dev)
        _, mt = fit_sampled_dp(m2, ds, mesh, max_steps=2, **kw)
        runs.append((mt["losses"], [p.detach().clone()
                                     for p in m2.parameters()]))
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    log(f"[dp] two steps twice from one seed: "
        f"{'same bits' if same else 'DIFFERENT'}")
    assert same
    return dict(met, peak_gib=peak, wall_s=wall, s3_per_step=s3,
                csr_per_step=csr, launches=total)


def phase_dryrun(dev):
    from custom_op_benchmark_tpu_torch.entry import dryrun_multichip

    losses = dryrun_multichip(DIST_SHARDS, device=dev)
    log(f"[dryrun] dryrun_multichip({DIST_SHARDS}) on the card: {losses}")


def kernel_row(name, source, replaces, n, err, row, shape):
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": n, "max_abs_err": err,
           "ms": row["ms"], "plain_ms": row["plain_ms"],
           "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
           "library_ms": row["library_ms"], "library": row["library"],
           "shape": shape}
    for extra in ("bound_l2_ms", "embedding_bag_ms"):
        if extra in row:
            out[extra] = row[extra]
    return out


class Phases:
    """Runs each phase and logs its seconds."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {self.seconds[name]:.1f} s")
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from custom_op_benchmark_tpu_torch.utils.benchlib import l2_gather_rate

    run = Phases()
    dev = run("device", phase_device)
    kern = Kernels()
    l2_rate = l2_gather_rate(dev)
    l2_rate_s3 = s3_l2_rate(dev)
    log(f"[s3] L2 gather rate (benchlib.l2_gather_rate, the probe kernel "
        f"csrc/l2_probe.cu): {l2_rate / 1e12:.3f} TB/s; S3 itself on the "
        f"same L2-resident table (the earlier definition): "
        f"{l2_rate_s3 / 1e12:.3f} TB/s")
    kern.reset()
    g, tg_cpu, tg, x, labels, model_cpu = build_slice(dev)
    errs, slice_inputs = run("parity", phase_parity, kern, dev, tg)
    model = run("slice", phase_slice, dev, g, tg_cpu, tg, x, labels,
                model_cpu)
    launches, train_step = run("train", phase_train, kern, dev, g, tg, x,
                               labels, model)
    times = run("times", phase_times, kern, slice_inputs, train_step)
    del train_step, model
    torch.cuda.empty_cache()
    bf16_errs, bf16_launches, bf16_times = run("bf16", phase_bf16, kern, dev,
                                               g, slice_inputs)
    del slice_inputs
    torch.cuda.empty_cache()
    wide_errs, wide_launches, wide_times = run("wide K4", phase_wide_k4, kern,
                                               dev, tg)
    run("block", phase_block, kern, dev, g)
    gc.collect()
    torch.cuda.empty_cache()
    run("bench", phase_bench, kern, dev, l2_rate / l2_rate_s3)
    suite_launches = run("clique suite", phase_clique_suite, kern, dev)
    suite_errs, suite_times = run("suite kernels", phase_suite_kernels, kern,
                                  dev, tg)
    run("bench_models", phase_bench_models, kern, dev)
    gc.collect()
    torch.cuda.empty_cache()
    case = run("grid build", phase_grid_build, dev)
    grid_errs = run("grid parity", phase_grid_parity, kern, dev, case)
    grid_launches, grid_bf16_launches = run("grid path", phase_grid_path,
                                            kern, case)
    grid_times = run("grid times", phase_grid_times, kern, case)
    del case
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[grid] device memory still allocated after the grid: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pl_case, train = run("power-law build", phase_powerlaw_build, dev)
    s3_errs, s3_inputs = run("S3 parity", phase_s3_parity, kern, dev,
                             pl_case, train)
    del train
    hub_times = run("S3 hub times", phase_s3_hub_times, kern, pl_case,
                    l2_rate)
    pl_launches = run("power-law path", phase_powerlaw_path, kern, pl_case,
                      s3_inputs)
    del pl_case
    torch.cuda.empty_cache()
    arxiv_in = run("arxiv build", arxiv_data, dev)
    arxiv = run("arxiv", phase_arxiv, kern, arxiv_in)
    csr_errs, csr_row, csr_narrow, gat_csr = run("csr", phase_csr, kern,
                                                 arxiv_in, l2_rate)
    gc.collect()
    torch.cuda.empty_cache()
    dtype = run("dtype", phase_dtype, kern, dev, g, tg, arxiv_in)
    gc.collect()
    torch.cuda.empty_cache()
    run("native", phase_native, arxiv_in)
    del arxiv_in
    gc.collect()
    torch.cuda.empty_cache()
    run("entry", phase_entry, kern, dev)
    gc.collect()
    torch.cuda.empty_cache()
    run("cli", phase_cli, kern, dev)
    s3_times = run("S3 times", phase_s3_times, kern, s3_inputs, l2_rate)
    reddit = run("reddit build", reddit_data, dev)
    run("determinism", phase_determinism, kern, dev, reddit)
    sampled = run("sampled", phase_sampled, kern, dev, reddit, l2_rate)
    dp = run("dp", phase_dp, kern, dev, reddit)
    del reddit
    gc.collect()
    torch.cuda.empty_cache()
    run("resilient", phase_resilient, kern, dev)
    dist = run("dist build", phase_dist_build, dev)
    dist_par = run("dist parity", phase_dist_parity, kern, dev, dist,
                   l2_rate)
    del dist
    gc.collect()
    torch.cuda.empty_cache()
    run("nccl", phase_nccl, dev)
    dist_cli = run("dist CLI", phase_dist_cli, kern)
    run("dryrun", phase_dryrun, dev)
    summary = {"dp": {k: dp[k] for k in ("steps", "step_ms", "sample_ms",
                                         "peak_gib", "val_acc", "s3_per_step",
                                         "csr_per_step")}}
    for config, rec in dist_cli.items():
        summary[config] = {k: rec[k] for k in (
            "loss", "train_acc", "val_acc", "num_devices", "step_ms",
            "peak_gib", "wall_s")}
    log(f"[dist] summary: {json.dumps(summary)}")
    log(f"[phase] all: {sum(run.seconds.values()):.1f} s")
    report = []
    for name, (_, _, source, replaces) in kern.table.items():
        if name in SLICE_KERNELS:
            row, err = times[(name, "h=8 d=64")], errs[name]
            n, shape = launches[name], "GraphTransformer slice, h=8 d=64"
        elif name == "csr_sum":
            row, err = csr_row, csr_errs["csr_sum:copy"]
            n = sampled["launches"]["csr_sum"]
            shape = ("arxiv copy-sum: 160,000 rows, 4.31M slots through "
                     "src_csc, d=128; launches: the reddit_sage command "
                     "line at --scale 1 (sampled backward, evaluation)")
        elif name == "gather_sum":
            row, err = s3_times["gather_sum"], s3_errs["gather_sum:experiment"]
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
    for name in DMA_KERNELS:
        _, _, source, replaces = kern.table[name]
        key = f"{name}:bf16"
        report.append(kernel_row(
            key, source, replaces, grid_bf16_launches[name], grid_errs[key],
            grid_times[key], f"grid 1024x1024, d={GRID_D}, bf16; launches: "
            "the grid path's bf16 launches"))
    family = ("the bf16 op family and attention through impl='tiled' (the "
              "grid path runs {} in f32 only)")
    for name, key, n, what in (
            ("spmm_row_sweep", "spmm_row_sweep:bf16",
             grid_bf16_launches["spmm_row_sweep"],
             "the grid path's bf16 launches"),
            ("sddmm_tiles", "sddmm_tiles:bf16", bf16_launches["sddmm_tiles"],
             family.format("K1")),
            ("spmm_col_sweep", "spmm_col_sweep:bf16",
             bf16_launches["spmm_col_sweep"], family.format("K3")),
            ("fused_attention_rows", f"fused_attention_rows:d={GRID_D}:bf16",
             bf16_launches["fused_attention_rows"],
             "the bf16 op family and attention through impl='tiled' (the "
             "grid path's bf16 attention runs K4's bf16 kernel through "
             "attn_variant)")):
        _, _, source, replaces = kern.table[name]
        report.append(kernel_row(
            f"{name}:bf16 grid", source, replaces, n, grid_errs[key],
            grid_times[key], f"grid 1024x1024, d={GRID_D}, bf16; launches: "
            + what))
    _, _, source, replaces = kern.table["gather_sum"]
    report.append(kernel_row(
        "gather_sum:bf16", source, replaces, dtype["s3_bf16_launches"],
        s3_errs["gather_sum:experiment,bf16"], s3_times["gather_sum:bf16"],
        "ELL bucket 125000x16, d=128, bf16 (exp_pallas_gather's shape, a "
        "one-bucket table); launches: one bf16 AdamW step of GraphSAGE on "
        "bf16 features of the arxiv configuration"))
    _, _, source, replaces = kern.table["fused_attention_rows"]
    for key, row in wide_times.items():
        report.append(kernel_row(
            key, source, replaces, wide_launches[key], wide_errs[key], row,
            "irregular n=300, one head; launches: attention(impl='tiled')"))
    for key, row in suite_times.items():
        name = key.partition(":")[0]
        _, _, source, replaces = kern.table[name]
        report.append(kernel_row(
            key, source, replaces, suite_launches[name], suite_errs[key], row,
            f"clique suite 512x30, unaligned tiling, one head, "
            f"{key.partition(' ')[2]}; launches: one clique suite run "
            f"(every shape of the suite)"))
    for key, row in sampled["rows"].items():
        name = key.partition(":")[0]
        _, _, source, replaces = kern.table[name]
        report.append(kernel_row(
            key, source, replaces, sampled["launches"][name],
            sampled["errs"][key], row,
            "reddit_sage batch: 70,656 nodes, in_cols 70,656 x 32, "
            + ("x d=300" if name == "gather_sum" else "dy d=128 over "
               "indptr_r and dst") + "; launches: the reddit_sage command "
            "line at --scale 1"))
    _, _, source, replaces = kern.table["csr_sum"]
    report.append(kernel_row(
        "csr_sum:halo", source, replaces, dist_par["launches"],
        dist_par["errs"]["csr_sum:halo"], dist_par["row"],
        f"halo plan of the products-like graph, {DIST_SHARDS} shards on one "
        f"card: dst_loc's sorted segments, x ({DIST_SHARDS}·E_p, "
        f"{DIST_HEADS * DIST_HEAD_DIM}); launches: the segment forms "
        "(halo_spmm, halo_gat_attention, the gather plan's ops) in the dist "
        "parity phase, forward and backward"))
    for key, row in hub_times.items():
        name = key.partition(":")[0]
        _, _, source, replaces = kern.table[name]
        report.append(kernel_row(
            key + " (hub)", source, replaces, pl_launches[name],
            s3_errs["gather_sum:pow2,src,table" if name == "gather_sum"
                    else "csr_sum:powerlaw src rows"], row,
            "power-law graph (131,072 nodes, 2M edges), d=128: "
            + ("the pow-2 src table, the 27,565-slot hub padded to 32,768"
               if name == "gather_sum" else "the src rows over identity "
               "slots (pl_spmm/xla_segment's forward sum), the 27,565-slot "
               "hub") + "; launches: the power-law path (suite and "
            "experiment)"))
    _, _, source, replaces = kern.table["csr_sum"]
    for key, row in csr_narrow.items():
        report.append(kernel_row(
            key, source, replaces, gat_csr, csr_errs[key], row,
            "arxiv segment shapes (160,000 rows, 4.31M slots): "
            + {"csr_sum:d=1": "edge data d=1 through csc_perm",
               "csr_sum:edges dst": "edge data d=4 through csc_perm",
               "csr_sum:edges dst d=8": "edge data d=8 through csc_perm",
               "csr_sum:copy d=64": "the copy through src_csc, d=64"}[key]
            + "; launches: one arxiv GAT step on the segment path"))
    report.append(kernel_row(
        "csr_sum:halo d=4", source, replaces, dist_par["launches"],
        dist_par["errs"]["csr_sum:halo d=4"], dist_par["row4"],
        "halo plan of the products-like graph, dst_loc's sorted segments, "
        "x (8·E_p, 4): the edge softmax's sums; launches: the segment forms "
        "in the dist parity phase"))
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
