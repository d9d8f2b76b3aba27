#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — AdamW train steps of
``GraphTransformer(dim=512, num_heads=8, num_layers=3, out_dim=10)`` on the
512×30 clique batch through its 128×128 tile view — and checks it:

1. device: a CUDA device is present; print its name and power limit, then
   build the four CUDA kernels from ``custom_op_benchmark_tpu_torch/csrc``;
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the slice's shapes, K2/K3 also at d=1024, and on a small
   irregular graph with an empty row block and an empty column block;
3. the slice at full width: logits, loss and every parameter's gradient
   on the card against the same module copied to the CPU, where the
   wrappers run the plain versions;
4. train: three AdamW steps with finite losses, every kernel launched;
5. times: each kernel against its plain version, and one train step.

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
    """The four kernels, their plain versions and where they came from."""

    def __init__(self):
        from custom_op_benchmark_tpu_torch.ops.kernels import attention as ka
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
        }

    def reset(self):
        for fn, *_ in self.table.values():
            fn.launches = 0

    def launches(self):
        return {name: fn.launches for name, (fn, *_) in self.table.items()}


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


def check_kernels(kern, calls, label, only=None):
    """Kernel vs plain on the card; also checks that two kernel runs agree
    bit for bit. Returns the max abs error per kernel."""
    errs = {}
    for name, args in calls.items():
        if only is not None and name not in only:
            continue
        fn, plain = kern.table[name][:2]
        got, again = fn(*args), fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert torch.equal(got, again), f"{name} is not deterministic"
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        log(f"[parity] {label:28s} {name:22s} shape {tuple(got.shape)} "
            f"max_abs_err {err:.3e} max|plain| "
            f"{float(want.abs().max()):.3e} {'ok' if ok else 'FAIL'}")
        assert ok, f"{name} disagrees with its plain version ({label})"
        errs[name] = err
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
    assert all(n > 0 for n in launches.values()), launches
    return launches, lambda: step(state, g, xx, yy, mm)


def time_ms(fn, warmup=3, iters=10, repeats=5):
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


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
    report = []
    for name, (_, _, source, replaces) in kern.table.items():
        ms, plain_ms = times[(name, "h=8 d=64")]
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": errs[name], "ms": ms,
                       "plain_ms": plain_ms})
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
