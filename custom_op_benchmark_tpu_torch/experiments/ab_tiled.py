"""Tile-kernel A/B: the committed K1–K4, S4, S5, S1 and S2 against other
builds of their sources.

    python -m custom_op_benchmark_tpu_torch.experiments.ab_tiled \\
        [--k1k2 TILED_KERNELS.cu ...] [--k4 ATTENTION.cu ...] \\
        [--dma GRID_DMA.cu ...]

``--k1k2`` names another ``csrc/tiled_kernels.cu`` (K1, K2, K3 and S4),
``--k4`` another ``csrc/attention.cu`` (K4 and S5), ``--dma`` another
``csrc/grid_dma.cu`` (S1 and S2): a parent's, copied out of git under
``build/`` (the chip machine's copy of the repository has no ``.git``)
together with the ``csrc/mma_async.cuh`` of the same commit, or an edited
copy (``sed``) beside the header it was made for. A quoted include
resolves beside the source first, so each file is built against its own
header, and the script refuses a file that includes the header without one
beside it (built alone it would take the committed header and time the new
arithmetic as the old). For the parent commit, say ``P``::

    mkdir -p build/ab/P
    for f in tiled_kernels.cu attention.cu grid_dma.cu mma_async.cuh; do
      git show P:custom_op_benchmark_tpu_torch/csrc/$f > build/ab/P/$f
    done

then on one H100 ``... ab_tiled --k1k2 build/ab/P/tiled_kernels.cu
--k4 build/ab/P/attention.cu --dma build/ab/P/grid_dma.cu``. Each option
is repeatable.

Each file is built with the port's nvcc flags into ``build/`` and its
entry points bound with the committed signatures (``_build._SIGNATURES``,
those of every commit from ``249dfd7`` on). Both builds run through the
committed wrappers, which launch whichever library is in place
(:func:`~custom_op_benchmark_tpu_torch.experiments.common.on_library`),
so the two sides take the same arguments, checks and launch path. Each
kernel the file has is checked against its plain version (f32: rtol =
atol = 1e-4; bf16: |kernel − plain| ≤ 2⁻⁷·|plain| + 1e-4) and timed by
CUDA events in turns (old, new, new, old; each time a median of repeats):
K1–K3 and S4 at the slice's shapes (the 512×30 clique batch's transposed
tile view, h = 8, d = 64, and h = 1, d = 1024) and on the 1024×1024 grid
at d = 128, each in f32 and bf16 (S4 in f32), with the bf16 BSR call
(``torch.sparse_bsr_tensor @ dense``, one call a head) timed beside K2;
K4 at the slice's shapes (h = 8, d = 64; one head at d = 300 and 1024),
on the 300-node irregular graph of ``chip_smoke.py`` (d = 300 and 1024,
where each build's host time to enqueue a call is also set beside its
device time) and on the grid at d = 128, in bf16 too at the slice (h = 8,
d = 64), n = 300, d = 300 and on the grid; S5 on the grid in its four
switch settings (timed on the grid's own inputs and checked there with
``exp``; without it, checked on inputs where it is well posed); S1 and S2
on the grid in f32 and bf16, with the committed K2 on the same inputs
timed in the same call, S2 held equal to it bit for bit, and the bf16 BSR
call beside the bf16 rows. Prints one JSON line ``{"ab_tiled": {...}}``
with the card's name and power limit, and exits 1 if a build disagrees
with its plain version, S2 differs from K2, or an f32 output of the other
build differs from the committed build's bits (expected of a design with
other f32 arithmetic, or of an edited copy that skips work). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.experiments.common import (
    load_builds,
    on_library,
)
from custom_op_benchmark_tpu_torch.graph import (
    clique_batch,
    from_coo,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels import attention as ka
from custom_op_benchmark_tpu_torch.ops.kernels import grid_dma as kg
from custom_op_benchmark_tpu_torch.ops.kernels import tiled_kernels as kt
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.bench_suite import grid_case
from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

RTOL = ATOL = 1e-4
BF16_RTOL = 2.0 ** -7
GRID_TIMING = dict(warmup=1, iters=3, repeats=3)
# K4's bf16 rows off the grid.
BF16_K4 = ("slice h=8 d=64", "n=300 d=300")
S5_SETTINGS = {f"{'exp' if e else 'noexp'},{'mask' if m else 'nomask'}":
               dict(use_exp=e, use_mask=m) for e in (True, False)
               for m in (True, False)}
# K1-K3 and S4: wrapper and plain version.
TILE_KERNELS = {
    "sddmm_tiles": (kt.sddmm_tiles, kt.sddmm_tiles_plain),
    "spmm_row_sweep": (kt.spmm_row_sweep, kt.spmm_row_sweep_plain),
    "spmm_col_sweep": (kt.spmm_col_sweep, kt.spmm_col_sweep_plain),
    "spmm_dotonly": (kt.spmm_dotonly, kt.spmm_dotonly_plain),
}


def load_old(files):
    """Build each of ``files`` against the ``mma_async.cuh`` beside it and
    bind its entry points: the libraries, in order."""
    for source in files:
        if ('#include "mma_async.cuh"' in source.read_text()
                and not (source.parent / "mma_async.cuh").is_file()):
            raise SystemExit(
                f"{source} includes mma_async.cuh but none lies beside it: "
                "copy the header of the same commit into its directory")
    return load_builds(files, "ab_tiled")


def has(lib, name, t):
    """Whether ``lib`` has ``name``'s entry point for ``t``'s dtype."""
    return _build.entry(name, t) in lib.entries


def ab(lib, fn):
    """``fn`` launching ``lib``'s kernels and the committed ones: (old,
    new), both through the same wrapper."""
    def on(which):
        def run(*args, **kwargs):
            with on_library(which):
                return fn(*args, **kwargs)
        return run

    return on(lib), on(_build.library())


def bsr_ms(ptr, cols, vals, x, timing):
    """ms of the BSR call computing K2's function in ``vals``' dtype:
    ``torch.sparse_bsr_tensor(ptr, cols, vals[h]) @ x[:, h]``, one call a
    head (PyTorch batches no BSR product over heads); None where PyTorch
    refuses these inputs."""
    v = kt.as_tiles4(vals)
    xh = kt.as_heads(x)
    nrb, ncb = ptr.numel() - 1, -(-xh.shape[0] // kt.TILE)
    xp = xh.new_zeros((xh.shape[1], ncb * kt.TILE, xh.shape[2]))
    xp[:, : xh.shape[0]] = xh.permute(1, 0, 2)
    mats = [torch.sparse_bsr_tensor(ptr, cols, v[i],
                                    size=(nrb * kt.TILE, ncb * kt.TILE))
            for i in range(v.shape[0])]

    def fn():
        return [m @ xp[i] for i, m in enumerate(mats)]

    try:
        fn()
    except RuntimeError:
        return None
    return statistics.median(time_cuda(fn, **timing)) * 1e3


def dma_grid(libs, case, out):
    """S1 and S2 of each other build against the committed ones on the
    grid at d = 128, in f32 and bf16, and the committed K2 on S2's inputs
    (held equal to S2 bit for bit) and the BSR call in the same call."""
    for dt in (torch.float32, torch.bfloat16):
        tag = "" if dt == torch.float32 else " bf16"
        x, vals = case.q_al.to(dt), case.vals.to(dt)
        s2 = (case.tg.tile_ptr, case.tg.tile_cols, vals, x)
        k2 = kt.spmm_row_sweep(*s2)
        same = bool(torch.equal(kg.spmm_row_sweep_dma_v2(*s2), k2))
        del k2
        k2_row = out[f"spmm_row_sweep (K2) grid d=128{tag}"] = dict(
            s2_equals_k2=same, ms=statistics.median(time_cuda(
                lambda: kt.spmm_row_sweep(*s2), **GRID_TIMING)) * 1e3,
            bsr_ms=bsr_ms(*s2, GRID_TIMING))
        s1 = kg.pad_layout(case.tg, vals) + (x,)
        for name, lib in libs:
            if not has(lib, "spmm_row_sweep_dma", x):
                continue
            out[f"spmm_row_sweep_dma grid d=128{tag} vs {name}"] = compare(
                *ab(lib, kg.spmm_row_sweep_dma), kg.spmm_row_sweep_dma_plain,
                s1, GRID_TIMING, bits=True)
            out[f"spmm_row_sweep_dma_v2 grid d=128{tag} vs {name}"] = compare(
                *ab(lib, kg.spmm_row_sweep_dma_v2), kt.spmm_row_sweep_plain,
                s2, GRID_TIMING, bits=True)
        k2_row["ms_after"] = statistics.median(time_cuda(
            lambda: kt.spmm_row_sweep(*s2), **GRID_TIMING)) * 1e3
        del s1, s2, x, vals
        torch.cuda.empty_cache()


def within_gate(got, want):
    """The kernels' gate against their plain versions: rtol = atol = 1e-4
    in f32; one bf16 rounding above the f32 floor in bf16."""
    if got.dtype == torch.bfloat16:
        diff = (got.float() - want.float()).abs()
        return bool((diff <= BF16_RTOL * want.float().abs() + ATOL).all())
    return bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))


def compare(old, new, plain, args, timing, kwargs=None, check_args=None,
            bits=False):
    """Both builds against the plain version on ``check_args`` (``args``
    when None), then timed in turns on ``args``. With ``bits``, an f32 row
    also requires the two builds' outputs to be equal bit for bit."""
    kwargs = kwargs or {}
    check = args if check_args is None else check_args
    want = plain(*check, **kwargs)
    res, got = {"dtype": str(want.dtype).replace("torch.", "")}, {}
    for name, fn in (("old", old), ("new", new)):
        got[name] = fn(*check, **kwargs)
        res[f"{name}_max_abs_err"] = float(
            (got[name].float() - want.float()).abs().max())
        res[f"{name}_ok"] = within_gate(got[name], want)
    res["same_bits"] = bool(torch.equal(got["old"], got["new"]))
    if bits and want.dtype == torch.float32:
        res["bits_required"] = True
    del got, want

    def ms(fn):
        return statistics.median(time_cuda(
            lambda: fn(*args, **kwargs), **timing)) * 1e3

    o1, n1, n2, o2 = ms(old), ms(new), ms(new), ms(old)
    res.update(old_ms=(o1 + o2) / 2, new_ms=(n1 + n2) / 2,
               old_ms_each=[o1, o2], new_ms_each=[n1, n2],
               new_over_old=(n1 + n2) / (o1 + o2))
    torch.cuda.empty_cache()
    return res


def host_and_device_ms(fn, calls=20):
    """Where a small call's time goes: the host's ms per call to enqueue it
    (no synchronisation between calls), and the device's ms per call with
    the host out of the way (``calls`` calls captured in a CUDA graph,
    replayed, timed by CUDA events; median of 5)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    device = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / calls)
    del graph
    return dict(host_ms=host, device_ms=statistics.median(device))


def kernel_args(tg, a, b, vals):
    """K1-K3's arguments as the attention backward gives them, and S4's."""
    return {
        "sddmm_tiles": (tg.tile_rows, tg.tile_cols, tg.mask, a, b),
        "spmm_row_sweep": (tg.tile_ptr, tg.tile_cols, vals, b, a.shape[0]),
        "spmm_col_sweep": (tg.tile_ptr_c, tg.tile_perm_c, tg.tile_rows, vals,
                           a, b.shape[0]),
        "spmm_dotonly": (tg.tile_ptr, tg.tile_cols, b, a.shape[0]),
    }


def tile_rows(libs, label, calls, timing, out):
    """Every other build's K1-K3 and S4 on ``calls`` (f32 or bf16), with
    the BSR call beside K2. ``libs``: (tag, lib)."""
    for name, call in calls.items():
        x = next(t for t in call if torch.is_tensor(t)
                 and t.is_floating_point())
        dt = str(x.dtype).replace("torch.", "")
        if name == "spmm_row_sweep":
            out[f"bsr_ms {label} {dt}"] = bsr_ms(*call[:4], timing)
        new, plain = TILE_KERNELS[name]
        for tag, lib in libs:
            if has(lib, name, x):
                out[f"{name} {label} {dt} vs {tag}"] = compare(
                    *ab(lib, new), plain, call, timing, bits=True)


def attention_slice(libs, tgt, rng, normal, out):
    """K4 of each other build at the slice's shapes and on the 300-node
    irregular graph; in bf16 too at h = 8, d = 64 and n = 300, d = 300."""
    def k4(label, tg, d, heads=None, enqueue=False):
        shape = (tg.n_nodes, d) if heads is None else (tg.n_nodes, heads, d)
        call = (tg.tile_ptr, tg.tile_cols, tg.mask,
                *(normal(*shape) for _ in range(3)), d ** -0.5)
        for tag, lib in libs:
            old, new = ab(lib, ka.fused_attention_rows)
            dtypes = ((torch.float32, torch.bfloat16) if label in BF16_K4
                      else (torch.float32,))
            for dt in dtypes:
                args = tuple(a.to(dt) if torch.is_tensor(a)
                             and a.is_floating_point() else a for a in call)
                res = dict(layout=ka.kernel_route(d), **compare(
                    old, new, ka.fused_attention_rows_plain, args, {},
                    bits=True))
                if enqueue and dt == torch.float32:
                    for name, fn in (("old", old), ("new", new)):
                        res[f"{name}_enqueue"] = host_and_device_ms(
                            lambda: fn(*args))
                tail = "" if dt == torch.float32 else " bf16"
                out[f"fused_attention_rows {label}{tail} vs {tag}"] = res

    k4("slice h=8 d=64", tgt, 64, heads=8)
    n_small = 300
    src = rng.choice(np.r_[0:128, 256:n_small], size=4000)
    dst = rng.choice(np.r_[0:256], size=4000)
    small = tile_graph(from_coo(src, dst, n_small), 128, 128,
                       device=tgt.tile_ptr.device)
    for d in (300, 1024):
        k4(f"n=300 d={d}", small, d, enqueue=True)
        k4(f"slice h=1 d={d}", tgt, d)


def attention_grid(libs, case, out):
    """K4 (f32 and bf16) and S5's four settings on the grid at d = 128."""
    tg = case.tg.transpose()
    att = (tg.tile_ptr, tg.tile_cols, tg.mask, case.q_al, case.q_al,
           case.q_al, case.d ** -0.5)
    wp = (tg.tile_ptr, tg.tile_cols) + ka.well_posed_s5(
        tg, case.d, device=case.q_al.device, seed=3)
    x16 = case.q_al.bfloat16()
    for tag, lib in libs:
        k4 = ab(lib, ka.fused_attention_rows)
        for tail, args in (("", att), (" bf16", att[:3] + (x16,) * 3
                                       + att[6:])):
            out[f"fused_attention_rows grid d=128{tail} vs {tag}"] = dict(
                layout=ka.kernel_route(case.d), **compare(
                    *k4, ka.fused_attention_rows_plain, args, GRID_TIMING,
                    bits=True))
        for key, kw in S5_SETTINGS.items():
            out[f"attn_variant {key} grid d=128 vs {tag}"] = compare(
                *ab(lib, ka.attn_variant), ka.attn_variant_plain, att,
                GRID_TIMING, kw, None if kw["use_exp"] else wp, bits=True)
    del x16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1k2", type=Path, action="append", default=[],
                    help="another tiled_kernels.cu for K1-K3 and S4 "
                    "(repeatable)")
    ap.add_argument("--k4", type=Path, action="append", default=[],
                    help="another attention.cu for K4 and S5 (repeatable)")
    ap.add_argument("--dma", type=Path, action="append", default=[],
                    help="another grid_dma.cu for S1 and S2 (repeatable)")
    args = ap.parse_args(argv)
    if not (args.k1k2 or args.k4 or args.dma):
        ap.error("name at least one file: --k1k2, --k4 or --dma")
    dev = cuda_device()
    files = args.k1k2 + args.k4 + args.dma
    libs = dict(zip(files, load_old(files)))

    def tagged(group):
        return [(f"{f.parent.name}/{f.name}", libs[f]) for f in group]

    olds, libs4, dma_libs = (tagged(args.k1k2), tagged(args.k4),
                             tagged(args.dma))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi}
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    tgt = tile_graph(clique_batch(512, 30), 128, 128, device=dev).transpose()
    if olds:
        n = tgt.n_nodes
        vals = torch.where(tgt.mask, normal(8, tgt.num_tiles, 128, 128), 0.0)
        x, y = normal(n, 1024), normal(n, 1024)
        cases = [("slice h=8 d=64", normal(n, 8, 64), normal(n, 8, 64),
                  vals), ("slice h=1 d=1024", x, y, vals[0].contiguous())]
        for label, a, b, v in cases:
            for dt in (torch.float32, torch.bfloat16):
                tile_rows(olds, label, kernel_args(
                    tgt, a.to(dt), b.to(dt), v.to(dt)), {}, out)
        del cases, vals, x, y
    if libs4:
        attention_slice(libs4, tgt, rng, normal, out)
    del tgt
    torch.cuda.empty_cache()
    case = grid_case(1024, 1024, 128, device=dev)
    if olds:
        for dt in (torch.float32, torch.bfloat16):
            x = case.q_al.to(dt)
            tile_rows(olds, "grid d=128", kernel_args(
                case.tg, x, x, case.vals.to(dt)), GRID_TIMING, out)
            del x
            torch.cuda.empty_cache()
    if libs4:
        attention_grid(libs4, case, out)
    if dma_libs:
        dma_grid(dma_libs, case, out)
    print(json.dumps({"ab_tiled": out}), flush=True)
    return 0 if all(r.get("old_ok", True) and r.get("new_ok", True)
                    and r.get("s2_equals_k2", True)
                    and (r.get("same_bits") or not r.get("bits_required"))
                    for r in out.values() if isinstance(r, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
