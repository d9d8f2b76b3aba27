"""Tile-kernel A/B: the committed K1–K4, S5, S1 and S2 against older builds.

    python -m custom_op_benchmark_tpu_torch.experiments.ab_tiled \\
        [--k1k2 OLD.cu ...] [--k3 OLD_K3.cu] [--k4 OLD_ATTENTION.cu ...] \\
        [--dma OLD_GRID_DMA.cu ...]

``--k1k2`` and ``--k3`` name an older ``csrc/tiled_kernels.cu``, ``--k4``
an older ``csrc/attention.cu``, ``--dma`` an older or edited
``csrc/grid_dma.cu``, each copied out of git under ``build/`` (the chip
machine's copy of the repository has no ``.git``) together with the
``csrc/mma_async.cuh`` of the same commit, beside it: a quoted include
resolves beside the source first, so the old file is built against its own
header, and the script refuses a file that includes the header without
one beside it (built alone it would take the committed header and time
the new arithmetic as the old). For the parent commit, say ``P``::

    mkdir -p build/ab/P
    for f in tiled_kernels.cu attention.cu grid_dma.cu mma_async.cuh; do
      git show P:custom_op_benchmark_tpu_torch/csrc/$f > build/ab/P/$f
    done

then on one H100 ``... ab_tiled --k1k2 build/ab/P/tiled_kernels.cu
--k4 build/ab/P/attention.cu --dma build/ab/P/grid_dma.cu``. An edited
copy (``sed``) in the same directory is an older build like any other.

- ``--k1k2`` (repeatable): a file whose ``sddmm_tiles_f32`` and
  ``spmm_row_sweep_f32`` have the committed signatures; its K1 and K2 are
  timed against the committed ones, in f32 and, where the file has them
  (commit ``faa5f85`` on), through ``sddmm_tiles_bf16`` and
  ``spmm_row_sweep_bf16`` in bf16, with the bf16 BSR call
  (``torch.sparse_bsr_tensor @ dense``, one call a head) timed beside K2. A file with bf16 entries also has the
  committed K3 and S4 signatures, so its K3 (f32 and bf16) and S4 are
  timed too. The CUDA-core K1 and K2 are those of commit ``6fd63b9``.
- ``--k3``: a file whose ``spmm_col_sweep_f32`` takes no ``vec``
  argument, as the CUDA-core K3 of commit ``11ccb10`` does; its K3 is
  timed against the committed one.
- ``--k4`` (repeatable): a file whose ``fused_attention_rows_f32`` takes
  no launch layout and whose ``attn_variant_f32`` takes no ``vec``, as
  those of commit ``faa5f85`` do (K4 with one block per 128 output
  features recomputing the scores above d = 128, and S5 on the CUDA
  cores, d ≤ 256); or a file with the committed signatures (its
  ``fused_attention_rows_f32`` takes the launch layout ``int clusters``,
  commit ``008df9d`` on), whose K4 is then also timed in bf16 through
  ``fused_attention_rows_bf16`` (at the slice, on the grid and at
  n = 300, d = 300) and whose f32 K4 and S5 must give the committed
  build's bits.
- ``--dma`` (repeatable): a file whose ``spmm_row_sweep_dma_f32`` and
  ``spmm_row_sweep_dma_v2_f32`` have the committed signatures, as those of
  commit ``d5e31ae`` (S1 and S2 on the CUDA cores) do, or an edited copy of
  the committed file; its S1 and S2 are timed against the committed ones on
  the grid, in f32 and (where it has the ``_bf16`` entries) in bf16, with
  the committed K2 on the same inputs timed in the same call, S2 held equal
  to it bit for bit, and the bf16 BSR call timed beside the bf16 rows.

Each file is built with the port's nvcc flags into ``build/``. Both builds
of each kernel are checked against its plain version (f32: rtol = atol =
1e-4; bf16: |kernel − plain| ≤ 2⁻⁷·|plain| + 1e-4) and timed by CUDA events
in turns (old, new, new, old; each time a median of repeats): K1–K3 at the
slice's shapes (the 512×30 clique batch's transposed tile view, h = 8,
d = 64, and h = 1, d = 1024) and on the 1024×1024 grid at d = 128, each in
f32 and bf16; K4 at the slice's shapes (h = 8, d = 64; one head at d = 300
and 1024), on the 300-node irregular graph of ``chip_smoke.py`` (d = 300
and 1024, where each build's host time to enqueue a call is also set
beside its device time), and on the grid at d = 128; S5 on the grid in its
four switch settings (timed on the grid's own inputs and checked there
with ``exp``; without it, checked on inputs where it is well posed).
Prints one JSON line ``{"ab_tiled": {...}}`` with the card's name and power
limit, and exits 1 if a build disagrees with its plain version, S2 differs
from K2, or an f32 output of a ``--k1k2``, ``--dma`` or committed-signature
``--k4`` file differs from the committed build's bits (expected of an
older design with other f32 arithmetic, such as the CUDA-core builds, or
of an edited copy that skips work). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from custom_op_benchmark_tpu_torch.graph import (
    clique_batch,
    from_coo,
    tile_graph,
)
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels import attention as ka
from custom_op_benchmark_tpu_torch.ops.kernels import tiled_kernels as kt
from custom_op_benchmark_tpu_torch.utils import cuda_device
from custom_op_benchmark_tpu_torch.utils.bench_suite import grid_case
from custom_op_benchmark_tpu_torch.utils.benchlib import time_cuda

RTOL = ATOL = 1e-4
BF16_RTOL = 2.0 ** -7
GRID_TIMING = dict(warmup=1, iters=3, repeats=3)
_P, _I = ctypes.c_void_p, ctypes.c_int
# The older entry points' argument types (K3 without ``vec``; K4 without
# a launch layout, S5 without ``vec``). A ``_bf16`` entry takes its
# ``_f32`` one's arguments.
OLD_SIGNATURES = {
    "k1k2": {"sddmm_tiles_f32": [_P] * 6 + [_I] * 6 + [_P],
             "spmm_row_sweep_f32": [_P] * 5 + [_I] * 7 + [_P]},
    "k3": {"spmm_col_sweep_f32": [_P] * 6 + [_I] * 7 + [_P]},
    "k4": {"fused_attention_rows_f32": [_P] * 7 + [_I] * 6
           + [ctypes.c_float, _I, _I, _P],
           "attn_variant_f32": [_P] * 7 + [_I] * 6 + [ctypes.c_float]
           + [_I] * 3 + [_P]},
    "dma": {"spmm_row_sweep_dma_f32": [_P] * 4 + [_I] * 7 + [_P],
            "spmm_row_sweep_dma_v2_f32": [_P] * 5 + [_I] * 6 + [_P]},
}
# A --k1k2 file with bf16 entries (commit faa5f85 on) has K3 and S4 with
# the committed signatures; a --k4 file whose K4 takes ``int clusters``
# has K4 (f32 and bf16) and S5 with them.
BF16_ERA = {"spmm_col_sweep_f32": [_P] * 6 + [_I] * 8 + [_P],
            "spmm_dotonly_f32": [_P] * 4 + [_I] * 6 + [_P]}
# K4's bf16 rows (against a committed-signature --k4 file).
BF16_K4 = ("slice h=8 d=64", "n=300 d=300")
S5_SETTINGS = {f"{'exp' if e else 'noexp'},{'mask' if m else 'nomask'}":
               dict(use_exp=e, use_mask=m) for e in (True, False)
               for m in (True, False)}


def load_old(files):
    """Build each (source, role) of ``files`` against the ``mma_async.cuh``
    beside it (one nvcc each, all started together) and bind its entry
    points: the role's, their ``_bf16`` twins where present and, for a
    bf16-era ``--k1k2`` file, K3 and S4. Returns the libraries in order."""
    jobs = []
    for source, role in files:
        if ('#include "mma_async.cuh"' in source.read_text()
                and not (source.parent / "mma_async.cuh").is_file()):
            raise SystemExit(
                f"{source} includes mma_async.cuh but none lies beside it: "
                "copy the header of the same commit into its directory")
        so = (_build.BUILD_DIR
              / f"ab_{role}_{source.parent.name}_{source.stem}.so")
        so.parent.mkdir(parents=True, exist_ok=True)
        jobs.append((so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(source)])))
    libs = []
    for (so, proc), (source, role) in zip(jobs, files):
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed on {source}")
        lib = ctypes.CDLL(str(so))
        signatures = dict(OLD_SIGNATURES[role])
        if role == "k1k2" and hasattr(lib, "sddmm_tiles_bf16"):
            signatures.update(BF16_ERA)
        lib.committed = role == "k4" and committed_k4(source)
        if lib.committed:
            signatures = {name: _build._SIGNATURES[name]
                          for name in OLD_SIGNATURES["k4"]}
        for name, argtypes in list(signatures.items()):
            twin = name.replace("_f32", "_bf16")
            if hasattr(lib, twin):
                signatures[twin] = argtypes
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.entries = set(signatures)
        libs.append(lib)
    return libs


def committed_k4(source):
    """Whether ``source``'s ``fused_attention_rows_f32`` takes the launch
    layout (``int clusters``), as the committed one does."""
    text = source.read_text()
    at = text.find("int fused_attention_rows_f32(")
    return at >= 0 and "int clusters" in text[at: text.find(")", at)]


def has(lib, name, t):
    """Whether ``lib`` has ``name``'s entry point for ``t``'s dtype."""
    return kt._entry(name, t) in lib.entries


def old_sddmm(lib, rows, cols, mask, A, B):
    a, b = kt._heads(A), kt._heads(B)
    t, h, d = mask.shape[0], a.shape[1], a.shape[2]
    out = torch.empty((h, t, kt.TILE, kt.TILE), device=A.device,
                      dtype=A.dtype)
    dev, stream = kt._stream(A)
    _build.check(getattr(lib, kt._entry("sddmm_tiles", A))(
        kt._p(rows), kt._p(cols), kt._p(mask), kt._p(a), kt._p(b),
        kt._p(out), t, h, d, a.shape[0], b.shape[0], dev, stream),
        "old sddmm_tiles")
    return out[0] if A.dim() == 2 else out


def old_row_sweep(lib, ptr, cols, vals, x, n_out):
    v, xh = kt._tiles4(vals), kt._heads(x)
    h, t, d = v.shape[0], v.shape[1], xh.shape[2]
    out = torch.empty((n_out, h, d), device=x.device, dtype=x.dtype)
    dev, stream = kt._stream(x)
    _build.check(getattr(lib, kt._entry("spmm_row_sweep", x))(
        kt._p(ptr), kt._p(cols), kt._p(v), kt._p(xh), kt._p(out),
        ptr.numel() - 1, t, h, d, xh.shape[0], n_out, dev, stream),
        "old spmm_row_sweep")
    return out[:, 0] if x.dim() == 2 else out


def old_col_sweep(lib, ptr_c, perm, rows, vals, y, n_out):
    """The older K3: without ``vec`` (``--k3``), or with the committed
    signature (a bf16-era ``--k1k2`` file)."""
    v, yh = kt._tiles4(vals), kt._heads(y)
    h, t, d = v.shape[0], v.shape[1], yh.shape[2]
    out = torch.empty((n_out, h, d), device=y.device, dtype=y.dtype)
    dev, stream = kt._stream(y)
    fn = getattr(lib, kt._entry("spmm_col_sweep", y))
    vec = [kt._vec(d, yh)] if len(fn.argtypes) == 15 else []
    _build.check(fn(
        kt._p(ptr_c), kt._p(perm), kt._p(rows), kt._p(v), kt._p(yh),
        kt._p(out), ptr_c.numel() - 1, t, h, d, yh.shape[0], n_out, *vec,
        dev, stream), "old spmm_col_sweep")
    return out[:, 0] if y.dim() == 2 else out


def old_dotonly(lib, ptr, cols, x, n_out=None):
    """The older S4 on the same arguments."""
    xh = kt._heads(x)
    nrb, h, d = ptr.numel() - 1, xh.shape[1], xh.shape[2]
    n_out = nrb * kt.TILE if n_out is None else n_out
    out = torch.empty((n_out, h, d), device=x.device)
    dev, stream = kt._stream(x)
    _build.check(lib.spmm_dotonly_f32(
        kt._p(ptr), kt._p(cols), kt._p(xh), kt._p(out), nrb, h, d,
        xh.shape[0], n_out, dev, stream), "old spmm_dotonly")
    return out[:, 0] if x.dim() == 2 else out


def old_attention(lib, ptr, cols, mask, q, k, v, scale, use_exp=None,
                  use_mask=None):
    """The older K4 (``use_exp`` None) or S5 on the same arguments."""
    qh, kh, vh = kt._heads(q), kt._heads(k), kt._heads(v)
    n_q, h, d = qh.shape
    out = torch.empty_like(qh)
    dev, stream = kt._stream(q)
    head = (kt._p(ptr), kt._p(cols), kt._p(mask), kt._p(qh), kt._p(kh),
            kt._p(vh), kt._p(out), ptr.numel() - 1, h, d, n_q, kh.shape[0],
            n_q, float(scale))
    if lib.committed:
        layout = (kt._vec(d, qh, kh, vh), *ka.kernel_route(d)[1:])
        if use_exp is None:
            status = getattr(lib, kt._entry("fused_attention_rows", q))(
                *head, *layout, dev, stream)
        else:
            status = lib.attn_variant_f32(*head, *layout, int(use_exp),
                                          int(use_mask), dev, stream)
    elif use_exp is None:
        status = lib.fused_attention_rows_f32(
            *head, kt._vec(d, qh, kh, vh), dev, stream)
    else:
        status = lib.attn_variant_f32(*head, int(use_exp), int(use_mask),
                                      dev, stream)
    _build.check(status, "old attention")
    return out[:, 0] if q.dim() == 2 else out


def old_dma(lib, cols_pad, vals_pad, x, n_out=None):
    """The older S1 on the same arguments."""
    nrb, mt = vals_pad.shape[:2]
    n_out = nrb * kt.TILE if n_out is None else n_out
    out = torch.empty((n_out, x.shape[1]), device=x.device, dtype=x.dtype)
    dev, stream = kt._stream(x)
    _build.check(getattr(lib, kt._entry("spmm_row_sweep_dma", x))(
        kt._p(cols_pad), kt._p(vals_pad), kt._p(x), kt._p(out), nrb, mt,
        x.shape[1], x.shape[0], n_out, kt._vec(x.shape[1], x), dev, stream),
        "old spmm_row_sweep_dma")
    return out


def old_dma_v2(lib, ptr, cols, vals, x, n_out=None):
    """The older S2 on the same arguments."""
    nrb = ptr.numel() - 1
    n_out = nrb * kt.TILE if n_out is None else n_out
    out = torch.empty((n_out, x.shape[1]), device=x.device, dtype=x.dtype)
    dev, stream = kt._stream(x)
    _build.check(getattr(lib, kt._entry("spmm_row_sweep_dma_v2", x))(
        kt._p(ptr), kt._p(cols), kt._p(vals), kt._p(x), kt._p(out), nrb,
        x.shape[1], x.shape[0], n_out, kt._vec(x.shape[1], x), dev, stream),
        "old spmm_row_sweep_dma_v2")
    return out


def bsr_ms(ptr, cols, vals, x, timing):
    """ms of the BSR call computing K2's function in ``vals``' dtype:
    ``torch.sparse_bsr_tensor(ptr, cols, vals[h]) @ x[:, h]``, one call a
    head (PyTorch batches no BSR product over heads); None where PyTorch
    refuses these inputs."""
    v = kt._tiles4(vals)
    xh = kt._heads(x)
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
    """S1 and S2 of each older build against the committed ones on the
    grid at d = 128, in f32 and bf16, and the committed K2 on S2's inputs
    (held equal to S2 bit for bit) and the BSR call in the same call."""
    from custom_op_benchmark_tpu_torch.ops.kernels import grid_dma as kg

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
        for source, lib in libs:
            if not has(lib, "spmm_row_sweep_dma", x):
                continue
            name = f"{source.parent.name}/{source.name}"
            out[f"spmm_row_sweep_dma grid d=128{tag} vs {name}"] = compare(
                lambda *a: old_dma(lib, *a), kg.spmm_row_sweep_dma,
                kg.spmm_row_sweep_dma_plain, s1, GRID_TIMING, bits=True)
            out[f"spmm_row_sweep_dma_v2 grid d=128{tag} vs {name}"] = compare(
                lambda *a: old_dma_v2(lib, *a), kg.spmm_row_sweep_dma_v2,
                kt.spmm_row_sweep_plain, s2, GRID_TIMING, bits=True)
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


def old_entries(role, lib):
    """The kernels an older file is timed on: name → (old, new, plain)."""
    table = {"sddmm_tiles": (old_sddmm, kt.sddmm_tiles, kt.sddmm_tiles_plain),
             "spmm_row_sweep": (old_row_sweep, kt.spmm_row_sweep,
                                kt.spmm_row_sweep_plain),
             "spmm_col_sweep": (old_col_sweep, kt.spmm_col_sweep,
                                kt.spmm_col_sweep_plain),
             "spmm_dotonly": (old_dotonly, kt.spmm_dotonly,
                              kt.spmm_dotonly_plain)}
    names = {"k1k2": ("sddmm_tiles", "spmm_row_sweep", "spmm_col_sweep",
                      "spmm_dotonly"), "k3": ("spmm_col_sweep",)}[role]
    out = {}
    for name in names:
        if f"{name}_f32" in lib.entries:
            old, new, plain = table[name]
            out[name] = (lambda *a, _old=old: _old(lib, *a), new, plain)
    return out


def tile_rows(olds, label, calls, timing, out):
    """Every older build's K1-K3 and S4 on ``calls`` (f32 or bf16), with
    the BSR call beside K2. ``olds``: (tag, lib, old_entries(...))."""
    for name, call in calls.items():
        x = next(t for t in call if torch.is_tensor(t)
                 and t.is_floating_point())
        dt = str(x.dtype).replace("torch.", "")
        if name == "spmm_row_sweep":
            out[f"bsr_ms {label} {dt}"] = bsr_ms(*call[:4], timing)
        for tag, lib, fns in olds:
            if name in fns and has(lib, name, x):
                out[f"{name} {label} {dt} vs {tag}"] = compare(
                    *fns[name], call, timing, bits=True)


def attention_slice(libs, tgt, rng, normal, out):
    """K4 of each older build at the slice's shapes and on the 300-node
    irregular graph; in bf16 too where the build has the committed
    signatures (h = 8, d = 64 and n = 300, d = 300)."""
    def k4(label, tg, d, heads=None, enqueue=False):
        shape = (tg.n_nodes, d) if heads is None else (tg.n_nodes, heads, d)
        call = (tg.tile_ptr, tg.tile_cols, tg.mask,
                *(normal(*shape) for _ in range(3)), d ** -0.5)
        for tag, lib in libs:
            dtypes = ((torch.float32, torch.bfloat16) if lib.committed
                      and label in BF16_K4 else (torch.float32,))
            for dt in dtypes:
                args = tuple(a.to(dt) if torch.is_tensor(a)
                             and a.is_floating_point() else a for a in call)

                def old(*a, _lib=lib):
                    return old_attention(_lib, *a)

                res = dict(layout=ka.kernel_route(d), **compare(
                    old, ka.fused_attention_rows,
                    ka.fused_attention_rows_plain, args, {},
                    bits=lib.committed))
                if enqueue and dt == torch.float32:
                    for name, fn in (("old", old),
                                     ("new", ka.fused_attention_rows)):
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
    """K4 (also in bf16 where the build has the committed signatures) and
    S5's four settings on the grid at d = 128."""
    tg = case.tg.transpose()
    att = (tg.tile_ptr, tg.tile_cols, tg.mask, case.q_al, case.q_al,
           case.q_al, case.d ** -0.5)
    wp = (tg.tile_ptr, tg.tile_cols) + ka.well_posed_s5(
        tg, case.d, device=case.q_al.device, seed=3)
    for tag, lib in libs:
        def old(*a, _lib=lib, **k):
            return old_attention(_lib, *a, **k)

        out[f"fused_attention_rows grid d=128 vs {tag}"] = dict(
            layout=ka.kernel_route(case.d), **compare(
                old, ka.fused_attention_rows, ka.fused_attention_rows_plain,
                att, GRID_TIMING, bits=lib.committed))
        if lib.committed:
            x16 = case.q_al.bfloat16()
            out[f"fused_attention_rows grid d=128 bf16 vs {tag}"] = dict(
                layout=ka.kernel_route(case.d), **compare(
                    old, ka.fused_attention_rows,
                    ka.fused_attention_rows_plain, att[:3] + (x16,) * 3
                    + att[6:], GRID_TIMING))
            del x16
        for key, kw in S5_SETTINGS.items():
            out[f"attn_variant {key} grid d=128 vs {tag}"] = compare(
                old, ka.attn_variant, ka.attn_variant_plain, att,
                GRID_TIMING, kw, None if kw["use_exp"] else wp,
                bits=lib.committed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1k2", type=Path, action="append", default=[],
                    help="older or edited tiled_kernels.cu for K1 and K2 "
                    "(and K3, S4 where it has bf16 entries; repeatable)")
    ap.add_argument("--k3", type=Path, help="older file for K3 (no vec)")
    ap.add_argument("--k4", type=Path, action="append", default=[],
                    help="older or edited attention.cu for K4 and S5 "
                    "(repeatable)")
    ap.add_argument("--dma", type=Path, action="append", default=[],
                    help="older or edited grid_dma.cu for S1 and S2 "
                    "(repeatable)")
    args = ap.parse_args(argv)
    if not (args.k1k2 or args.k3 or args.k4 or args.dma):
        ap.error("name at least one older file: --k1k2, --k3, --k4 or --dma")
    dev = cuda_device()
    files = ([(f, "k1k2") for f in args.k1k2]
             + ([(args.k3, "k3")] if args.k3 else [])
             + [(f, "k4") for f in args.k4]
             + [(f, "dma") for f in args.dma])
    libs = dict(zip(files, load_old(files)))
    olds = [(f"{f.parent.name}/{f.name}", libs[f, role],
             old_entries(role, libs[f, role]))
            for f, role in files if role in ("k1k2", "k3")]
    libs4 = [(f"{f.parent.name}/{f.name}", libs[f, "k4"]) for f in args.k4]
    dma_libs = [(f, libs[f, "dma"]) for f in args.dma]

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
