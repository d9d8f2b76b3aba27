"""Build the hand-written CUDA kernels, load them with ctypes and launch
them.

The sources under ``custom_op_benchmark_tpu_torch/csrc/`` have a plain C
interface, so ``nvcc`` compiles them in seconds (no PyTorch headers): one
``nvcc -c`` per source, all started together, then one link into a shared
library. The build runs at first use, into
``build/torch_kernels/`` at the repository root, keyed on a hash of the
sources, their headers and the flags: an unchanged checkout reuses its
library, a changed one builds anew. A failed build raises with nvcc's
output; there is no fallback.

Every wrapper of ``ops/kernels`` launches through :func:`call`, which
picks the entry point for the dtype, passes the device and stream, opens
``utils.spans.launch`` around the launch, checks its status and counts it
on the wrapper. The argument checks the wrappers share (:func:`on_cpu`,
:func:`check_cuda`) live here too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from custom_op_benchmark_tpu_torch.utils.spans import launch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("tiled_kernels.cu", "attention.cu", "grid_dma.cu",
           "gather_sum.cu", "l2_probe.cu", "ell_gat.cu", "norm_act.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument types of every C entry point; pointers and the stream are
# c_void_p so ctypes does not cut them to 32 bits.
# The _bf16 entry points of K1–K4, S1, S2, S3, S3's CSR entry and the GAT
# sweeps take the same arguments as their _f32 ones.
_SIGNATURES = {
    "sddmm_tiles_f32": [_P] * 6 + [_I] * 6 + [_P],
    "spmm_row_sweep_f32": [_P] * 5 + [_I] * 7 + [_P],
    "spmm_col_sweep_f32": [_P] * 6 + [_I] * 8 + [_P],
    "fused_attention_rows_f32": [_P] * 7 + [_I] * 6 + [ctypes.c_float]
    + [_I] * 5 + [_P],
    "spmm_dotonly_f32": [_P] * 4 + [_I] * 6 + [_P],
    "attn_variant_f32": [_P] * 7 + [_I] * 6 + [ctypes.c_float] + [_I] * 7
    + [_P],
    "spmm_row_sweep_dma_f32": [_P] * 4 + [_I] * 7 + [_P],
    "spmm_row_sweep_dma_v2_f32": [_P] * 5 + [_I] * 6 + [_P],
    "gather_sum_f32": [_P, _I, _P, _P, _I, _P, _I, _P, _P] + [_I] * 3
    + [_P] + [_I] * 3 + [_P],
    "csr_sum_f32": [_P, _I, _P, _P, _P] + [_I] * 3 + [_P] + [_I] * 2 + [_P],
    "l2_probe_f32": [_P, _I, _I, _I, _I, _P, _I, _P],
    "ell_gat_fwd_f32": [_P, _I, _P, _P, _I, _P, _I] + [_P] * 4 + [_I] * 3
    + [ctypes.c_float] + [_P] * 5 + [_I] * 4 + [_P],
    "ell_gat_bwd_dst_f32": [_P, _I, _P, _P, _I, _P, _I] + [_P] * 6
    + [_I] * 3 + [ctypes.c_float] + [_P] * 3 + [_I] * 3 + [_P],
    "ell_gat_bwd_src_f32": [_P, _I, _P, _P, _I, _P, _I] + [_P] * 7
    + [_I] * 3 + [_P] * 5 + [_I] * 4 + [_P],
    "norm_act_fwd_f32": [_P] * 5 + [_I] * 2 + [ctypes.c_float] + [_P] * 5
    + [_I, _P],
    "norm_act_bwd_f32": [_P] * 7 + [_I] * 2 + [_P] * 5 + [_I, _P],
}
_SIGNATURES.update({name.replace("_f32", "_bf16"): _SIGNATURES[name]
                    for name in ("sddmm_tiles_f32", "spmm_row_sweep_f32",
                                 "spmm_col_sweep_f32",
                                 "fused_attention_rows_f32",
                                 "spmm_row_sweep_dma_f32",
                                 "spmm_row_sweep_dma_v2_f32",
                                 "gather_sum_f32", "csr_sum_f32",
                                 "ell_gat_fwd_f32", "ell_gat_bwd_dst_f32",
                                 "ell_gat_bwd_src_f32")})


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libtorch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    Returns its path. nvcc's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept beside it as ``.log``.
    """
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    if not Path(nvcc).is_file():
        raise RuntimeError(f"cannot build the CUDA kernels: no nvcc at "
                           f"{nvcc} (set CUDA_HOME or put nvcc on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / name)]
            for name, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in jobs]
    outs = [p.communicate()[0] for p in procs]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    failed = [(cmd, out) for cmd, p, out in zip(jobs, procs, outs)
              if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = [(link, outs[-1])]
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    so.with_suffix(".log").write_text("".join(outs))
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


# ---------------------------------------------------------------------------
# The launch path and the checks the wrappers share
# ---------------------------------------------------------------------------

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every tensor lies
    on one CUDA device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check_cuda(*, ints=(), floats=(), bf16=False) -> None:
    """The checks every CUDA entry point needs of its arguments: ``ints``
    contiguous int32; ``floats`` contiguous and of one dtype, float32 or,
    with ``bf16``, also bfloat16."""
    for t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("index arrays must be contiguous int32")
    allowed = KERNEL_DTYPES if bf16 else (torch.float32,)
    for t in floats:
        if t.dtype not in allowed or not t.is_contiguous():
            raise ValueError(
                "the kernel takes contiguous tensors of "
                f"{' or '.join(map(str, allowed))}, got {t.dtype}, "
                f"contiguous={t.is_contiguous()}")
    if len({t.dtype for t in floats}) > 1:
        raise ValueError("the kernel takes one dtype per call, got "
                         f"{sorted(str(t.dtype) for t in floats)}")


def c_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """``t``'s data pointer as a C argument."""
    return ctypes.c_void_p(t.data_ptr())


def entry(name: str, t: torch.Tensor) -> str:
    """The C entry point of ``name`` for ``t``'s dtype (``<name>_f32`` or
    ``<name>_bf16``)."""
    return f"{name}_{'bf16' if t.dtype == torch.bfloat16 else 'f32'}"


def device_stream(t: torch.Tensor):
    """(device index, current stream) of ``t``'s device, the last two
    arguments of every C entry point."""
    return (t.device.index,
            ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream))


def call(fn, name: str, t: torch.Tensor, *args) -> None:
    """Launch the C entry point of ``name`` for ``t``'s dtype with
    ``args`` as given, then ``t``'s device and current stream, inside
    ``spans.launch`` (a profiler then links the kernel to the caller's
    span); raise naming the entry point if the launch failed; else count
    one launch on ``fn``: ``fn.launches`` in float32, ``fn.launches_bf16``
    in bfloat16. The library is looked up at each call."""
    name = entry(name, t)
    dev, stream = device_stream(t)
    kernel = getattr(library(), name)
    with launch(name):
        check(kernel(*args, dev, stream), name)
    if t.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1
