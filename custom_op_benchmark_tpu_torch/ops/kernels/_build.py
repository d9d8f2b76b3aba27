"""Build the hand-written CUDA kernels and load them with ctypes.

The sources under ``custom_op_benchmark_tpu_torch/csrc/`` have a plain C
interface, so ``nvcc`` compiles them in seconds (no PyTorch headers): one
``nvcc -c`` per source, all started together, then one link into a shared
library. The build runs at first use, into
``build/torch_kernels/`` at the repository root, keyed on a hash of the
sources, their headers and the flags: an unchanged checkout reuses its
library, a changed one builds anew. A failed build raises with nvcc's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("tiled_kernels.cu", "attention.cu", "grid_dma.cu",
           "gather_sum.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument types of every C entry point; pointers and the stream are
# c_void_p so ctypes does not cut them to 32 bits.
# The _bf16 entry points of K1–K4, S1 and S2 take the same arguments as
# their _f32 ones.
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
    "gather_sum_f32": [_P, _I, _P, _P, _I, _P, _I, _P, _P] + [_I] * 4
    + [_P],
}
_SIGNATURES.update({name.replace("_f32", "_bf16"): _SIGNATURES[name]
                    for name in ("sddmm_tiles_f32", "spmm_row_sweep_f32",
                                 "spmm_col_sweep_f32",
                                 "fused_attention_rows_f32",
                                 "spmm_row_sweep_dma_f32",
                                 "spmm_row_sweep_dma_v2_f32")})


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
