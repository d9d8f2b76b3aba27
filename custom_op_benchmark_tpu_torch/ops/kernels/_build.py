"""Build the hand-written CUDA kernels and load them with ctypes.

The sources under ``custom_op_benchmark_tpu_torch/csrc/`` have a plain C
interface, so ``nvcc`` compiles them in seconds into one shared library
(no PyTorch headers). The build runs at first use, into
``build/torch_kernels/`` at the repository root, keyed on a hash of the
sources and flags: an unchanged checkout reuses its library, a changed one
builds anew. A failed build raises with nvcc's output; there is no
fallback.
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
SOURCES = ("tiled_kernels.cu", "attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument types of every C entry point; pointers and the stream are
# c_void_p so ctypes does not cut them to 32 bits.
_SIGNATURES = {
    "sddmm_tiles_f32": [_P] * 6 + [_I] * 6 + [_P],
    "spmm_row_sweep_f32": [_P] * 5 + [_I] * 7 + [_P],
    "spmm_col_sweep_f32": [_P] * 6 + [_I] * 7 + [_P],
    "fused_attention_rows_f32": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I,
                                                       _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
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
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    so.with_suffix(".log").write_text(log)
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
