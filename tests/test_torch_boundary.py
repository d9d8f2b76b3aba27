"""The port's boundaries: what it imports, where it runs, how it builds."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import custom_op_benchmark_tpu_torch
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.utils import cuda_device

PKG = Path(custom_op_benchmark_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "custom_op_benchmark_tpu")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import custom_op_benchmark_tpu_torch\n"
        "import custom_op_benchmark_tpu_torch.graph\n"
        "import custom_op_benchmark_tpu_torch.ops\n"
        "import custom_op_benchmark_tpu_torch.models\n"
        "import custom_op_benchmark_tpu_torch.train\n"
        "import custom_op_benchmark_tpu_torch.utils\n"
        "import custom_op_benchmark_tpu_torch.utils.bench_suite\n"
        "import custom_op_benchmark_tpu_torch.experiments.exp_grid_dma\n"
        "import custom_op_benchmark_tpu_torch.experiments.exp_grid_bisect\n"
        "import custom_op_benchmark_tpu_torch.experiments.exp_pallas_gather\n"
        "import custom_op_benchmark_tpu_torch.experiments.ab_tiled\n"
        "import custom_op_benchmark_tpu_torch.experiments.ab_gather\n"
        "import custom_op_benchmark_tpu_torch.data\n"
        "import custom_op_benchmark_tpu_torch.ops.ell\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PKG)) for p in PKG.rglob("*.py")))
def test_no_module_imports_jax(path):
    tree = ast.parse((PKG / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_device_helper_has_no_cpu_fallback():
    if torch.cuda.is_available():
        assert cuda_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cuda_device()


def test_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent == PKG.parent / "build" / "torch_kernels"
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    for name in _build.SOURCES:
        (tmp_path / name).write_text("// changed\n")
    assert _build.library_path() != path


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not any(tmp_path.iterdir())
