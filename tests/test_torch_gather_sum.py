"""S3, the ELL copy-sum (ops/kernels/gather_sum.py), against the Pallas
kernel of scripts/exp_pallas_gather.py.

The JAX side runs ``pallas_gather_sum(interpret=True)`` on the CPU; the
port's wrapper runs its plain version because the tensors lie on the CPU.
Same numpy inputs for both, f32. The Pallas kernel takes R a multiple of 8
(its grid drops the tail) and in-range columns; the port also takes any R
and treats out-of-range columns as zero, which is checked against numpy.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import exp_pallas_gather as jax_gather  # noqa: E402

from custom_op_benchmark_tpu_torch.ops.kernels import _build  # noqa: E402
from custom_op_benchmark_tpu_torch.ops.kernels import (  # noqa: E402
    gather_sum as k_gather,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, r, k, n, d):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    cols = rng.integers(0, n, size=(r, k)).astype(np.int32)
    return cols, x


@pytest.mark.parametrize("r, k, n, d", [(16, 16, 100, 128), (8, 4, 50, 1),
                                        (24, 5, 70, 33)])
def test_plain_matches_the_pallas_kernel(r, k, n, d):
    cols, x = _inputs(d, r, k, n, d)
    want = np.asarray(jax_gather.pallas_gather_sum(
        jnp.asarray(cols), jnp.asarray(x), interpret=True))
    got = k_gather.gather_sum(torch.from_numpy(cols), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_gather.xla_gather_sum(
            jnp.asarray(cols), jnp.asarray(x))), **TOL)


def test_out_of_range_columns_add_zero_at_any_r():
    cols, x = _inputs(3, 13, 7, 40, 6)          # R = 13: not a multiple of 8
    cols[::2, ::3] = 40                         # the ELL pad column n
    cols[1, 0] = -1
    valid = (cols >= 0) & (cols < 40)
    want = np.where(valid[..., None], x[np.clip(cols, 0, 39)], 0).sum(1)
    got = k_gather.gather_sum(torch.from_numpy(cols), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pad = torch.full((8, 4), 40, dtype=torch.int32)
    assert not k_gather.gather_sum(pad, torch.from_numpy(x)).any()


def test_trailing_dims_are_flattened():
    cols, x = _inputs(4, 16, 5, 30, 24)
    x3 = torch.from_numpy(x).reshape(30, 4, 6)
    got = k_gather.gather_sum(torch.from_numpy(cols), x3)
    assert got.shape == (16, 4, 6)
    np.testing.assert_allclose(got.reshape(16, 24).numpy(),
                               x[cols].sum(1), **TOL)


@pytest.mark.parametrize("cols, x, match", [
    (torch.zeros(4, 2, dtype=torch.int64), torch.zeros(3, 2), "int32"),
    (torch.zeros(4, dtype=torch.int32), torch.zeros(3, 2), r"\(R, D\)"),
    (torch.zeros(4, 2, dtype=torch.int32), torch.zeros(3, 2,
                                                       dtype=torch.int32),
     "floating"),
])
def test_argument_checks(cols, x, match):
    with pytest.raises(ValueError, match=match):
        k_gather.gather_sum(cols, x)


def test_no_kernel_for_other_devices():
    cols = torch.zeros(8, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        k_gather.gather_sum(cols, torch.zeros(3, 2, device="meta"))


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    def refuse(*_):
        raise AssertionError("the build was reached")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = k_gather.gather_sum.launches
    cols, x = _inputs(5, 8, 3, 10, 4)
    k_gather.gather_sum(torch.from_numpy(cols), torch.from_numpy(x))
    assert k_gather.gather_sum.launches == before


def test_the_build_knows_the_kernel():
    assert "gather_sum.cu" in _build.SOURCES
    assert (_build.CSRC / "gather_sum.cu").is_file()
    assert len(_build._SIGNATURES["gather_sum_f32"]) == 10
