"""The ELL copy-sum S3 beside its plain version.

Counterpart of ``pallas_gather_sum`` in scripts/exp_pallas_gather.py:

- :func:`gather_sum` (S3) — ``y[r] = Σ_k x[cols[r, k]]`` over one ELL
  bucket, cols ``(R, D)`` int32 and x ``(n_x, ...)`` f32, trailing dims of
  x flattened; y is ``(R,) + x.shape[1:]``.

A slot whose column is outside ``[0, n_x)`` adds zero: the ELL pad column
``n_nodes`` needs no padded row of x, the convention of S1/S2. Any R is
taken (the TPU kernel needs R % 8 == 0, its grid drops the tail), and any
width d ≥ 1 (d = 1 is the degree count of ``ell_copy_spmm(reduce="mean")``).

The wrapper runs the CUDA kernel (csrc/gather_sum.cu) on CUDA tensors and
the plain version only on CPU tensors; ``gather_sum.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    _check_cuda,
    _on_cpu,
    _p,
    _stream,
)


def _check(cols: torch.Tensor, x: torch.Tensor) -> None:
    if cols.dim() != 2:
        raise ValueError(f"cols must be (R, D), got {tuple(cols.shape)}")
    if x.dim() < 1:
        raise ValueError("x must have a row axis")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"x must be floating point, got {x.dtype}")


def gather_sum_plain(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _check(cols, x)
    n_x = x.shape[0]
    c = cols.long()
    valid = (c >= 0) & (c < n_x)
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    g = xz[torch.where(valid, c, n_x)]                     # (R, D, ...)
    return g.sum(1)


def gather_sum(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cols: (R, D) int32, x: (n_x, ...) → y (R, ...), the sum over each
    row of cols of the rows of x it names (out-of-range names add 0)."""
    _check(cols, x)
    if _on_cpu(cols, x):
        return gather_sum_plain(cols, x)
    _check_cuda(ints=(cols,), floats=(x,))
    r, k = cols.shape
    trail = tuple(x.shape[1:])
    xf = x.reshape(x.shape[0], -1)
    d = xf.shape[1]
    out = torch.empty((r, d), device=x.device, dtype=x.dtype)
    if r == 0 or d == 0:
        return out.reshape((r,) + trail)
    if k == 0 or xf.shape[0] == 0:
        return out.zero_().reshape((r,) + trail)
    vec = int(d % 4 == 0 and xf.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    dev, stream = _stream(x)
    _build.check(_build.library().gather_sum_f32(
        _p(cols), _p(xf), _p(out), r, k, d, xf.shape[0], vec, dev, stream),
        "gather_sum")
    gather_sum.launches += 1
    return out.reshape((r,) + trail)


gather_sum.launches = 0
