"""The DGL GAT's hidden-layer tail as fused CUDA passes (csrc/norm_act.cu),
beside its plain version.

A hidden layer of ``models/gat_dgl.py`` ends in ``y = ReLU(BN(out·ds +
r))``: ``out`` the attention's (n, h, d), ``ds`` the dst degree scale (n,
1, 1), ``r`` the linear residual (n, h·d), batch norm with the batch's own
mean and biased variance (``BatchNorm1d(track_running_stats=False)``).

- :func:`norm_act_forward` → ``(y, h, mean, rstd)``: ``h = out·ds + r``
  (the batch norm's input, which the backward keeps), ``y`` (n, W) with W
  = h·d, and the columns' mean and ``rstd = 1/sqrt(var + eps)``;
- :func:`norm_act_backward` → ``(d_out, d_r, d_weight, d_bias)`` from
  ``g = dL/dy`` and what the forward kept: ``d_r = dh = weight·rstd·(g·m
  − mean(g·m) − x̂·mean(g·m·x̂))`` with m the ReLU mask and x̂ = (h −
  mean)·rstd, both recomputed from h; ``d_out = dh·ds`` (n, W), out's
  cotangent; ``d_bias = Σ g·m``, ``d_weight = Σ g·m·x̂``.

On CUDA tensors they run the kernels (float32 only; one C entry point a
direction, three kernels each: a pass that reads the rows and writes
column partials, a small launch that merges the partials in a fixed order,
a pass that writes the outputs) and count each call on ``.launches``; on
CPU tensors the plain version below, in any float dtype. There is no
fallback. The kernels walk groups of :func:`group_rows` rows as 16-byte
vectors, one thread a vector, so they take rows of W with at most
``MAX_THREADS`` vectors a group (R·W ≤ 4096: W ≤ 1024 where W = 2 mod 4,
as DGL's 750), and row arrays that start on 16 bytes: the wrapper copies
one that does not. The plain version rounds h, x̂ and the pre-activation ``weight·x̂
+ bias`` at each step, as the kernels do, so given the same h, mean and
rstd both take the same ReLU mask.
"""

from __future__ import annotations

import math

import torch

from custom_op_benchmark_tpu_torch.ops.kernels._build import (
    c_ptr,
    call,
    check_cuda,
    on_cpu,
)

# csrc/norm_act.cu: the most row blocks (each writes R sets of column
# partials) and threads a block (one a 16-byte vector of a group).
MAX_BLOCKS = 264
MAX_THREADS = 1024


def group_rows(w: int) -> int:
    """Rows a group: the fewest whose R·w floats fill whole 32-byte sectors
    (8 / gcd(w, 8))."""
    return 8 // math.gcd(w, 8)


def _part(n: int, w: int, device) -> torch.Tensor:
    """The column partials' scratch: 2w floats a row of a group a block."""
    rows = group_rows(w)
    blocks = min(MAX_BLOCKS, -(-n // rows))
    return torch.empty((blocks * rows * 2 * w,), device=device,
                       dtype=torch.float32)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it that starts on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, -1)


def _normed(h, mean, rstd, weight, bias):
    """(x̂, the pre-activation weight·x̂ + bias), each step rounded."""
    xhat = (h - mean) * rstd
    return xhat, xhat * weight + bias


def _forward_plain(out, ds, r, weight, bias, eps: float):
    n = out.shape[0]
    shape = (n,) + (1,) * (out.dim() - 1)
    h = _rows(out * ds.reshape(shape), n) + _rows(r, n)
    mean = h.mean(0)
    var = (h - mean).square().mean(0)
    rstd = (var + eps).rsqrt()
    _, pre = _normed(h, mean, rstd, weight, bias)
    return pre.clamp_min(0), h, mean, rstd


def _backward_plain(g, h, ds, mean, rstd, weight, bias):
    n = h.shape[0]
    xhat, pre = _normed(h, mean, rstd, weight, bias)
    gm = torch.where(pre > 0, _rows(g, n), torch.zeros_like(h))
    d_bias = gm.sum(0)
    d_weight = (gm * xhat).sum(0)
    dh = weight * rstd * (gm - d_bias / n - xhat * (d_weight / n))
    return dh * ds.reshape(n, 1), dh, d_weight, d_bias


def _check(n: int, w: int, rows, vectors, ds):
    check_cuda(floats=rows + vectors + (ds,))
    if n < 1 or w < 1:
        raise ValueError(f"norm_act takes n, w ≥ 1, got n={n}, w={w}")
    if group_rows(w) * w // 4 > MAX_THREADS:
        raise ValueError(f"rows of {w} make groups of more than "
                         f"{MAX_THREADS} 16-byte vectors")
    for t in rows:
        if t.numel() != n * w:
            raise ValueError(f"{tuple(t.shape)} is not {n} rows of {w}")
    for t in vectors:
        if t.numel() != w:
            raise ValueError(f"{tuple(t.shape)} is not {w} columns")
    if ds.numel() != n:
        raise ValueError(f"ds {tuple(ds.shape)} is not one value a row")


def norm_act_forward(out: torch.Tensor, ds: torch.Tensor, r: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """out (n, ...) and r with n·W elements, ds n, weight and bias W →
    (y (n, W), h (n, W), mean (W,), rstd (W,))."""
    if on_cpu(out, ds, r, weight, bias):
        return _forward_plain(out, ds, r, weight, bias, eps)
    n = out.shape[0]
    w = out.numel() // max(n, 1)
    _check(n, w, (out, r), (weight, bias), ds)
    out, r = _aligned(out), _aligned(r)
    f32 = dict(device=out.device, dtype=torch.float32)
    h = torch.empty((n, w), **f32)
    y = torch.empty((n, w), **f32)
    mean = torch.empty((w,), **f32)
    rstd = torch.empty((w,), **f32)
    part = _part(n, w, out.device)
    call(norm_act_forward, "norm_act_fwd", out, c_ptr(out), c_ptr(ds),
         c_ptr(r), c_ptr(weight), c_ptr(bias), n, w, eps, c_ptr(h), c_ptr(y),
         c_ptr(mean), c_ptr(rstd), c_ptr(part))
    return y, h, mean, rstd


def norm_act_backward(g: torch.Tensor, h: torch.Tensor, ds: torch.Tensor,
                      mean: torch.Tensor, rstd: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor):
    """g and h (n, W), ds n, the forward's mean and rstd, weight and bias
    W → (d_out (n, W), d_r (n, W), d_weight (W,), d_bias (W,))."""
    if on_cpu(g, h, ds, mean, rstd, weight, bias):
        return _backward_plain(g, h, ds, mean, rstd, weight, bias)
    n, w = h.shape
    _check(n, w, (g, h), (mean, rstd, weight, bias), ds)
    g, h = _aligned(g), _aligned(h)
    f32 = dict(device=h.device, dtype=torch.float32)
    dh = torch.empty((n, w), **f32)
    d_out = torch.empty((n, w), **f32)
    d_weight = torch.empty((w,), **f32)
    d_bias = torch.empty((w,), **f32)
    part = _part(n, w, h.device)
    call(norm_act_backward, "norm_act_bwd", h, c_ptr(g), c_ptr(h), c_ptr(ds),
         c_ptr(mean), c_ptr(rstd), c_ptr(weight), c_ptr(bias), n, w,
         c_ptr(dh), c_ptr(d_out), c_ptr(d_weight), c_ptr(d_bias), c_ptr(part))
    return d_out, dh, d_weight, d_bias


norm_act_forward.launches = norm_act_backward.launches = 0
