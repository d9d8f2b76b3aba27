"""The DGL GAT's hidden-layer tail, ``ReLU(BN(out·ds + r))``, as one
autograd Function (``models/gat_dgl.py`` ``norm_act``) over the fused
passes of ``ops/kernels/norm_act.py`` (csrc/norm_act.cu).

On the CPU (the tier-1 run), where the Function runs the plain version:

- it equals ``BatchNorm1d(track_running_stats=False)`` and ReLU over
  ``out·ds + r``, forward and every gradient, in float64 and float32, at
  the cell's head layout and at ragged ones; ``gradcheck`` in float64;
- no gradient reaches ds, and the Function keeps h = out·ds + r, the
  columns' mean and rstd and its small inputs: no other tensor of n rows;
- CPU tensors never build or load the kernels and count no launch;
- the source agrees with the wrapper (its constants, the entry points)
  and adds without atomics; a group of rows fills whole 32-byte sectors;
  a row array off 16 bytes is copied; rows too wide for a group raise.

On the card (marker ``chip``, skipped without a CUDA device; run with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_norm_act.py``): the kernels against the plain version on
the same CUDA tensors at the cell's shape (169,343 × 3 × 250) and at
ragged ones (a short last group; h = 3, d = 7 and d = 4; rows off 16
bytes), forward and backward, the worst absolute error printed, and the
same bits on a repeat; a DGL GAT step counts two launches each way, an
``arxiv_gat`` step none; the kernels' device time lies in the
``gat_dgl.norm_act.fwd`` and ``.bwd`` spans.
"""

import re

import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import ProfilerActivity, profile, schedule

from custom_op_benchmark_tpu_torch.models import GAT, GATDGL
from custom_op_benchmark_tpu_torch.models.gat_dgl import norm_act
from custom_op_benchmark_tpu_torch.ops.ell import ell_dual
from custom_op_benchmark_tpu_torch.ops.kernels import _build
from custom_op_benchmark_tpu_torch.ops.kernels import norm_act as kn
from test_torch_ell_gat_kernel import _graph

EPS = 1e-5
ROWS = 4 * kn.MAX_BLOCKS  # rows the blocks take in one turn at W = 750
KERNELS = (kn.norm_act_forward, kn.norm_act_backward)


def _inputs(seed: int, n: int, h: int, d: int, dtype=torch.float64,
            device="cpu"):
    """out (n, h, d), ds (n, 1, 1) in [0.3, 3], r (n, h·d), weight, bias
    (h·d,), g (n, h·d), from numpy; r shifted so the columns' means sit
    off zero, bias so that ReLU cuts a column at several places."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    w = h * d
    return (t(rng.normal(size=(n, h, d))),
            t(rng.uniform(0.3, 3.0, size=(n, 1, 1))),
            t(rng.normal(size=(n, w)) + rng.normal(size=w) * 2),
            t(rng.uniform(0.5, 1.5, size=w)),
            t(rng.normal(size=w) * 0.5),
            t(rng.normal(size=(n, w))))


def _reference(out, ds, r, weight, bias):
    n = out.shape[0]
    bn = nn.BatchNorm1d(r.shape[1], eps=EPS, track_running_stats=False,
                        dtype=out.dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    y = F.relu(bn((out * ds).reshape(n, -1) + r))
    return y, bn


# (n, h, d): the cell's head layout at a small n, a ragged width, one row
# past a tile, one head.
SHAPES = [(200, 3, 250), (37, 3, 7), (ROWS + 1, 2, 5), (9, 1, 4)]


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("n, h, d", SHAPES)
def test_plain_equals_batch_norm_and_relu(n, h, d, dtype, tol):
    out, ds, r, weight, bias, g = _inputs(n + d, n, h, d, dtype)
    leaves = [t.clone().requires_grad_() for t in (out, r, weight, bias)]
    y = norm_act(leaves[0], ds, leaves[1], leaves[2], leaves[3], EPS)
    got = torch.autograd.grad(y, leaves, g)

    ref_leaves = [t.clone().requires_grad_() for t in (out, r)]
    want_y, bn = _reference(ref_leaves[0], ds, ref_leaves[1], weight, bias)
    want = torch.autograd.grad(want_y, ref_leaves + [bn.weight, bn.bias], g)
    assert 0 < float((want_y > 0).double().mean()) < 1

    def close(a, b, what):
        b = b.detach()
        assert a.shape == b.shape and a.dtype == b.dtype, what
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()), msg=what)

    close(y, want_y, "y")
    for name, a, b in zip(("out", "r", "weight", "bias"), got, want):
        close(a, b, name)


def test_gradcheck():
    out, ds, r, weight, bias, _ = _inputs(3, 11, 2, 3)
    leaves = tuple(t.requires_grad_() for t in (out, r, weight, bias))
    assert torch.autograd.gradcheck(
        lambda o, rr, wt, b: norm_act(o, ds, rr, wt, b, EPS), leaves)


def test_ds_takes_no_gradient_and_only_h_is_kept():
    n, h, d = 50, 3, 4
    out, ds, r, weight, bias, _ = _inputs(5, n, h, d)
    leaves = [t.requires_grad_() for t in (out, ds, r, weight, bias)]
    y = norm_act(*leaves, EPS)
    saved = y.grad_fn.saved_tensors
    rows = [t for t in saved if t.numel() >= n]
    assert [t.shape for t in rows] == [(n, h * d), (n, 1, 1)]
    assert torch.equal(rows[0], (out * ds).reshape(n, -1) + r)
    assert torch.equal(rows[1], ds)
    y.sum().backward()
    assert ds.grad is None
    assert all(t.grad is not None for t in (out, r, weight, bias))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path built or loaded the library")

    monkeypatch.setattr(_build, "library", refuse)
    before = [f.launches for f in KERNELS]
    out, ds, r, weight, bias, g = _inputs(7, 40, 3, 5, torch.float32)
    leaves = [t.requires_grad_() for t in (out, r, weight, bias)]
    y = norm_act(leaves[0], ds, leaves[1], leaves[2], leaves[3], EPS)
    y.backward(g)
    assert [f.launches for f in KERNELS] == before


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of t whose base lies k elements past an aligned
    allocation."""
    buf = t.new_empty(t.numel() + k)
    buf[k:].copy_(t.reshape(-1))
    return buf[k:].view(t.shape)


@pytest.mark.parametrize("w, rows", [(750, 4), (21, 8), (12, 2), (40, 1),
                                     (1, 8)])
def test_a_group_fills_whole_sectors(w, rows):
    assert kn.group_rows(w) == rows
    assert rows * w * 4 % 32 == 0
    assert all(k * w * 4 % 32 for k in range(1, rows))


@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_a_row_array_off_16_bytes_is_copied(offset):
    t = _offset(torch.arange(12.0).reshape(3, 4), offset)
    got = kn._aligned(t)
    assert torch.equal(got, t) and got.data_ptr() % 16 == 0
    assert (got is t) == (t.data_ptr() % 16 == 0)


def test_rows_too_wide_for_a_group_raise():
    n, w = 3, 1026  # 4 rows a group: 1,026 vectors, past MAX_THREADS
    rows = (torch.zeros(n, w),) * 2
    with pytest.raises(ValueError, match="16-byte vectors"):
        kn._check(n, w, rows, (torch.zeros(w),) * 2, torch.ones(n))
    kn._check(n, 1024, (torch.zeros(n, 1024),) * 2, (torch.zeros(1024),) * 2,
              torch.ones(n))


def test_the_source_agrees_with_the_wrapper():
    assert "norm_act.cu" in _build.SOURCES
    text = (_build.CSRC / "norm_act.cu").read_text()
    for name in ("MAX_BLOCKS", "MAX_THREADS"):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         text).group(1) == str(getattr(kn, name)), name
    # No atomic function (atomicAdd, atomicCAS, ...) and no PTX atom/red.
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.", text)
    for name in ("norm_act_fwd_f32", "norm_act_bwd_f32"):
        assert f"int {name}(" in text and name in _build._SIGNATURES
    assert kn._part(9, 750, "cpu").numel() == 3 * 4 * 2 * 750
    assert kn._part(10 ** 6, 21, "cpu").numel() == kn.MAX_BLOCKS * 8 * 2 * 21


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _kernels(out, ds, r, weight, bias, g):
    fwd = kn.norm_act_forward(out, ds, r, weight, bias, EPS)
    y, h, mean, rstd = fwd
    bwd = kn.norm_act_backward(g, h, ds, mean, rstd, weight, bias)
    torch.cuda.synchronize()
    return fwd, bwd


def _worst(got, want):
    """(the worst absolute error, the largest magnitude of want)."""
    return (float((got.double() - want.double()).abs().max()),
            float(want.abs().max()))


@pytest.mark.chip
@pytest.mark.parametrize("n, h, d, offset", [
    (169_343, 3, 250, 0),          # the cell's shape
    (3 * ROWS + 17, 3, 7, 0),      # a short last group, odd width
    (ROWS + 5, 3, 4, 0),           # two rows a group
    (2 * ROWS - 1, 3, 250, 1),     # rows off 16 bytes: copied
    (5, 3, 250, 0)])               # fewer rows than the blocks
def test_kernels_match_the_plain_path(cuda, n, h, d, offset):
    out, ds, r, weight, bias, g = _inputs(n % 1000 + d, n, h, d,
                                          torch.float32, cuda)
    out, r = _offset(out, offset), _offset(r, offset)
    before = [f.launches for f in KERNELS]
    (y, hh, mean, rstd), bwd = _kernels(out, ds, r, weight, bias, g)
    assert [f.launches - b for f, b in zip(KERNELS, before)] == [1, 1]

    want_y, want_h, want_mean, want_rstd = kn._forward_plain(
        out, ds, r, weight, bias, EPS)
    # The plain backward on the kernels' h, mean and rstd: the same mask.
    want_bwd = kn._backward_plain(g, hh, ds, mean, rstd, weight, bias)
    assert torch.equal(hh, want_h)
    report = {}
    for name, got, want, tol in (
            ("mean", mean, want_mean, 1e-5), ("rstd", rstd, want_rstd, 1e-5),
            ("y", y, want_y, 1e-5),
            *zip(("d_out", "d_r", "d_weight", "d_bias"), bwd, want_bwd,
                 (1e-5,) * 4)):
        assert got.shape == want.shape and got.dtype == torch.float32, name
        err, top = _worst(got, want)
        report[name] = (err, top)
        assert err <= tol * top, (name, err, top)
    print(f"\nnorm_act n={n} h={h} d={d} offset={offset}: worst abs error "
          + ", ".join(f"{k} {e:.2e} of {t:.3g}" for k, (e, t)
                      in report.items()))
    again = _kernels(out, ds, r, weight, bias, g)
    for a, b in zip((y, hh, mean, rstd) + tuple(bwd),
                    again[0] + tuple(again[1])):
        assert torch.equal(a, b)


def _dgl_step(cuda, seed=9):
    g = _graph(7, device=cuda)
    ell = ell_dual(g, profile="train")
    model = GATDGL(hidden_dim=250, out_dim=40, num_layers=3, num_heads=3,
                   in_dim=24, device=cuda)
    x = torch.randn(g.n_nodes, 24,
                    generator=torch.Generator().manual_seed(seed)).to(cuda)

    def step():
        model.zero_grad(set_to_none=True)
        model(g, x, ell=ell).square().sum().backward()
        torch.cuda.synchronize()

    return model, step


@pytest.mark.chip
def test_a_dgl_gat_step_counts_its_launches(cuda):
    model, step = _dgl_step(cuda)
    before = [f.launches for f in KERNELS]
    step()
    # Two hidden layers: one fused forward and one fused backward each.
    assert [f.launches - b for f, b in zip(KERNELS, before)] == [2, 2]
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.chip
def test_an_arxiv_gat_step_launches_none(cuda):
    g = _graph(7, device=cuda)
    ell = ell_dual(g, profile="train")
    model = GAT(hidden_dim=128, out_dim=40, num_layers=3, num_heads=4,
                in_dim=24, device=cuda)
    x = torch.randn(g.n_nodes, 24, device=cuda)
    before = [f.launches for f in KERNELS]
    model(g, x, ell=ell).square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in KERNELS] == before


@pytest.mark.chip
def test_the_kernels_device_time_lies_in_their_spans(cuda):
    """Each of the tail's kernels is listed under its launch range
    (``norm_act_fwd_f32``, ``norm_act_bwd_f32``), which opens inside
    ``gat_dgl.norm_act.fwd`` or ``.bwd``; both spans get device time.
    Profiled after a dropped warm-up cycle, as gnnbench's traced tail
    profiles."""
    _, step = _dgl_step(cuda)
    step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        step()
        prof.step()
        step()
        prof.step()
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    spans = [e for e in events if e.name.startswith("gat_dgl.norm_act.")]
    credited = {}
    for e in events:
        if e.name not in ("norm_act_fwd_f32", "norm_act_bwd_f32"):
            continue
        holders = [s.name for s in spans
                   if s.time_range.start <= e.time_range.start
                   <= s.time_range.end]
        assert holders == ["gat_dgl.norm_act." + e.name[9:12]], holders
        assert len(e.kernels) == 3, [k.name for k in e.kernels]
        credited[holders[0]] = (credited.get(holders[0], 0)
                                + sum(k.duration for k in e.kernels))
    assert sorted(credited) == ["gat_dgl.norm_act.bwd",
                                "gat_dgl.norm_act.fwd"], credited
    assert all(us > 0 for us in credited.values()), credited
