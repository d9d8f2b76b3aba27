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
    assert len(_build._SIGNATURES["gather_sum_f32"]) == 17


@pytest.mark.parametrize("r, k, n, d", [(16, 16, 100, 128), (24, 5, 70, 33),
                                        (8, 40, 60, 4)])
def test_bf16_plain_matches_the_pallas_kernel(r, k, n, d):
    """S3 in bf16, as the TPU kernel runs in x.dtype: the plain version
    sums the bf16 rows in f32 and rounds once, within one bf16 rounding
    (2⁻⁷ of the value, over a floor of 1e-3 of the largest) of
    ``pallas_gather_sum(interpret=True)`` on bf16 x; no launch counted."""
    cols, x = _inputs(d + 7, r, k, n, d)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_gather.pallas_gather_sum(
        jnp.asarray(cols), xb, interpret=True).astype(jnp.float32))
    before = (k_gather.gather_sum.launches, k_gather.gather_sum.launches_bf16)
    got = k_gather.gather_sum(torch.from_numpy(cols),
                              torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert (k_gather.gather_sum.launches,
            k_gather.gather_sum.launches_bf16) == before
    got = got.float().numpy()
    tol = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all()
    # One rounding: the f32 sum of the bf16 rows, rounded to bf16.
    exact = np.asarray(xb.astype(jnp.float32))[cols].sum(1)
    np.testing.assert_array_equal(
        got, torch.from_numpy(exact).bfloat16().float().numpy())


def test_the_build_knows_the_bf16_kernel():
    assert (_build._SIGNATURES["gather_sum_bf16"]
            == _build._SIGNATURES["gather_sum_f32"])
    assert "gather_sum_bf16" in (_build.CSRC / "gather_sum.cu").read_text()
    assert k_gather.gather_sum.launches_bf16 >= 0


@pytest.fixture(scope="module")
def powerlaw_ladders():
    from custom_op_benchmark_tpu_torch.graph import random_graph
    from custom_op_benchmark_tpu_torch.ops import ell_dual

    g = random_graph(600, 6000, seed=2, power_law=True)
    return g, {"pow2": ell_dual(g), "train": ell_dual(g, profile="train")}


@pytest.mark.parametrize("ladder", ["pow2", "train"])
@pytest.mark.parametrize("direction", [0, 1])
def test_gather_table_in_numpy(powerlaw_ladders, ladder, direction):
    """The table S3 sweeps in one launch: buckets widest first, each with
    its real rows only (owner < n) in packing order, slots concatenated,
    every node once as a summed row or a zero row; task t of the kernel
    (rows × chunks, then zero rows) is row t // chunks."""
    _, ladders = powerlaw_ladders
    eg = ladders[ladder][direction]
    tab = eg.gather_table
    assert eg.gather_table is tab                    # built once, cached
    n = eg.n_nodes
    b = tab.buckets.numpy()
    widths = b[:, 1]
    assert (np.diff(widths) < 0).all()               # widest first
    want_cols, want_nodes = [], []
    for w in widths:
        (bk,) = [x for x in eg.buckets if x.width == w]
        real = bk.rows.numpy() < n
        want_cols.append(bk.cols.numpy()[real].reshape(-1))
        want_nodes.append(bk.rows.numpy()[real])
    np.testing.assert_array_equal(tab.cols.numpy(), np.concatenate(want_cols))
    np.testing.assert_array_equal(tab.nodes.numpy(),
                                  np.concatenate(want_nodes))
    rows = np.array([len(c) for c in want_nodes])
    np.testing.assert_array_equal(b[:, 2], np.r_[0, np.cumsum(rows)[:-1]])
    np.testing.assert_array_equal(b[:, 0],
                                  np.r_[0, np.cumsum(rows * widths)[:-1]])
    named = np.sort(np.r_[tab.nodes.numpy(), tab.zero_nodes.numpy()])
    np.testing.assert_array_equal(named, np.arange(n))
    g = powerlaw_ladders[0]
    indptr = g.indptr_r if eg.direction == "src" else g.indptr_c
    deg = np.diff(indptr.numpy()[: n + 1])
    np.testing.assert_array_equal(np.sort(tab.zero_nodes.numpy()),
                                  np.flatnonzero(deg == 0))
    np.testing.assert_array_equal(eg.row_degree.numpy(), deg)
    # The kernel's task → (row, bucket) lookup, in numpy.
    chunks = 2
    for task in (0, 1, chunks * len(tab.nodes) - 1):
        row = task // chunks
        bucket = np.searchsorted(b[:, 2], row, side="right") - 1
        assert b[bucket, 2] <= row
        assert bucket == len(b) - 1 or row < b[bucket + 1, 2]


@pytest.mark.parametrize("ladder", ["pow2", "train"])
def test_copy_sum_plain_path_is_unchanged(powerlaw_ladders, ladder):
    """On the CPU the table's plain version gives the bits of the
    per-bucket sums assembled through row_pos, both directions."""
    from custom_op_benchmark_tpu_torch.ops.ell import (
        _copy_agg_raw,
        ell_combine_rows,
    )

    g, ladders = powerlaw_ladders
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(g.n_nodes, 33)).astype(np.float32))
    for eg in ladders[ladder]:
        old = ell_combine_rows(eg, [k_gather.gather_sum_plain(b.cols, x)
                                    for b in eg.buckets])
        assert torch.equal(_copy_agg_raw(eg, x), old)


def test_copy_spmm_mean_uses_the_cached_degree(powerlaw_ladders, monkeypatch):
    """reduce="mean" divides by the packing's cached degree: one copy-sum,
    and the degree S3 once computed at width 1, bit for bit."""
    from custom_op_benchmark_tpu_torch.ops import ell
    from custom_op_benchmark_tpu_torch.ops.ell import ell_copy_spmm

    g, ladders = powerlaw_ladders
    se, de = ladders["train"]
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(g.n_nodes, 16)).astype(np.float32))
    calls = []
    real = ell.gather_sum

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(ell, "gather_sum", counted)
    y = ell_copy_spmm(de, se, x, reduce="mean")
    assert len(calls) == 1
    deg = real(de.gather_table, torch.ones(g.n_nodes, 1))
    want = real(de.gather_table, x) / deg.clamp(min=1)
    assert torch.equal(y, want)


def test_one_bucket_table_is_the_experiment_form():
    cols, x = _inputs(9, 40, 6, 50, 12)
    from custom_op_benchmark_tpu_torch.graph.ell import one_bucket_table

    table = one_bucket_table(torch.from_numpy(cols))
    assert table.buckets.tolist() == [[0, 6, 0]] and table.n_out == 40
    assert torch.equal(k_gather.gather_sum(table, torch.from_numpy(x)),
                       k_gather.gather_sum(torch.from_numpy(cols),
                                           torch.from_numpy(x)))
