"""The operation and byte counters against counts made by hand."""

import pytest

from gnnbench import counts
from gnnbench.reference import gat, sage

ARXIV = dict(in_dim=128, hidden_dim=128, num_heads=4, num_layers=3,
             out_dim=40)
REDDIT = dict(in_dim=602, hidden_dim=128, num_layers=2, out_dim=41)


def test_dense_and_step():
    assert counts.dense(2, 3, 5) == 60
    assert counts.step_flops(10.0) == 30.0


def test_bound_takes_the_larger():
    t, by = counts.bound_s(67e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "operations")
    t, by = counts.bound_s(1.0, 3.35e12)
    assert (t, by) == (pytest.approx(1.0), "bytes")


def test_gat_forward_flops_by_hand():
    n, e = 10, 30
    # Layer 0: 128 → 4 × 128, no residual; layer 1: 512 → 4 × 128 with the
    # identity residual (no W_res); layer 2: 512 → 1 × 40.
    by_hand = 0.0
    for k, h, d in ((128, 4, 128), (512, 4, 128), (512, 1, 40)):
        by_hand += 2 * n * k * h * d          # W
        by_hand += 2 * 2 * n * h * d          # el and er
        by_hand += 5 * e * h                  # score and softmax
        by_hand += 2 * e * h * d              # weighted sum
    assert gat.forward_flops(ARXIV, n, e) == by_hand


def test_gat_w_res_counted_where_widths_differ():
    m = dict(ARXIV, in_dim=128, num_layers=3)
    m_res = dict(m, num_heads=2)   # hidden layers 256 wide; layer 1 in 256
    assert gat.layer_shapes(m_res)[1][0] == 256
    assert gat.forward_flops(m_res, 1, 0) > 0
    # A residual whose input width differs from h·d adds its own product.
    m_odd = dict(in_dim=8, hidden_dim=4, num_heads=1, num_layers=3,
                 out_dim=2)
    shapes = gat.layer_shapes(m_odd)
    assert shapes == [(8, 1, 4, False, True), (4, 1, 4, True, True),
                      (4, 1, 2, False, False)]


def test_gat_mp_counts_by_hand():
    n, e, h, d = 10, 30, 4, 128
    fwd = 4 * n * h * d + 5 * e * h + 2 * e * h * d
    node = n * h * d * 4
    edges = 2 * e * 4
    assert gat.mp_counts(n, e, h, d) == (3 * fwd, 5 * node + 2 * edges)


def test_sage_forward_flops_by_hand():
    n, e = 7, 20
    by_hand = (2 * 2 * n * 602 * 128 + (e + n) * 602
               + 2 * 2 * n * 128 * 41 + (e + n) * 128)
    assert sage.forward_flops(REDDIT, n, e) == by_hand


def test_sage_mp_counts_by_hand():
    n, e, d = 7, 20, 128
    ops, nbytes = sage.mp_counts(n, e, d)
    assert ops == 2 * (e + n) * d
    assert nbytes == 2 * (2 * n * d * 4 + (e + n) * 4)
