"""The 3xTF32 arithmetic of the tensor-core kernels, emulated on the CPU.

K3 (``spmm_col_sweep``) and K4 (``fused_attention_rows`` for d ≤ 128) run
their tile products as ``mma.sync`` m16n8k8 TF32 in three passes
(csrc/mma_async.cuh): each f32 operand x is split as
``hi = rna_tf32(x)``, ``lo = rna_tf32(x − hi)``, and each 8-deep step adds
``lo·hi``, then ``hi·lo``, then ``hi·hi`` to f32 accumulators. This file
emulates that in numpy and shows that it stays within 1e-6 of float64
(relative to the largest |value|) at the kernels' contraction depths, while
one TF32 pass misses the kernels' 1e-4 gate against their plain versions.
"""

import numpy as np
import pytest

from custom_op_benchmark_tpu_torch.ops.kernels.attention import kernel_route

# K3 contracts over a tile's 128 rows; K4 over the head width d (scores)
# and a tile's 128 keys (P·V).
DEPTHS = [pytest.param(128, id="K3-tile-128"), pytest.param(33, id="K4-d33"),
          pytest.param(40, id="K4-d40"), pytest.param(64, id="K4-d64"),
          pytest.param(128, id="K4-d128"), pytest.param(256, id="K4-d256")]
KERNEL_RTOL = KERNEL_ATOL = 1e-4   # the kernels' gate against plain versions


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round an f32 to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits of the pattern become 0)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    hi = rna_tf32(x)
    return hi, rna_tf32(np.float32(x) - hi)


def mma_passes(a: np.ndarray, b: np.ndarray, passes) -> np.ndarray:
    """a (M, K) @ b (K, N) as the kernels run it: 8-deep steps, each adding
    the listed (A part, B part) products to an f32 accumulator. A TF32
    product is exact in float64, and the tensor core rounds each step's sum
    to f32."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for pa, pb in passes:
            step = pa[:, k0:k0 + 8].astype(np.float64) @ pb[k0:k0 + 8]
            acc = (acc + step).astype(np.float32)
    return acc


def three_pass(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return mma_passes(a, b, [(al, bh), (ah, bl), (ah, bh)])


def one_pass(a, b):
    return mma_passes(a, b, [(rna_tf32(a), rna_tf32(b))])


def _operands(depth, seed, m=64, n=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, depth), dtype=np.float32),
            rng.standard_normal((depth, n), dtype=np.float32))


def test_rna_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10                   # TF32's spacing in [1, 2)
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                  1 + 1.5 * ulp, 3.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0], np.float32)
    np.testing.assert_array_equal(rna_tf32(x), want)
    assert not (rna_tf32(x).view(np.uint32) & 0x1FFF).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_keeps_22_bits(seed):
    """hi + lo recovers x to 2^-22 of |x|: what the dropped lo·lo term and
    the rounding of lo can lose."""
    x = np.random.default_rng(seed).standard_normal(4096, dtype=np.float32)
    hi, lo = split(x)
    err = np.abs(x.astype(np.float64) - hi - lo)
    assert (err <= 2.0 ** -22 * np.abs(x)).all()


@pytest.mark.parametrize("depth", DEPTHS)
def test_three_passes_stay_within_1e6_of_float64(depth):
    a, b = _operands(depth, seed=depth)
    want = a.astype(np.float64) @ b
    err = np.abs(three_pass(a, b) - want).max() / np.abs(want).max()
    assert err <= 1e-6, err


@pytest.mark.parametrize("depth", DEPTHS)
def test_one_pass_misses_the_kernel_gate(depth):
    """Why the kernels pay for three passes: one TF32 pass is off by about
    3e-4 of the largest value, outside rtol = atol = 1e-4."""
    a, b = _operands(depth, seed=depth)
    want = (a.astype(np.float64) @ b).astype(np.float32)
    got = one_pass(a, b)
    assert not np.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    assert np.abs(got - want).max() / np.abs(want).max() > 1e-4


@pytest.mark.parametrize("d, route", [(1, "mma"), (33, "mma"), (40, "mma"),
                                      (64, "mma"), (128, "mma"),
                                      (129, "rows"), (200, "rows"),
                                      (256, "rows")])
def test_k4_width_route(d, route):
    """K4 runs on the tensor-core kernel up to d = 128; wider heads take the
    CUDA-core kernel that S5 runs."""
    assert kernel_route(d) == route
