"""The 3xTF32 arithmetic of the tensor-core kernels, emulated on the CPU.

K1–K4 (K4 for d ≤ 128) run their tile products as ``mma.sync`` m16n8k8
TF32 in three passes (csrc/mma_async.cuh): each f32 operand x is split as
``hi = rna_tf32(x)``, ``lo = rna_tf32(x − hi)``, and each 8-deep step adds
``lo·hi``, then ``hi·lo``, then ``hi·hi`` to f32 accumulators; K1 takes
each step's three products into a zeroed fragment and adds that to its
accumulator in f32. This file emulates that in numpy and shows that it
stays within 1e-6 of float64 (relative to the largest |value|) at the
kernels' contraction depths, while one TF32 pass misses the kernels' 1e-4
gate against their plain versions; and that K1's skip of 16×8 score
fragments with no edge changes no output.
"""

import numpy as np
import pytest
import torch

from custom_op_benchmark_tpu_torch.ops.kernels.attention import kernel_route
from custom_op_benchmark_tpu_torch.ops.kernels.tiled_kernels import (
    sddmm_tiles_plain,
)

# (contraction depth, whether each step is summed apart as K1 does). K1
# contracts over the head width d (1024: the SpMM backward's dvals at the
# bench width); K2 over 128 columns of each of a row block's tiles (3 at
# most on the slice's tile view, 8 for a denser row); K3 over a tile's 128
# rows; K4 over d (scores) and a tile's 128 keys (P·V).
DEPTHS = [pytest.param((128, False), id="K3-tile-128"),
          pytest.param((33, False), id="K4-d33"),
          pytest.param((40, False), id="K4-d40"),
          pytest.param((64, False), id="K4-d64"),
          pytest.param((128, False), id="K4-d128"),
          pytest.param((256, False), id="K4-d256"),
          *(pytest.param((d, True), id=f"K1-d{d}")
            for d in (33, 40, 64, 128, 1024)),
          pytest.param((3 * 128, False), id="K2-3-tiles"),
          pytest.param((8 * 128, False), id="K2-8-tiles")]
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


def mma_passes(a: np.ndarray, b: np.ndarray, passes,
               apart: bool = False) -> np.ndarray:
    """a (M, K) @ b (K, N) as the kernels run it: 8-deep steps, each adding
    the listed (A part, B part) products to an f32 accumulator or, with
    ``apart``, to a zeroed fragment then added to the accumulator in f32.
    A TF32 product is exact in float64, and the tensor core rounds each
    step's sum to f32."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        frag = np.zeros_like(acc) if apart else acc
        for pa, pb in passes:
            step = pa[:, k0:k0 + 8].astype(np.float64) @ pb[k0:k0 + 8]
            frag = (frag + step).astype(np.float32)
        acc = (acc + frag).astype(np.float32) if apart else frag
    return acc


def three_pass(a, b, apart=False):
    (ah, al), (bh, bl) = split(a), split(b)
    return mma_passes(a, b, [(al, bh), (ah, bl), (ah, bh)], apart)


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
    depth, apart = depth
    a, b = _operands(depth, seed=depth)
    want = a.astype(np.float64) @ b
    err = np.abs(three_pass(a, b, apart) - want).max() / np.abs(want).max()
    assert err <= 1e-6, err


@pytest.mark.parametrize("depth", DEPTHS)
def test_one_pass_misses_the_kernel_gate(depth):
    """Why the kernels pay for three passes: one TF32 pass is off by about
    3e-4 of the largest value, outside rtol = atol = 1e-4."""
    depth, _ = depth
    a, b = _operands(depth, seed=depth)
    want = (a.astype(np.float64) @ b).astype(np.float32)
    got = one_pass(a, b)
    assert not np.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    assert np.abs(got - want).max() / np.abs(want).max() > 1e-4


@pytest.mark.parametrize("d, route", [(1, "mma"), (33, "mma"), (40, "mma"),
                                      (64, "mma"), (128, "mma"),
                                      (129, "wide"), (200, "wide"),
                                      (256, "wide"), (257, "wide"),
                                      (300, "wide"), (1024, "wide")])
def test_k4_width_route(d, route):
    """K4 runs on the tensor-core kernel at every width: Q resident up to
    d = 128, the wide form (scores recomputed per 128 output features)
    above; no width takes the plain version."""
    assert kernel_route(d) == route


def live_fragments(mask: np.ndarray) -> np.ndarray:
    """K1's flags (csrc/tiled_kernels.cu ``live_fragments``), (T, 8, 16):
    lane 2j + half of warp w ORs rows 16w + 8·half .. + 7 of columns
    8j .. 8j + 7, and fragment j of warp w is live where either lane's
    ballot bit is set."""
    t = mask.shape[0]
    lanes = mask.reshape(t, 8, 2, 8, 16, 8).any(axis=(3, 5))  # (T, w, half, j)
    return lanes.any(axis=2)


@pytest.mark.parametrize("p_live", [0.0, 0.3, 1.0])
def test_k1_fragment_skip_changes_nothing(p_live):
    """Zeroing the products of the fragments K1 skips, then selecting with
    the mask, gives ``sddmm_tiles_plain``'s output bit for bit."""
    rng = np.random.default_rng(5)
    t, n, d = 4, 384, 16
    live = rng.random((t, 8, 1, 16, 1)) < p_live
    mask = live & (rng.random((t, 8, 16, 16, 8)) < 0.3)
    mask = mask.reshape(t, 128, 128)
    rows = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    cols = torch.tensor([1, 0, 2, 1], dtype=torch.int32)
    a = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    want = sddmm_tiles_plain(rows, cols, torch.from_numpy(mask), a, b)
    flags = live_fragments(mask)
    np.testing.assert_array_equal(
        flags, mask.reshape(t, 8, 16, 16, 8).any(axis=(2, 4)))
    full = sddmm_tiles_plain(rows, cols, torch.ones(t, 128, 128,
                                                     dtype=torch.bool), a, b)
    keep = torch.from_numpy(np.repeat(np.repeat(flags, 16, 1), 8, 2))
    skipped = torch.where(keep, full, 0.0)
    got = torch.where(torch.from_numpy(mask), skipped, 0.0)
    assert torch.equal(got, want)
