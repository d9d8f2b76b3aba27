"""The native bf16 tile products of K1-K4 (and S1, S2), modelled on the
CPU.

In bf16, K1 (``sddmm_tiles_bf16_kernel``), the row sweep shared by K2, S1
and S2 (``row_sweep_chunk`` in csrc/mma_async.cuh), K3
(``spmm_col_sweep_kernel``) and K4 (``attention_bf16_kernel``) take their
products as ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32``, every
fragment read from a bf16 stage in shared memory by one ``ldmatrix.x4``
(A where the stage's rows are m, B where they are n) or
``ldmatrix.x4.trans`` (where they are k: B in K2, K3 and K4's P·V, and
K3's A, valsᵀ); K4's P·V takes its A fragment from the score
accumulators, P as two bf16 parts. This file models in numpy the PTX
ISA's fragment maps of that mma and the registers ``ldmatrix`` hands each
lane, drives them with the lane addresses the kernels compute at their
stage strides, and checks that

- the fragments rebuild each tile product exactly (integer-valued bf16
  tiles, so every sum is exact in any order), with the stage padding and
  K1's features past d never read as anything but zero;
- two m16n8 accumulators of K4's scores are, in natural key order, the
  m16n8k16 A fragment of P·V;
- each 8-address phase of every ``ldmatrix`` falls on 8 distinct 16-byte
  bank groups (no conflict), which K1's old 32-element stride would not;
- K4's P split into bf16 hi and lo parts stays inside the per-element
  gate where outputs cancel to near 0, and one bf16 P does not;
- a conservative model of the tensor cores' f32 sums (each 16-product
  step's exact sum truncated toward zero before it is added) stays inside
  the kernels' bf16 gate against their plain versions, |kernel − plain| ≤
  2⁻⁷·|plain| + 1e-4, at K1's d = 1024, over K2's 8 tiles and over the
  longest column (K3) and row (K4) blocks of the slice and the grid.
"""

import numpy as np
import pytest

BF16_RTOL, ATOL = 2.0 ** -7, 1e-4   # the bf16 gate (chip_smoke.py)
TILE = 128
RS_COLS = 64                        # row sweep: tile columns per chunk
SD_KC = 32                          # K1: features per chunk
K2_VLD = RS_COLS + 8                # vals stage stride, bf16 (144 bytes)
K1_LD = SD_KC + 8                   # K1 stage stride, bf16 (80 bytes)
CS_ROWS = 64                        # K3: contraction rows per chunk
K3_VLD = TILE + 8                   # K3 vals stage stride (272 bytes)
CHUNK = 64                          # K4: features of K or V per chunk
K4_BLD = CHUNK + 8                  # K4 chunk stride (144 bytes)
# The longest column (K3) and row (K4) blocks, in tiles: the slice's
# transposed tile view of the 512×30 clique batch and the 1024×1024 grid's
# tile-aligned tiling (both directions alike in each).
LONGEST = {"slice": 3, "grid": 5}


def to_bf16(x):
    """Round to bf16 (to nearest, ties to even), kept as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def toward_zero(x):
    """float64 → float32, rounded toward zero."""
    f = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


# ---------------------------------------------------------------------------
# PTX ISA: "Matrix Fragments for mma.m16n8k16" (.bf16) and "ldmatrix"
# ---------------------------------------------------------------------------

LANES = np.arange(32)
G, T4 = LANES // 4, LANES % 4


def a_position(reg, half):
    """(row, column) of A (16 x 16) in each lane's register ``reg``,
    element ``half`` (0: low 16 bits)."""
    return G + 8 * (reg % 2), 2 * T4 + half + 8 * (reg // 2)


def b_position(reg, half):
    """(k, n) of B (16 x 8) in each lane's register ``reg``."""
    return 2 * T4 + half + 8 * reg, G


def c_position(i):
    """(row, column) of C (16 x 8) in each lane's accumulator ``i``."""
    return G + 8 * (i // 2), 2 * T4 + i % 2


def ldmatrix_x4(smem, addrs, trans=False):
    """The registers (32, 4, 2) ``ldmatrix.sync.aligned.m8n8.x4[.trans]
    .shared.b16`` hands each lane: lanes 8i .. 8i + 7 give the element
    offsets of the 8 rows (8 elements each) of matrix i; lane l receives
    matrix i's (l / 4, 2(l % 4) .. + 1), or with ``trans`` its
    (2(l % 4) .. + 1, l / 4)."""
    mats = smem[addrs[:, None] + np.arange(8)].reshape(4, 8, 8)
    if trans:
        mats = mats.transpose(0, 2, 1)
    pairs = 2 * T4[:, None] + np.arange(2)
    return mats[:, G[:, None], pairs].transpose(1, 0, 2)


def mma(a_regs, b_regs):
    """D = A·B (16 x 8, float64) from the lanes' A (32, 4, 2) and B
    (32, 2, 2) registers, returned per lane as (32, 4) accumulators; also
    the A and B the lanes hold."""
    a = np.full((16, 16), np.nan)
    b = np.full((16, 8), np.nan)
    for reg in range(4):
        for half in range(2):
            a[a_position(reg, half)] = a_regs[:, reg, half]
            if reg < 2:
                b[b_position(reg, half)] = b_regs[:, reg, half]
    d = a.astype(np.float64) @ b
    return np.stack([d[c_position(i)] for i in range(4)], axis=1), a, b


def lane_rows():
    """The kernels' per-lane ldmatrix row indices: r8 = lane % 8, h8 =
    lane / 8 % 2, q16 = lane / 16."""
    return LANES % 8, (LANES // 8) % 2, LANES // 16


# ---------------------------------------------------------------------------
# The kernels' addresses (element offsets into a stage)
# ---------------------------------------------------------------------------

def k2_a_addrs(vld, wm, mi, ks):
    r8, h8, q16 = lane_rows()
    return (32 * wm + r8 + 8 * h8) * vld + 8 * q16 + 16 * mi * vld + 16 * ks


def k2_b_addrs(vld, xld, dn, wn, ks, nj):
    r8, h8, q16 = lane_rows()
    return (TILE * vld + (r8 + 8 * h8) * xld + wn * (dn // 2) + 8 * q16
            + 16 * ks * xld + 16 * nj)


def k1_a_addrs(ld, warp, kk):
    r8, h8, q16 = lane_rows()
    return (warp * 16 + r8 + 8 * h8) * ld + 8 * q16 + 16 * kk


def k1_b_addrs(ld, p, kk):
    r8, h8, q16 = lane_rows()
    return TILE * ld + (r8 + 8 * q16) * ld + 8 * h8 + 16 * p * ld + 16 * kk


def k3_a_addrs(wm, mi, ks):
    """K3's A (valsᵀ) by ldmatrix.trans from the [r][c] vals stage:
    matrix i is stage rows (k) 8·(i // 2) .., columns (m) 8·(i % 2) .."""
    r8, h8, q16 = lane_rows()
    return (r8 + 8 * q16) * K3_VLD + 32 * wm + 8 * h8 + 16 * ks * K3_VLD \
        + 16 * mi


def k3_b_addrs(yld, dn, wn, ks, nj):
    r8, h8, q16 = lane_rows()
    return (CS_ROWS * K3_VLD + (r8 + 8 * h8) * yld + wn * (dn // 2)
            + 8 * q16 + 16 * ks * yld + 16 * nj)


def k4_q_addrs(qld, warp, c, kk):
    r8, h8, q16 = lane_rows()
    return (warp * 16 + r8 + 8 * h8) * qld + 8 * q16 + c * CHUNK + 16 * kk


def k4_k_addrs(p, kk):
    r8, h8, q16 = lane_rows()
    return (r8 + 8 * q16) * K4_BLD + 8 * h8 + 16 * p * K4_BLD + 16 * kk


def k4_v_addrs(m, nj):
    r8, h8, q16 = lane_rows()
    return (r8 + 8 * h8) * K4_BLD + 8 * q16 + 16 * m * K4_BLD + 16 * nj


def ints(rng, *shape):
    """Integer-valued bf16 operands: every product and sum is exact."""
    return rng.integers(-8, 9, size=shape).astype(np.float32)


def stage(blocks, n_elems):
    """A stage image of NaN (any read of padding shows in the result) with
    each (offset, rows x width block, row stride) written in."""
    smem = np.full(n_elems, np.nan, np.float32)
    for off, block, ld in blocks:
        for r in range(block.shape[0]):
            smem[off + r * ld: off + r * ld + block.shape[1]] = block[r]
    return smem


# ---------------------------------------------------------------------------
# The fragments rebuild the tile products exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dn", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_sweep_chunk_rebuilds_the_product(dn, seed):
    """One staged chunk of K2/S1/S2 (64 columns of a vals tile, the 64
    matching rows of x, strides 72 and DN + 8): every warp's m16n8k16
    products over ldmatrix / ldmatrix.trans fragments give vals · x."""
    rng = np.random.default_rng(seed)
    xld = dn + 8
    vals, x = ints(rng, TILE, RS_COLS), ints(rng, RS_COLS, dn)
    smem = stage([(0, vals, K2_VLD), (TILE * K2_VLD, x, xld)],
                 TILE * K2_VLD + RS_COLS * xld)
    out = np.full((TILE, dn), np.nan)
    for warp in range(8):
        wm, wn = warp // 2, warp % 2
        acc = np.zeros((2, dn // 16, 32, 4))
        for ks in range(RS_COLS // 16):
            a = [ldmatrix_x4(smem, k2_a_addrs(K2_VLD, wm, mi, ks))
                 for mi in range(2)]
            for nj in range(dn // 32):
                b = ldmatrix_x4(smem, k2_b_addrs(K2_VLD, xld, dn, wn, ks, nj),
                                trans=True)
                for mi in range(2):
                    for e in range(2):
                        d, fa, fb = mma(a[mi], b[:, 2 * e: 2 * e + 2])
                        m0, k0 = 32 * wm + 16 * mi, 16 * ks
                        n0 = wn * dn // 2 + 16 * nj + 8 * e
                        np.testing.assert_array_equal(
                            fa, vals[m0:m0 + 16, k0:k0 + 16])
                        np.testing.assert_array_equal(
                            fb, x[k0:k0 + 16, n0:n0 + 8])
                        acc[mi, 2 * nj + e] += d
        for mi in range(2):
            for ni in range(dn // 16):
                for i in range(4):
                    r, c = c_position(i)
                    out[32 * wm + 16 * mi + r,
                        wn * dn // 2 + 8 * ni + c] = acc[mi, ni, :, i]
    np.testing.assert_array_equal(out, vals.astype(np.float64) @ x)


@pytest.mark.parametrize("d", [33, 40, 64, 200])
def test_k1_fragments_rebuild_the_scores(d):
    """K1 in bf16 on one tile: A's and B's rows (128 each, d features)
    staged 32 features a chunk at stride 40, zero past d (the copy's fill)
    and NaN in the padding; ceil(d / 16) steps of m16n8k16 over ldmatrix
    fragments give A · Bᵀ, each 16-deep step summed apart."""
    rng = np.random.default_rng(d)
    a_rows, b_rows = ints(rng, TILE, d), ints(rng, TILE, d)
    n_chunks, kd = -(-d // SD_KC), -(-d // 16)
    scores = np.zeros((TILE, TILE))
    for c in range(n_chunks):
        feats = slice(c * SD_KC, min(d, (c + 1) * SD_KC))
        width = feats.stop - feats.start
        blk_a = np.zeros((TILE, SD_KC), np.float32)
        blk_b = np.zeros((TILE, SD_KC), np.float32)
        blk_a[:, :width], blk_b[:, :width] = a_rows[:, feats], b_rows[:, feats]
        smem = stage([(0, blk_a, K1_LD), (TILE * K1_LD, blk_b, K1_LD)],
                     2 * TILE * K1_LD)
        kend = min(SD_KC // 16, kd - c * (SD_KC // 16))
        for warp in range(8):
            for kk in range(kend):
                a = ldmatrix_x4(smem, k1_a_addrs(K1_LD, warp, kk))
                for p in range(TILE // 16):
                    b = ldmatrix_x4(smem, k1_b_addrs(K1_LD, p, kk))
                    for e in range(2):
                        s, _, _ = mma(a, b[:, 2 * e: 2 * e + 2])
                        for i in range(4):
                            r, col = c_position(i)
                            scores[warp * 16 + r,
                                   16 * p + 8 * e + col] += s[:, i]
    np.testing.assert_array_equal(scores, a_rows.astype(np.float64) @ b_rows.T)


@pytest.mark.parametrize("dn", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_k3_fragments_rebuild_the_product(dn, seed):
    """One staged chunk of K3 (64 contraction rows of a vals tile [r][c] at
    stride 136 and the matching 64 rows of y at DN + 8): every warp's
    m16n8k16 products over ldmatrix.trans fragments, A read as valsᵀ from
    the [r][c] stage, give valsᵀ · y."""
    rng = np.random.default_rng(seed)
    yld = dn + 8
    vals, y = ints(rng, CS_ROWS, TILE), ints(rng, CS_ROWS, dn)
    smem = stage([(0, vals, K3_VLD), (CS_ROWS * K3_VLD, y, yld)],
                 CS_ROWS * K3_VLD + CS_ROWS * yld)
    out = np.full((TILE, dn), np.nan)
    for warp in range(8):
        wm, wn = warp // 2, warp % 2
        acc = np.zeros((2, dn // 16, 32, 4))
        for ks in range(CS_ROWS // 16):
            a = [ldmatrix_x4(smem, k3_a_addrs(wm, mi, ks), trans=True)
                 for mi in range(2)]
            for nj in range(dn // 32):
                b = ldmatrix_x4(smem, k3_b_addrs(yld, dn, wn, ks, nj),
                                trans=True)
                for mi in range(2):
                    for e in range(2):
                        d, fa, fb = mma(a[mi], b[:, 2 * e: 2 * e + 2])
                        m0, k0 = 32 * wm + 16 * mi, 16 * ks
                        n0 = wn * dn // 2 + 16 * nj + 8 * e
                        np.testing.assert_array_equal(
                            fa, vals[k0:k0 + 16, m0:m0 + 16].T)
                        np.testing.assert_array_equal(
                            fb, y[k0:k0 + 16, n0:n0 + 8])
                        acc[mi, 2 * nj + e] += d
        for mi in range(2):
            for ni in range(dn // 16):
                for i in range(4):
                    r, c = c_position(i)
                    out[32 * wm + 16 * mi + r,
                        wn * dn // 2 + 8 * ni + c] = acc[mi, ni, :, i]
    np.testing.assert_array_equal(out, vals.T.astype(np.float64) @ y)


def k4_scores(q, k_rows, D, d):
    """K4's QKᵀ for one tile as each warp's accumulators (8, 16, 32, 4):
    Q resident at stride D + 8, K staged 64 features a chunk at stride 72
    (zero past d, NaN in the padding), ceil(d / 16) steps of m16n8k16."""
    qld, kd = D + 8, -(-d // 16)
    qs = np.zeros((TILE, D), np.float32)
    qs[:, :d] = q
    qsmem = stage([(0, qs, qld)], TILE * qld)
    s = np.zeros((8, TILE // 8, 32, 4))
    for c in range(D // CHUNK):
        chunk = np.zeros((TILE, CHUNK), np.float32)
        width = max(0, min(CHUNK, d - c * CHUNK))
        chunk[:, :width] = k_rows[:, c * CHUNK: c * CHUNK + width]
        ksmem = stage([(0, chunk, K4_BLD)], TILE * K4_BLD)
        kend = min(CHUNK // 16, kd - c * (CHUNK // 16))
        for warp in range(8):
            for kk in range(kend):
                a = ldmatrix_x4(qsmem, k4_q_addrs(qld, warp, c, kk))
                for p in range(TILE // 16):
                    b = ldmatrix_x4(ksmem, k4_k_addrs(p, kk))
                    for e in range(2):
                        s[warp, 2 * p + e] += mma(a, b[:, 2 * e: 2 * e + 2])[0]
    return s


@pytest.mark.parametrize("D, d", [(64, 64), (64, 33), (128, 100),
                                  (128, 128)])
def test_k4_fragments_rebuild_the_scores(D, d):
    """K4 in bf16 on one tile: ldmatrix of Q's rows (resident, stride
    D + 8) and of K's rows (keys, not transposed) give Q · Kᵀ."""
    rng = np.random.default_rng(D + d)
    q, k_rows = ints(rng, TILE, d), ints(rng, TILE, d)
    s = k4_scores(q, k_rows, D, d)
    got = np.full((TILE, TILE), np.nan)
    for warp in range(8):
        for j in range(TILE // 8):
            for i in range(4):
                r, c = c_position(i)
                got[warp * 16 + r, 8 * j + c] = s[warp, j, :, i]
    np.testing.assert_array_equal(got, q.astype(np.float64) @ k_rows.T)


def pv_a_fragment(s, m):
    """The m16n8k16 A registers (32, 4, 2) K4 hands P·V for keys 16m ..
    16m + 15: the accumulators of n-tiles 2m and 2m + 1, in order."""
    lo, hi = s[2 * m], s[2 * m + 1]
    return np.stack([lo[:, 0:2], lo[:, 2:4], hi[:, 0:2], hi[:, 2:4]],
                    axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_accumulators_feed_pv_in_key_order(seed):
    """A warp's 16 × 128 P in its m16n8 accumulators feeds P·V with no
    permutation: two neighbouring accumulators are the A fragment of 16
    keys in natural order, and V's chunk (keys × 64 features, stride 72)
    gives the B fragments by ldmatrix.trans; the products rebuild P·V."""
    rng = np.random.default_rng(seed)
    p, v = ints(rng, 16, TILE), ints(rng, TILE, CHUNK)
    s = np.zeros((TILE // 8, 32, 4))
    for j in range(TILE // 8):
        for i in range(4):
            r, c = c_position(i)
            s[j, :, i] = p[r, 8 * j + c]
    vsmem = stage([(0, v, K4_BLD)], TILE * K4_BLD)
    acc = np.zeros((CHUNK // 8, 32, 4))
    for m in range(TILE // 16):
        a = pv_a_fragment(s, m)
        for nj in range(CHUNK // 16):
            b = ldmatrix_x4(vsmem, k4_v_addrs(m, nj), trans=True)
            for e in range(2):
                d, fa, fb = mma(a, b[:, 2 * e: 2 * e + 2])
                np.testing.assert_array_equal(fa, p[:, 16 * m: 16 * m + 16])
                np.testing.assert_array_equal(
                    fb, v[16 * m: 16 * m + 16,
                          16 * nj + 8 * e: 16 * nj + 8 * e + 8])
                acc[2 * nj + e] += d
    out = np.full((16, CHUNK), np.nan)
    for n in range(CHUNK // 8):
        for i in range(4):
            r, c = c_position(i)
            out[r, 8 * n + c] = acc[n, :, i]
    np.testing.assert_array_equal(out, p.astype(np.float64) @ v)


def split_hi_lo(p):
    """K4's split_bf16x2: hi = bf16(p), lo = bf16(p − hi) (exact in f32)."""
    hi = to_bf16(p)
    return hi, to_bf16((p - hi).astype(np.float32))


def gate(kernel, plain):
    return np.abs(kernel - plain) <= BF16_RTOL * np.abs(plain) + ATOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k4_p_goes_as_two_bf16_parts(seed):
    """Why P enters P·V as hi + lo: outputs Σ p·v / l that cancel to near 0
    (V of both signs) keep the per-element gate, |kernel − plain| ≤
    2⁻⁷·|plain| + 1e-4, with the split P (error at most 2⁻¹⁶·p), and miss
    it with one bf16 P (2⁻⁸·p) on many of them. The plain version multiplies
    the f32 P; both round the output to bf16 once."""
    rng = np.random.default_rng(seed)
    rows, keys, feats = 64, TILE, 64
    sc = rng.standard_normal((rows, keys)).astype(np.float32) * 3
    p = np.exp(sc - sc.max(1, keepdims=True)).astype(np.float32)
    l = p.astype(np.float64).sum(1, keepdims=True)
    v = to_bf16(rng.standard_normal((keys, feats), dtype=np.float32))
    # Each output column cancels: the key of p = 1 (each row's max) takes
    # the value that balances the others, rounded to bf16.
    top = p.argmax(1)
    v_rows = np.repeat(v[None], rows, 0)
    for r in range(rows):
        others = np.delete(np.arange(keys), top[r])
        v_rows[r, top[r]] = to_bf16(-(p[r, others].astype(np.float64)
                                      @ v[others]).astype(np.float32))
    exact = np.einsum("rk,rkf->rf", p.astype(np.float64), v_rows) / l
    plain = to_bf16(exact.astype(np.float32)).astype(np.float64)
    hi, lo = split_hi_lo(p)
    split = (np.einsum("rk,rkf->rf", lo.astype(np.float64), v_rows)
             + np.einsum("rk,rkf->rf", hi.astype(np.float64), v_rows)) / l
    one = np.einsum("rk,rkf->rf", hi.astype(np.float64), v_rows) / l
    assert np.abs(exact).max() < 1e-2          # outputs near 0
    assert gate(to_bf16(split.astype(np.float32)), plain).all()
    missed = ~gate(to_bf16(one.astype(np.float32)), plain)
    assert missed.mean() > 0.1, missed.mean()
    assert (np.abs((hi.astype(np.float64) + lo) - p)
            <= 2.0 ** -16 * p).all()


# ---------------------------------------------------------------------------
# Bank groups of every ldmatrix phase
# ---------------------------------------------------------------------------

def _calls(kind, ld):
    """Every ldmatrix of one stage: (lane element offsets) per call."""
    if kind == "K2 A":
        return [k2_a_addrs(ld, wm, mi, ks) for wm in range(4)
                for mi in range(2) for ks in range(RS_COLS // 16)]
    if kind.startswith("K2 x"):
        dn = ld - 8
        return [k2_b_addrs(K2_VLD, ld, dn, wn, ks, nj) for wn in range(2)
                for ks in range(RS_COLS // 16) for nj in range(dn // 32)]
    if kind == "K1 A":
        return [k1_a_addrs(ld, w, kk) for w in range(8) for kk in range(2)]
    if kind == "K1 B":
        return [k1_b_addrs(ld, p, kk) for p in range(8) for kk in range(2)]
    if kind == "K3 A":
        return [k3_a_addrs(wm, mi, ks) for wm in range(4) for mi in range(2)
                for ks in range(CS_ROWS // 16)]
    if kind.startswith("K3 y"):
        dn = ld - 8
        return [k3_b_addrs(ld, dn, wn, ks, nj) for wn in range(2)
                for ks in range(CS_ROWS // 16) for nj in range(dn // 32)]
    if kind.startswith("K4 Q"):
        return [k4_q_addrs(ld, w, c, kk) for w in range(8)
                for c in range((ld - 8) // CHUNK) for kk in range(4)]
    if kind == "K4 K":
        return [k4_k_addrs(p, kk) for p in range(8) for kk in range(4)]
    return [k4_v_addrs(m, nj) for m in range(8) for nj in range(4)]


def _phases_conflict_free(ld, kind):
    for addrs in _calls(kind, ld):
        nbytes = 2 * addrs
        assert (nbytes % 16 == 0).all()
        for phase in nbytes.reshape(4, 8):
            if len(set((phase // 16) % 8)) != 8:
                return False
    return True


@pytest.mark.parametrize("kind, ld", [
    ("K2 A", K2_VLD), ("K2 x DN=64", 64 + 8), ("K2 x DN=128", 128 + 8),
    ("K1 A", K1_LD), ("K1 B", K1_LD), ("K3 A", K3_VLD),
    ("K3 y DN=64", 64 + 8), ("K3 y DN=128", 128 + 8), ("K4 Q D=64", 64 + 8),
    ("K4 Q D=128", 128 + 8), ("K4 K", K4_BLD), ("K4 V", K4_BLD)])
def test_ldmatrix_phases_hit_distinct_bank_groups(kind, ld):
    """Each 8-address phase of ldmatrix reads 8 rows of 16 bytes: at the
    kernels' strides (144, 272 and 80 bytes) the rows fall on the 8
    distinct 16-byte groups of the 32 banks, so no phase waits."""
    assert _phases_conflict_free(ld, kind)


@pytest.mark.parametrize("kind", ["K1 A", "K1 B"])
def test_unpadded_k1_stage_conflicts(kind):
    """Why K1's bf16 stage is padded: at 32 elements (64 bytes) a phase's
    8 rows fall on 2 bank groups, 4 rows each."""
    assert not _phases_conflict_free(SD_KC, kind)


# ---------------------------------------------------------------------------
# The tensor cores' f32 sums against the bf16 gate
# ---------------------------------------------------------------------------

def truncated_sum(a, b, apart):
    """a (M, K) @ b (K, N) as the kernels run it in bf16: 16-deep steps
    whose exact sum is truncated toward zero to f32; K1 (``apart``) adds
    each truncated step to its accumulator in f32 (to nearest), K2 lets the
    tensor core truncate the accumulator plus the step."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        step = a[:, k0:k0 + 16].astype(np.float64) @ b[k0:k0 + 16]
        if apart:
            acc = acc + toward_zero(step)
        else:
            acc = toward_zero(acc.astype(np.float64) + step)
    return acc


@pytest.mark.parametrize("depth, apart", [
    pytest.param(1024, True, id="K1-d1024"),
    pytest.param(200, True, id="K1-d200"),
    pytest.param(64, True, id="K1-d64"),
    pytest.param(3 * TILE, False, id="K2-3-tiles"),
    pytest.param(8 * TILE, False, id="K2-8-tiles"),
    pytest.param(LONGEST["slice"] * TILE, False, id="K3-slice"),
    pytest.param(LONGEST["grid"] * TILE, False, id="K3-grid")])
@pytest.mark.parametrize("seed", [0, 1])
def test_truncated_sums_stay_within_the_bf16_gate(depth, apart, seed):
    """bf16 x bf16 products are exact in f32; what the kernel adds that its
    plain version (f32 sums, one rounding to bf16) does not is the tensor
    cores' truncation. Modelled at each 16-deep step, it stays inside
    |kernel − plain| ≤ 2⁻⁷·|plain| + 1e-4 at K1's, K2's and K3's depths
    (K3: the longest column block of the slice and of the grid), on
    standard normal bf16 operands."""
    rng = np.random.default_rng(seed)
    a = to_bf16(rng.standard_normal((128, depth), dtype=np.float32))
    b = to_bf16(rng.standard_normal((depth, 64), dtype=np.float32))
    exact = a.astype(np.float64) @ b
    plain = to_bf16(exact.astype(np.float32)).astype(np.float64)
    kernel = to_bf16(truncated_sum(a, b, apart)).astype(np.float64)
    assert (np.abs(kernel - plain) <= BF16_RTOL * np.abs(plain) + ATOL).all()
    if apart:
        # Summed apart (K1), the truncation stays under the gate's floor,
        # so an output that cancels to near zero passes too.
        f32 = truncated_sum(a, b, apart).astype(np.float64)
        assert np.abs(f32 - exact).max() <= ATOL


def k4_truncated(q, k, v, scale, apart):
    """K4 in bf16 over a row block's tiles as the kernel sums them: QKᵀ
    per tile in truncated 16-deep steps (``apart``: the cluster form's
    steps summed apart), the online softmax in f32 (exp2 of log2 units),
    acc rescaled by each tile's correction, then per 16 keys lo·v and
    hi·v each truncated into acc; out = acc / l."""
    rows = q.shape[0]
    m = np.full((rows, 1), -1e9 * np.log2(np.e), np.float32)
    l = np.zeros((rows, 1), np.float32)
    acc = np.zeros((rows, v.shape[1]), np.float32)
    s2 = np.float32(scale * np.log2(np.e))
    for t0 in range(0, k.shape[0], TILE):
        s = truncated_sum(q, k[t0:t0 + TILE].T, apart) * s2
        m_new = np.maximum(m, s.max(1, keepdims=True))
        corr = np.exp2(m - m_new).astype(np.float32)
        p = np.exp2(s - m_new).astype(np.float32)
        m = m_new
        l = l * corr + p.sum(1, keepdims=True, dtype=np.float32)
        acc = acc * corr
        hi, lo = split_hi_lo(p)
        for k0 in range(0, TILE, 16):
            vk = v[t0 + k0: t0 + k0 + 16].astype(np.float64)
            acc = toward_zero(acc.astype(np.float64) + lo[:, k0:k0 + 16] @ vk)
            acc = toward_zero(acc.astype(np.float64) + hi[:, k0:k0 + 16] @ vk)
    return acc / l


@pytest.mark.parametrize("graph", ["slice", "grid"])
@pytest.mark.parametrize("d, apart", [(64, False), (128, False),
                                      (200, True)])
def test_k4_truncated_sums_stay_within_the_bf16_gate(graph, d, apart):
    """K4's P·V accumulates in the mma across every tile of a row block,
    and its resident QKᵀ across d: modelled with truncation at each
    16-deep step over the longest row block of the slice (3 tiles) and of
    the grid (5), every key an edge, the bf16 output stays inside the gate
    against the plain version (f64 scores, f32 softmax, one rounding)."""
    rng = np.random.default_rng(d)
    keys = LONGEST[graph] * TILE
    q = to_bf16(rng.standard_normal((64, d), dtype=np.float32))
    k = to_bf16(rng.standard_normal((keys, d), dtype=np.float32))
    v = to_bf16(rng.standard_normal((keys, 64), dtype=np.float32))
    scale = d ** -0.5
    kernel = to_bf16(k4_truncated(q, k, v, scale, apart).astype(np.float32))
    s = q.astype(np.float64) @ k.T * scale
    p = np.exp(s - s.max(1, keepdims=True))
    plain = to_bf16((p @ v / p.sum(1, keepdims=True)).astype(np.float32))
    assert gate(kernel.astype(np.float64), plain.astype(np.float64)).all()


def test_to_bf16_rounds_to_nearest_even():
    ulp = 2.0 ** -7                      # bf16's spacing in [1, 2)
    x = np.array([1 + ulp / 2, 1 + 1.5 * ulp, 1 + ulp / 2 + 2.0 ** -20,
                  -(1 + ulp / 2), 3.0], np.float32)
    want = np.array([1.0, 1 + 2 * ulp, 1 + ulp, -1.0, 3.0], np.float32)
    np.testing.assert_array_equal(to_bf16(x), want)
    assert not (to_bf16(x).view(np.uint32) & 0xFFFF).any()
