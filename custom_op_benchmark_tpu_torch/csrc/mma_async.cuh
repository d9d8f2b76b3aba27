// Building blocks shared by the kernels for Hopper (sm_90a): asynchronous
// copies into shared memory (cp.async), f32-accurate tile products on the
// tensor cores (mma.sync m16n8k8 TF32 in three passes, "3xTF32"), native
// bf16 products (mma.sync m16n8k16 .bf16 fed by ldmatrix), and the row
// sweep's stage layout, fragment code and stores (K2, S4, S1, S2).
//
// Element types: the tile kernels take f32 or bf16 rows (one type per
// call), accumulate in f32 and store the input's type, rounding once. bf16
// rows move as bf16 (half the bytes). In bf16, K1-K4 (and so S1 and S2)
// take bf16 x bf16 products natively: m16n8k16 with .bf16 operands and f32
// accumulators, at twice TF32's rate, each fragment read from a bf16 stage
// by one ldmatrix (no widening, no conversion); a bf16 product is exact in
// f32. K4's P (f32) enters P V as two bf16 parts (split_bf16x2).
//
// 3xTF32: TF32 keeps 10 mantissa bits, so one pass of f32 operands rounded
// to TF32 is good to about 1e-3 relative, which misses the kernels' 1e-4
// gate. Each operand x is split as hi = rna_tf32(x), lo = rna_tf32(x - hi)
// (x - hi is exact in f32), and a * b is taken as lo*hi + hi*lo + hi*hi in
// f32 accumulators; the dropped lo*lo term is below 2^-22 of |a||b|. The
// hardware reads a raw f32 register given as TF32 by truncating it, so the
// rounding is explicit (cvt.rna: to nearest, ties away from zero).
// tests/test_torch_tf32_split.py emulates this arithmetic on the CPU.
//
// m16n8k8 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)
//                           a3 (g + 8, t + 4)
//   B (8 x 8, k x n):       b0 (t, g)   b1 (t + 4, g)
//   C (16 x 8):             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                           c3 (g + 8, 2t + 1)
// m16n8k16 fragments (".bf16"; each register holds two bf16, the lower
// column or k in the low half):
//   A (16 x 16): r0 (g, 2t..2t+1)  r1 (g + 8, 2t..)  r2 (g, 2t+8..)
//                r3 (g + 8, 2t+8..)
//   B (16 x 8):  r0 (k 2t..2t+1, n g)  r1 (k 2t+8..2t+9, n g)
//   C: as m16n8k8's.
// ldmatrix.x4 reads four 8 x 8 matrices of 16-byte rows, lanes 8i..8i+7
// giving the row addresses of matrix i, and hands lane l register i =
// matrix i's (l / 4, 2(l % 4)..+1); with .trans, (2(l % 4)..+1, l / 4). So
// one ldmatrix.x4 reads an A fragment (matrices: rows m / m + 8, columns k
// / k + 8), and one reads the B fragments of two n-tiles, with .trans from
// a stage whose rows are k (x in K2, y in K3, V in K4) or plain from one
// whose rows are n (B in K1, K in K4); K3's A (vals^T) comes by .trans
// from a stage whose rows are k. Each 8-address phase is conflict-free
// when its rows fall on distinct 16-byte bank groups: row strides of 80,
// 144 and 272 bytes.
// tests/test_torch_bf16_mma.py models these maps, addresses and banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

template <typename E>
constexpr bool is_f32 = sizeof(E) == 4;

// v rounded to E (to nearest even for bf16).
template <typename E>
__device__ __forceinline__ E from_f32(float v) {
  if constexpr (is_f32<E>)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// p[0], p[1] = x, y (p 2-element aligned).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1, features f0 .. f0 + W - 1 of a row-major
// array of E (row stride ld elements) into dst (row stride DLD elements),
// by the NT threads of a block; rows at or past n and features at or past
// d are filled with zeros. vec: 16-byte cp.async copies (W, f0, d, ld and
// DLD are multiples of 16 bytes' worth of elements and src is 16-byte
// aligned); else element copies: 4-byte cp.async for f32, plain loads and
// stores for bf16 (cp.async has no 2-byte size), visible after the next
// barrier.
template <int ROWS, int W, int DLD, int NT, typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* src,
                                          long long row0, long long n,
                                          int f0, int d, long long ld,
                                          int vec, int tid) {
  constexpr int PER = 16 / sizeof(E);  // elements per 16-byte copy
  if (vec) {
    for (int e = tid; e < ROWS * W / PER; e += NT) {
      const int r = e / (W / PER), f = (e % (W / PER)) * PER;
      const bool ok = row0 + r < n && f0 + f < d;
      cp_async16(dst + r * DLD + f, ok ? src + (row0 + r) * ld + f0 + f : src,
                 ok ? 16 : 0);
    }
  } else if constexpr (is_f32<E>) {
    for (int e = tid; e < ROWS * W; e += NT) {
      const int r = e / W, f = e % W;
      const bool ok = row0 + r < n && f0 + f < d;
      cp_async4(dst + r * DLD + f, ok ? src + (row0 + r) * ld + f0 + f : src,
                ok ? 4 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * W; e += NT) {
      const int r = e / W, f = e % W;
      const bool ok = row0 + r < n && f0 + f < d;
      dst[r * DLD + f] = ok ? src[(row0 + r) * ld + f0 + f] : from_f32<E>(0.f);
    }
  }
}

// A 128 x 128 tile's mask bytes into dst, row stride MASK_LD bytes (144:
// reading two bytes per row in the accumulator layout, c0 c1 at (g, 2t),
// hits distinct banks), 16-byte copies; src 16-byte aligned.
constexpr int MASK_LD = 144;

template <int NT>
__device__ __forceinline__ void load_mask(uint8_t* dst, const uint8_t* src,
                                          int tid) {
  for (int e = tid; e < 128 * 128 / 16; e += NT) {
    const int r = e / 8, c = (e % 8) * 16;
    cp_async16(dst + r * MASK_LD + c, src + r * 128 + c, 16);
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a * b on TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on bf16 operands (A 16 x 16, B 16 x 8), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of b16 from shared memory: this lane gives the
// address of row lane % 8 of matrix lane / 8 (16-byte aligned).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// x, y rounded to a bf16 pair hi (x in the low half) and the pair lo of
// what is left: x - hi is exact in f32, so hi + lo is x to 2^-16 of |x|,
// where one bf16 keeps 2^-8.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A's fragment (a0..a3 as above) split into hi and lo parts.
__device__ __forceinline__ void split_a(float a0, float a1, float a2,
                                        float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// 3xTF32: d += a * b, with both operands already split.
__device__ __forceinline__ void mma_3xtf32_parts(
    float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
    uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// 3xTF32: d += a * b, with A already split and B's f32 fragment (b0, b1).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_3xtf32_parts(d, ahi, alo, bh0, bh1, bl0, bl1);
}

// Split a staged ROWS x W block (row stride LD floats) in place into its
// TF32 hi parts, writing the lo parts to lo (same layout), by the NT
// threads of a block: done once, it spares every warp that reads a value
// as a B operand the three instructions of splitting it.
template <int ROWS, int W, int LD, int NT>
__device__ __forceinline__ void split_rows(float* x, float* lo, int tid) {
  for (int e = tid; e < ROWS * W / 4; e += NT) {
    const int o = (e / (W / 4)) * LD + (e % (W / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + o);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<float4*>(x + o) =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo + o) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// ---------------------------------------------------------------------------
// The row sweep's stage layout, fragment arithmetic and stores: K2 and S4
// (tiled_kernels.cu) and S1/S2 (grid_dma.cu) run the same code, so S2 at
// one head gives K2's bits.
// ---------------------------------------------------------------------------

constexpr int RS_ROWS = 128;   // tile rows
constexpr int RS_COLS = 64;    // tile columns (rows of x) per stage
constexpr int RS_STAGES = 3;

// Stage strides in elements: vals 4 mod 32 words for f32 (68), 72 for
// bf16 (144 bytes: 16-byte rows, and ldmatrix's 8 rows of a phase on
// distinct 16-byte bank groups); x DN + 8 (for bf16 272 or 144 bytes).
template <typename E, int DN>
struct RowCfg {
  static constexpr int VLD = is_f32<E> ? RS_COLS + 4 : RS_COLS + 8;
  static constexpr int XLD = DN + 8;
  static constexpr int STAGE = RS_ROWS * VLD + RS_COLS * XLD;  // elements
  static constexpr size_t SMEM = sizeof(E) * RS_STAGES * STAGE;
};

// One staged chunk of the row sweep (RS_COLS columns of a vals tile at vs,
// row stride VLD, and the matching RS_COLS rows of x after them, row
// stride XLD) into the accumulators of warp (wm, wn): vals rows 32 wm ..
// + 32 (two m16 tiles) times x features wn DN / 2 .. + DN / 2 (DN / 16 n8
// tiles). f32: 8-deep steps in 3xTF32, A split in registers (each used for
// DN / 16 fragments), B split in registers (each used for two). bf16:
// 16-deep steps of m16n8k16, one ldmatrix.x4 per A fragment and one
// ldmatrix.x4.trans per pair of B fragments (vals rows are m, x rows k).
template <typename E, int DN>
__device__ __forceinline__ void row_sweep_chunk(float (&acc)[2][DN / 16][4],
                                                const E* vs, int wm, int wn,
                                                int lane) {
  using C = RowCfg<E, DN>;
  constexpr int VLD = C::VLD, XLD = C::XLD, NI = DN / 16;
  const E* xs = vs + RS_ROWS * VLD;
  if constexpr (is_f32<E>) {
    const int g = lane / 4, t4 = lane % 4;
    const E* va = vs + (32 * wm + g) * VLD + t4;
    const E* xb = xs + t4 * XLD + wn * (DN / 2) + g;
#pragma unroll
    for (int ks = 0; ks < RS_COLS / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const E* a = va + 16 * mi * VLD + ks * 8;
        split_a(a[0], a[8 * VLD], a[4], a[8 * VLD + 4], ah[mi], al[mi]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const E* b = xb + ks * 8 * XLD + 8 * ni;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_3xtf32(acc[mi][ni], ah[mi], al[mi], b[0], b[4 * XLD]);
      }
    }
  } else {
    // This lane's ldmatrix row: row r8 + 8 * h8 of a 16-row slab, the
    // 8-column half q16 (A: matrices (m, k), (m + 8, k), (m, k + 8),
    // (m + 8, k + 8); x: (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)).
    const int r8 = lane % 8, h8 = (lane / 8) % 2, q16 = lane / 16;
    const E* va = vs + (32 * wm + r8 + 8 * h8) * VLD + 8 * q16;
    const E* xb = xs + (r8 + 8 * h8) * XLD + wn * (DN / 2) + 8 * q16;
#pragma unroll
    for (int ks = 0; ks < RS_COLS / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], va + 16 * mi * VLD + 16 * ks);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t b[4];
        ldsm_x4_trans(b, xb + 16 * ks * XLD + 16 * nj);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

// Warp (wm, wn)'s accumulators of the row block at output row r0 and
// feature f0 into out (row stride ld elements): rows below n_out and
// features below d only. bf16 stores a row's two values (c0 c1, c2 c3) as
// one 4-byte pair where both lie below d and the pair is 4-byte aligned,
// else each alone, so no byte past d is written.
template <typename E, int DN>
__device__ __forceinline__ void row_sweep_store(
    E* out, const float (&acc)[2][DN / 16][4], long long r0, int f0,
    long long n_out, int d, long long ld, int wm, int wn, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < DN / 16; ++ni) {
      if constexpr (is_f32<E>) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long r = r0 + 32 * wm + 16 * mi + g + (u >= 2 ? 8 : 0);
          const int f = f0 + wn * (DN / 2) + 8 * ni + 2 * t4 + (u & 1);
          if (r < n_out && f < d) out[r * ld + f] = acc[mi][ni][u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; u += 2) {
          const long long r = r0 + 32 * wm + 16 * mi + g + (u >= 2 ? 8 : 0);
          const int f = f0 + wn * (DN / 2) + 8 * ni + 2 * t4;
          if (r >= n_out || f >= d) continue;
          E* p = out + r * ld + f;
          if (f + 1 < d && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
            store2(p, acc[mi][ni][u], acc[mi][ni][u + 1]);
          } else {
            p[0] = from_f32<E>(acc[mi][ni][u]);
            if (f + 1 < d) p[1] = from_f32<E>(acc[mi][ni][u + 1]);
          }
        }
      }
    }
}

// d += a * b with B's fragment at offsets o0, o1 of a split block (hi, lo).
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const float* hi, const float* lo,
                                          int o0, int o1) {
  mma_3xtf32_parts(d, ahi, alo, __float_as_uint(hi[o0]),
                   __float_as_uint(hi[o1]), __float_as_uint(lo[o0]),
                   __float_as_uint(lo[o1]));
}
