// Building blocks shared by the kernels for Hopper (sm_90a): asynchronous
// copies into shared memory (cp.async), and f32-accurate tile products on
// the tensor cores (mma.sync m16n8k8 TF32 in three passes, "3xTF32").
//
// Element types: the tile kernels take f32 or bf16 rows (one type per
// call), accumulate in f32 and store the input's type, rounding once. A
// bf16 value widened to f32 is exact in TF32 (8 significant bits against
// TF32's 11, the same exponent range), so its TF32 "lo" part is zero: a
// product of two bf16 operands takes one TF32 pass instead of three, and
// an f32 operand times a bf16 one takes two (lo*b + hi*b). bf16 rows move
// as bf16 (half the bytes) and are widened to f32 where f32 rows are split
// into TF32 parts: in shared memory (widen_rows, beside split_rows) or in
// registers (to_f32 at the fragment read).
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

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

template <typename E>
constexpr bool is_f32 = sizeof(E) == 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

// Widen a staged ROWS x W block of bf16 (row stride SLD elements, even)
// into f32 (row stride DLD floats, a multiple of 4), by the NT threads of
// a block; W is a multiple of 4.
template <int ROWS, int W, int SLD, int DLD, int NT>
__device__ __forceinline__ void widen_rows(float* dst, const bf16* src,
                                           int tid) {
  for (int e = tid; e < ROWS * W / 4; e += NT) {
    const int r = e / (W / 4), c = (e % (W / 4)) * 4;
    const __nv_bfloat162* s2 =
        reinterpret_cast<const __nv_bfloat162*>(src + r * SLD + c);
    const float2 a = __bfloat1622float2(s2[0]);
    const float2 b = __bfloat1622float2(s2[1]);
    *reinterpret_cast<float4*>(dst + r * DLD + c) =
        make_float4(a.x, a.y, b.x, b.y);
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

// The raw bits of an f32 value that is exact in TF32 (a widened bf16).
__device__ __forceinline__ uint32_t exact_tf32(float x) {
  return __float_as_uint(x);
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

// d += a * b with A split (hi, lo) and B exact in TF32 (bh0, bh1): the two
// passes lo*b + hi*b.
__device__ __forceinline__ void mma_2xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bh0, uint32_t bh1) {
  mma_tf32(d, alo, bh0, bh1);
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
