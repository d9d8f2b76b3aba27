// Building blocks shared by the kernels for Hopper (sm_90a): asynchronous
// copies into shared memory (cp.async), and f32-accurate tile products on
// the tensor cores (mma.sync m16n8k8 TF32 in three passes, "3xTF32").
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

#include <stdint.h>

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
