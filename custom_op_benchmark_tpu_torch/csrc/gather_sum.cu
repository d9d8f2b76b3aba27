// ELL copy-sum (row gather and sum) for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel S3 of scripts/exp_pallas_gather.py:
//   gather_sum  <- pallas_gather_sum
//     y[r, :] = sum_{k < D} x[cols[r, k], :]
//   with cols (R, D) int32, x (n_x, d), y (R, d). A slot whose column lies
//   outside [0, n_x) adds zero, so the ELL pad column n_nodes needs no
//   padded row of x. This is the per-bucket sweep of the ELL copy-SpMM
//   (ops/ell.py _copy_agg_raw), forward and backward.
//
// What the TPU kernel did, and what is kept: it gathered the rows of 8
// output rows into VMEM through a 16-deep ring of row DMAs and reduced
// them there. What is kept is its function and its memory behaviour: each
// neighbour row is read once from memory and never written back; there is
// no (R, D, d) intermediate, which the plain version writes and reads
// again.
//
// What bounds it on this card: bytes. Each slot reads one row of d floats
// (512 bytes at d = 128) and adds it: 1 FLOP per 4 bytes. The row reads
// are random, so the rate is set by how many of them are in flight; x
// itself often fits the 50 MB L2 (67 MB at n = 131,072, d = 128, mostly).
//
// What the design does about it: one warp owns one output row and one
// chunk of its features (128 floats as float4 per lane when rows are
// 16-byte aligned, else 32 floats one per lane). The warp loads 32 column
// ids at once, coalesced, and broadcasts them with shuffles; it then issues
// the row loads of 4 slots before it adds them, so each warp keeps 4 rows
// in flight and an SM with 64 warps about 256. The slots are summed in
// their order k = 0, 1, ..., D-1 in f32 registers with a compensated
// (Kahan) sum: a plain running sum loses about sqrt(D) roundings, 4.6e-4
// on a power-law hub row of D = 8192 against a tree-summed reference,
// while the compensated sum stays within a few roundings of the exact sum
// at any D; the extra adds cost nothing against the row loads. Every run
// gives the same bits, and no atomics are used (the warp owns its
// outputs). Any R (the TPU kernel needed R % 8 == 0) and any d >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 4;

// s += v, carrying the rounding error of each add in c (Kahan).
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <bool VEC>
struct Chunk;

template <>
struct Chunk<true> {
  static constexpr int WIDTH = 128;   // 32 lanes x float4
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void add(T& s, T& c, const T& v) {
    kahan_add(s.x, c.x, v.x);
    kahan_add(s.y, c.y, v.y);
    kahan_add(s.z, c.z, v.z);
    kahan_add(s.w, c.w, v.w);
  }
  __device__ static void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static constexpr int PER_LANE = 4;
};

template <>
struct Chunk<false> {
  static constexpr int WIDTH = 32;    // 32 lanes x 1 float
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void add(T& s, T& c, const T& v) { kahan_add(s, c, v); }
  __device__ static void store(float* p, const T& v) { *p = v; }
  static constexpr int PER_LANE = 1;
};

// One warp per (row r, feature chunk c): tasks r * n_chunks + c.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const int* __restrict__ cols, const float* __restrict__ x,
                  float* __restrict__ y, int R, int D, int d, int n_x,
                  int n_chunks) {
  using C = Chunk<VEC>;
  const int lane = threadIdx.x & 31;
  const long long task =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= (long long)R * n_chunks) return;   // whole warp leaves
  const long long r = task / n_chunks;
  const int f = (int)(task % n_chunks) * C::WIDTH + lane * C::PER_LANE;
  const bool active = f < d;
  const int* row_cols = cols + r * D;

  typename C::T acc = C::zero(), carry = C::zero();
  for (int k0 = 0; k0 < D; k0 += 32) {
    const int kn = min(32, D - k0);
    const int mine = lane < kn ? row_cols[k0 + lane] : -1;
    int j = 0;
    for (; j + UNROLL <= kn; j += UNROLL) {
      typename C::T v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = __shfl_sync(FULL, mine, j + u);
        v[u] = (active && (unsigned)c < (unsigned)n_x)
                   ? C::load(x + (size_t)c * d + f)
                   : C::zero();
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) C::add(acc, carry, v[u]);
    }
    for (; j < kn; ++j) {
      const int c = __shfl_sync(FULL, mine, j);
      if (active && (unsigned)c < (unsigned)n_x)
        C::add(acc, carry, C::load(x + (size_t)c * d + f));
    }
  }
  if (active) C::store(y + r * d + f, acc);
}

template <bool VEC>
int launch(const int* cols, const float* x, float* y, int R, int D, int d,
           int n_x, cudaStream_t stream) {
  const int n_chunks = (d + Chunk<VEC>::WIDTH - 1) / Chunk<VEC>::WIDTH;
  const long long tasks = (long long)R * n_chunks;
  const long long blocks = (tasks + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gather_sum_kernel<VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      cols, x, y, R, D, d, n_x, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cols (R, D) int32, x (n_x, d) f32 -> y (R, d) f32. vec: x and y rows are
// 16-byte aligned (d % 4 == 0 and aligned base pointers). R > 0, d > 0.
int gather_sum_f32(const int* cols, const float* x, float* y, int R, int D,
                   int d, int n_x, int vec, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  return vec ? launch<true>(cols, x, y, R, D, d, n_x, stream)
             : launch<false>(cols, x, y, R, D, d, n_x, stream);
}

}  // extern "C"
