// ELL copy-sum (row gather and sum) for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel S3 of scripts/exp_pallas_gather.py:
//   gather_sum  <- pallas_gather_sum
//     y[r, :] = sum_{k < D} x[cols[r, k], :]
//   with cols (R, D) int32, x (n_x, d), y (R, d). A slot whose column lies
//   outside [0, n_x) adds zero, so the ELL pad column n_nodes needs no
//   padded row of x. This is the sweep of the ELL copy-SpMM (ops/ell.py
//   _copy_agg_raw), forward and backward.
//
// One launch sums every bucket of an ELL packing (graph/ell.py
// GatherTable): the table lists per bucket, widest first, the offset of
// its rows' slots in cols, its width D and its first row; nodes[row] is
// the output row a row's sum goes to, and zero_nodes the output rows with
// nothing to sum (nodes of degree 0), which the same launch writes as 0.
// So the per-bucket launches, the concatenation of their outputs and the
// gather through row_pos that assembled the node rows are gone: each sum
// is written once, straight to its node's row.
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
// What the design does about it: one warp owns one row and one chunk of
// its features (128 floats as float4 per lane when rows are 16-byte
// aligned, else 32 floats one per lane). Warp tasks are numbered over the
// table's rows (times the chunks) in table order, so the long rows of the
// widest buckets (hub rows of up to 8,192 slots) start first instead of
// finishing last; the zero rows come after them. Each block copies the
// table (at most 64 buckets) into shared memory, and each warp finds its
// bucket there. The warp loads 32 column ids at once, coalesced, and
// broadcasts them with shuffles; it then issues the row loads of 4 slots
// before it adds them, so each warp keeps 4 rows in flight and an SM with
// 64 warps about 256. The slots are summed in their order k = 0, 1, ...,
// D-1 in f32 registers with a compensated (Kahan) sum: a plain running sum
// loses about sqrt(D) roundings, 4.6e-4 on a power-law hub row of D = 8192
// against a tree-summed reference, while the compensated sum stays within
// a few roundings of the exact sum at any D; the extra adds cost nothing
// against the row loads. A row's sum is the same sequence of operations as
// in the earlier one-launch-per-bucket kernel, so the results are the same
// bits. Every run gives the same bits, and no atomics are used (a warp
// owns its outputs, and each output row is named once). Any R and any
// d >= 1.
//
// bf16 (gather_sum_bf16): x and y are bf16, as the TPU kernel runs in
// x.dtype. Rows are read as bf16 (half the bytes of f32: the bound halves)
// and widened to f32, which is exact; the Kahan sum runs in f32 exactly as
// above, and each sum is rounded to bf16 once, at the store (to nearest
// even). The vector path moves 4 bf16 a lane as one 8-byte load, so a
// warp's 32 lanes still cover 128 features; it needs d % 4 == 0 and
// 8-byte aligned rows, else one bf16 a lane. The f32 path is unchanged
// (same operations, same bits).

// CSR entry (csr_sum): y[r, :] = sum_{k in [ptr[r], ptr[r+1])} x[idx[k], :]
// with idx optional (the identity: slot k reads row k). This is S3's
// function over a CSR row range instead of an ELL table: the sorted
// segment sum of the segment ops (ops/xla.py segment_sum, with idx the
// CSC permutation on the dst side), the copy forms of gspmm (idx = the
// other endpoint, so the (E, d) message never reaches memory) and the
// backward of the sampled copy-sum (ops/sampled.py). It needs no padding
// and no table build, which matters where a sampled batch brings a new
// graph every step. Each row is one warp's chain in slot order with
// S3's compensated sum (row_sum), so every run gives the same bits and
// no atomics are used: it replaces index_add_, whose atomics on the card
// add in an order that changes from run to run. Bound: bytes, as S3 (one
// row of x read per slot, each output row written once); its longest
// row sets a floor of one warp's chain, as S3's hub rows do.

#include <cuda_bf16.h>
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

using bf16 = __nv_bfloat16;

// A bf16 value's bits widened to f32 (exact): they are the high half.
__device__ __forceinline__ float widen(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// Four f32 sums a lane (vector path) or one (scalar path); E is the
// element type of x and y, the sums are f32 either way.
struct Vec4 {
  static constexpr int WIDTH = 128;   // 32 lanes x 4 elements
  static constexpr int PER_LANE = 4;
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& s, T& c, const T& v) {
    kahan_add(s.x, c.x, v.x);
    kahan_add(s.y, c.y, v.y);
    kahan_add(s.z, c.z, v.z);
    kahan_add(s.w, c.w, v.w);
  }
};

struct Vec1 {
  static constexpr int WIDTH = 32;    // 32 lanes x 1 element
  static constexpr int PER_LANE = 1;
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& s, T& c, const T& v) { kahan_add(s, c, v); }
};

template <typename E, bool VEC>
struct Chunk;

template <>
struct Chunk<float, true> : Vec4 {
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Chunk<float, false> : Vec1 {
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, const T& v) { *p = v; }
};

template <>
struct Chunk<bf16, true> : Vec4 {
  __device__ static T load(const bf16* p) {   // one 8-byte load
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(raw.x << 16),
                       __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16),
                       __uint_as_float(raw.y & 0xffff0000u));
  }
  __device__ static void store(bf16* p, const T& v) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    q[0] = __floats2bfloat162_rn(v.x, v.y);
    q[1] = __floats2bfloat162_rn(v.z, v.w);
  }
};

template <>
struct Chunk<bf16, false> : Vec1 {
  __device__ static T load(const bf16* p) {
    return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  __device__ static void store(bf16* p, const T& v) {
    *p = __float2bfloat16_rn(v);
  }
};

constexpr int MAX_BUCKETS = 64;

// The sum over slots 0 .. D-1 of row_cols of x's rows, at feature f of
// this lane (active: f < d), in slot order, compensated, in f32. Without
// IDX the slots name the rows base, base + 1, ... of x themselves (the
// CSR sum over edge data, csr_sum below); the arithmetic is the same.
template <typename E, bool VEC, bool IDX = true>
__device__ __forceinline__ typename Chunk<E, VEC>::T row_sum(
    const int* __restrict__ row_cols, int D, const E* __restrict__ x,
    int d, int n_x, int f, bool active, int lane, int base = 0) {
  using C = Chunk<E, VEC>;
  typename C::T acc = C::zero(), carry = C::zero();
  for (int k0 = 0; k0 < D; k0 += 32) {
    const int kn = min(32, D - k0);
    const int mine =
        lane < kn ? (IDX ? row_cols[k0 + lane] : base + k0 + lane) : -1;
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
  return acc;
}

// One warp per task: (row, feature chunk) for the table's rows in order,
// then (zero row, feature chunk).
template <typename E, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const int* __restrict__ table, int n_buckets,
                  const int* __restrict__ cols, const int* __restrict__ nodes,
                  int n_rows, const int* __restrict__ zero_nodes, int n_zero,
                  const E* __restrict__ x, E* __restrict__ y, int d,
                  int n_x, int n_chunks) {
  using C = Chunk<E, VEC>;
  __shared__ int tab[3 * MAX_BUCKETS];  // col offset, D, first row
  for (int e = threadIdx.x; e < 3 * n_buckets; e += THREADS) tab[e] = table[e];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long task =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long row_tasks = (long long)n_rows * n_chunks;
  if (task >= row_tasks + (long long)n_zero * n_chunks) return;
  const int f = (int)(task % n_chunks) * C::WIDTH + lane * C::PER_LANE;
  const bool active = f < d;
  if (task >= row_tasks) {
    const int node = zero_nodes[(task - row_tasks) / n_chunks];
    if (active) C::store(y + (size_t)node * d + f, C::zero());
    return;
  }
  const int row = (int)(task / n_chunks);
  int b = 0;
  while (b + 1 < n_buckets && tab[3 * (b + 1) + 2] <= row) ++b;
  const int D = tab[3 * b + 1];
  const int* row_cols = cols + tab[3 * b] + (size_t)(row - tab[3 * b + 2]) * D;
  const typename C::T acc =
      row_sum<E, VEC>(row_cols, D, x, d, n_x, f, active, lane);
  if (active) C::store(y + (size_t)nodes[row] * d + f, acc);
}

template <typename E, bool VEC>
int launch(const int* table, int n_buckets, const int* cols,
           const int* nodes, int n_rows, const int* zero_nodes, int n_zero,
           const E* x, E* y, int d, int n_x, cudaStream_t stream) {
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  const int n_chunks =
      (d + Chunk<E, VEC>::WIDTH - 1) / Chunk<E, VEC>::WIDTH;
  const long long tasks = ((long long)n_rows + n_zero) * n_chunks;
  const long long blocks = (tasks + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) return 0;
  gather_sum_kernel<E, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      table, n_buckets, cols, nodes, n_rows, zero_nodes, n_zero, x, y, d,
      n_x, n_chunks);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const int* table, int n_buckets, const int* cols,
             const int* nodes, int n_rows, const int* zero_nodes, int n_zero,
             const E* x, E* y, int d, int n_x, int vec, int device,
             cudaStream_t stream) {
  cudaSetDevice(device);
  return vec ? launch<E, true>(table, n_buckets, cols, nodes, n_rows,
                               zero_nodes, n_zero, x, y, d, n_x, stream)
             : launch<E, false>(table, n_buckets, cols, nodes, n_rows,
                                zero_nodes, n_zero, x, y, d, n_x, stream);
}

// CSR sum (csr_sum): one warp per task (row, feature chunk), rows in
// order; row r sums the slots ptr[r] .. ptr[r+1]-1 with row_sum, so a row
// of any length is one warp's chain in slot order, the same operations
// as an ELL row of S3 with no padded slot.
template <typename E, bool VEC, bool IDX>
__global__ void __launch_bounds__(THREADS)
csr_sum_kernel(const int* __restrict__ ptr, int n_rows,
               const int* __restrict__ idx, const E* __restrict__ x,
               E* __restrict__ y, int d, int n_x, int n_chunks) {
  using C = Chunk<E, VEC>;
  const int lane = threadIdx.x & 31;
  const long long task =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= (long long)n_rows * n_chunks) return;
  const int row = (int)(task / n_chunks);
  const int f = (int)(task % n_chunks) * C::WIDTH + lane * C::PER_LANE;
  const bool active = f < d;
  const int lo = ptr[row];
  const int D = ptr[row + 1] - lo;
  const typename C::T acc = row_sum<E, VEC, IDX>(
      IDX ? idx + lo : nullptr, D, x, d, n_x, f, active, lane, lo);
  if (active) C::store(y + (size_t)row * d + f, acc);
}

template <typename E, bool VEC>
int launch_csr(const int* ptr, int n_rows, const int* idx, const E* x,
               E* y, int d, int n_x, cudaStream_t stream) {
  const int n_chunks =
      (d + Chunk<E, VEC>::WIDTH - 1) / Chunk<E, VEC>::WIDTH;
  const long long tasks = (long long)n_rows * n_chunks;
  const long long blocks = (tasks + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) return 0;
  if (idx)
    csr_sum_kernel<E, VEC, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ptr, n_rows, idx, x, y, d, n_x, n_chunks);
  else
    csr_sum_kernel<E, VEC, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ptr, n_rows, idx, x, y, d, n_x, n_chunks);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_csr(const int* ptr, int n_rows, const int* idx, const E* x,
                 E* y, int d, int n_x, int vec, int device,
                 cudaStream_t stream) {
  cudaSetDevice(device);
  return vec ? launch_csr<E, true>(ptr, n_rows, idx, x, y, d, n_x, stream)
             : launch_csr<E, false>(ptr, n_rows, idx, x, y, d, n_x, stream);
}

}  // namespace

extern "C" {

// table (n_buckets, 3) int32, cols int32, nodes (n_rows,) int32,
// zero_nodes (n_zero,) int32, x (n_x, d) f32 -> y (n_out, d) f32, every
// row of y named once by nodes or zero_nodes. vec: x and y rows are
// 16-byte aligned (d % 4 == 0 and aligned base pointers). d > 0.
int gather_sum_f32(const int* table, int n_buckets, const int* cols,
                   const int* nodes, int n_rows, const int* zero_nodes,
                   int n_zero, const float* x, float* y, int d, int n_x,
                   int vec, int device, cudaStream_t stream) {
  return dispatch<float>(table, n_buckets, cols, nodes, n_rows, zero_nodes,
                         n_zero, x, y, d, n_x, vec, device, stream);
}

// The same in bf16: x (n_x, d) bf16 -> y (n_out, d) bf16, sums in f32,
// rounded once. vec: d % 4 == 0 and 8-byte aligned base pointers.
int gather_sum_bf16(const int* table, int n_buckets, const int* cols,
                    const int* nodes, int n_rows, const int* zero_nodes,
                    int n_zero, const bf16* x, bf16* y, int d, int n_x,
                    int vec, int device, cudaStream_t stream) {
  return dispatch<bf16>(table, n_buckets, cols, nodes, n_rows, zero_nodes,
                        n_zero, x, y, d, n_x, vec, device, stream);
}

// ptr (n_rows + 1,) int32, sorted; idx int32 naming a row of x for each
// slot, or null for the identity (slot k reads row k); x (n_x, d) f32 ->
// y (n_rows, d) f32, y[r] = sum of x's rows over slots ptr[r] ..
// ptr[r+1]-1 in slot order (compensated); a slot naming a row outside
// [0, n_x) adds zero. vec as for gather_sum_f32. d > 0.
int csr_sum_f32(const int* ptr, int n_rows, const int* idx, const float* x,
                float* y, int d, int n_x, int vec, int device,
                cudaStream_t stream) {
  return dispatch_csr<float>(ptr, n_rows, idx, x, y, d, n_x, vec, device,
                             stream);
}

// The same in bf16: sums in f32, rounded once.
int csr_sum_bf16(const int* ptr, int n_rows, const int* idx, const bf16* x,
                 bf16* y, int d, int n_x, int vec, int device,
                 cudaStream_t stream) {
  return dispatch_csr<bf16>(ptr, n_rows, idx, x, y, d, n_x, vec, device,
                            stream);
}

}  // extern "C"
