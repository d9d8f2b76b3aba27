// The DGL GAT's hidden-layer tail for Hopper (sm_90a), f32: the dst
// scaling, the residual add, batch norm with the batch's statistics and
// ReLU, forward and backward, in fused passes.
//
// Replaces no TPU kernel: the JAX package has no DGL GAT. A hidden layer
// of models/gat_dgl.py ends in y = ReLU(BN(out·ds + r)), with out the
// attention's (n, h, d), ds the dst degree scale a node and r the linear
// residual (n, W), W = h d. As PyTorch ops that is ten passes over a
// (n, W) tensor T forward and ten backward (×ds, +r, the statistics, the
// transform, ReLU; ReLU', BN's reduce and its elementwise pass, ×ds): 8.4
// ms a step at DGL's 3 × 250 on ogbn-arxiv's 169,343 nodes on an H100.
//
// What bounds it on this card: bytes. Each element takes a few flops, so
// the least time is the passes' reads and writes at 3.35 TB/s. The
// arithmetic needs five passes forward and six backward:
//
//   forward (norm_act_fwd):
//     fwd_stats_kernel  reads out, r, ds; writes h = out·ds + r (the
//                       batch norm's input, the one tensor the backward
//                       keeps) and each block's Welford mean and M2 of
//                       each column;                              3T
//     fwd_finalize_kernel  merges the blocks' partials by Chan's rule in
//                       a fixed order: mean, rstd = 1/sqrt(var + eps)
//                       with the biased variance, as BatchNorm1d;
//     fwd_apply_kernel  reads h; writes y = max(0, γ·x̂ + β), x̂ = (h − μ)
//                       rstd;                                     2T
//   backward (norm_act_bwd), g = dL/dy:
//     bwd_reduce_kernel  reads g, h; recomputes x̂ and the ReLU mask m;
//                       each block's Σ g·m and Σ g·m·x̂ of each column; 2T
//     bwd_finalize_kernel  sums the blocks' partials in a fixed order:
//                       dβ = Σ g·m, dγ = Σ g·m·x̂;
//     bwd_apply_kernel  reads g, h; writes dh = γ·rstd·(g·m − dβ/n −
//                       x̂·dγ/n), r's cotangent, and dh·ds, out's. 4T
//
// The design for the bytes:
// - Whole 32-byte sectors. A row of W = 750 floats is 3,000 bytes, not a
//   multiple of 32, so a warp that stores part of one row leaves partly
//   written sectors at both ends, and on an H100 such passes took up to
//   1.24 times as long as over 3,008-byte rows. So the passes walk
//   groups of R rows, R the fewest whose R·W floats fill whole sectors (4
//   at W = 750: 12,000 bytes), each group as a flat array of 16-byte
//   vectors, and each warp loads and stores 32 neighbouring vectors: 512
//   bytes from a 32-byte boundary.
// - Fixed columns a thread. Vector v of every group holds the same four
//   (row in the group, column) places, so the thread that takes vector v
//   keeps those columns' statistics, or their batch-norm parameters, in
//   registers down all its groups. A column's statistics are kept in R
//   places a block (one a row of the group), merged with the blocks'.
// - Many loads in flight: one thread a vector of a group (768 threads at
//   W = 750), up to MAX_BLOCKS blocks, and in the forward apply pass two
//   groups loaded before they are used (on an H100 two groups took that
//   pass from 0.41 to 0.38 ms at the cell's shape, and spilled the
//   backward apply pass's registers, 0.75 to 0.82 ms). Block b takes
//   groups b, b + G, b + 2G, ... (G the blocks), so the blocks at work at
//   one time read one band of rows.
// - The statistics are written once a block, no atomics; a small launch
//   merges them, BATCH partials in flight a thread (one at a time, it
//   took 69 us: load latency). The apply passes walk each block's groups
//   from the last, so they start on the band that the pass before ended
//   on, still in the 50 MB L2.
//
// Determinism: every partial is one thread's sum in group order; the
// finalize merges the blocks in SLICES fixed ranges, each in block order
// and a block's R places in order, then the ranges in order. Every output
// element is written once. The same inputs give the same bits on every
// run.
//
// Arithmetic: f32 on the CUDA cores. h = out·ds + r and x̂ = (h − μ)·rstd
// and the pre-activation γ·x̂ + β are rounded at each step (the _rn
// intrinsics, never contracted into an fma), as the plain version
// (ops/kernels/norm_act.py) rounds them, so the backward's ReLU mask is
// the forward's, and the plain version given the same h, μ and rstd
// takes the same mask. Counts are floats: exact to 2^24 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BLOCKS = 264;    // blocks of the row passes: 2 an SM
constexpr int MAX_THREADS = 1024;  // one a vector of a group
constexpr int SLICES = 32;         // partial ranges the finalize merges apart
constexpr int BATCH = 8;           // partials a finalize thread loads at once

// Rows a group: the fewest whose R·w floats fill whole 32-byte sectors
// (8 / gcd(w, 8)).
__host__ __device__ __forceinline__ int group_rows(int w) {
  return (w & 1) ? 8 : (w & 2) ? 4 : (w & 4) ? 2 : 1;
}

// What a block walks: groups of R rows of w columns; its own groups
// (count of them) are blockIdx.x + k·gridDim.x.
struct Walk {
  int R, V, groups, count;
  long long total;  // n·w elements

  __device__ __forceinline__ Walk(int n, int w)
      : R(group_rows(w)),
        V(group_rows(w) * w / 4),
        groups((n + group_rows(w) - 1) / group_rows(w)),
        count(0),
        total((long long)n * w) {
    count = (groups - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  }

  // The first row of the block's k-th group, from the first or, with
  // `reverse`, from the last of its groups.
  __device__ __forceinline__ long long row0(int k, bool reverse) const {
    return (blockIdx.x + (long long)(reverse ? count - 1 - k : k) * gridDim.x)
           * R;
  }
};

// Element j of vector v of a group: its row in the group and its column.
__device__ __forceinline__ void place(int v, int j, int w, int& row,
                                     int& col) {
  const int e = 4 * v + j;
  row = e / w;
  col = e - row * w;
}

// Four floats at p + at, as one 16-byte load where all four lie before
// `total`; the others read as 0.
__device__ __forceinline__ float4 load4(const float* p, long long at,
                                        long long total) {
  if (at + 4 <= total) return __ldg(reinterpret_cast<const float4*>(p + at));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (at < total) v.x = __ldg(p + at);
  if (at + 1 < total) v.y = __ldg(p + at + 1);
  if (at + 2 < total) v.z = __ldg(p + at + 2);
  return v;
}

__device__ __forceinline__ void store4(float* p, long long at,
                                       long long total,
                                       const float (&v)[4]) {
  if (at + 4 <= total) {
    *reinterpret_cast<float4*>(p + at) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int j = 0; j < 3; ++j)
    if (at + j < total) p[at + j] = v[j];
}

__device__ __forceinline__ void unpack(const float4& q, float (&v)[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// x̂ = (h − μ)·rstd and the pre-activation γ·x̂ + β, each step rounded.
__device__ __forceinline__ float normed(float h, float mu, float rs) {
  return __fmul_rn(__fsub_rn(h, mu), rs);
}

__device__ __forceinline__ float pre_act(float xh, float ga, float be) {
  return __fadd_rn(__fmul_rn(ga, xh), be);
}

// A column's batch-norm parameters, for the four elements of this
// thread's vector: gathered once, kept down all its groups.
struct Params {
  float mu[4], rs[4], ga[4], be[4];

  __device__ __forceinline__ Params(int v, int w, const float* mean,
                                    const float* rstd, const float* gamma,
                                    const float* beta) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int row, col;
      place(v, j, w, row, col);
      mu[j] = __ldg(mean + col);
      rs[j] = __ldg(rstd + col);
      ga[j] = __ldg(gamma + col);
      be[j] = __ldg(beta + col);
    }
  }
};

// Write this thread's four (row in the group, column) pairs of stat a and
// b to the block's partials: part[(block·R + row)·2w + {0, w} + col].
__device__ __forceinline__ void write_partials(float* part, int v, int w,
                                               int R, const float (&a)[4],
                                               const float (&b)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int row, col;
    place(v, j, w, row, col);
    float* p = part + ((size_t)blockIdx.x * R + row) * 2 * w + col;
    p[0] = a[j];
    p[w] = b[j];
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
fwd_stats_kernel(const float* __restrict__ out, const float* __restrict__ ds,
                 const float* __restrict__ r, int n, int w,
                 float* __restrict__ h, float* __restrict__ part) {
  const Walk wk(n, w);
  const int v = threadIdx.x;
  if (v >= wk.V) return;
  int rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int col;
    place(v, j, w, rows[j], col);
  }
  float mean[4] = {0.f, 0.f, 0.f, 0.f}, m2[4] = {0.f, 0.f, 0.f, 0.f};
  float cnt = 0.f;
  for (int k = 0; k < wk.count; ++k) {
    const long long row0 = wk.row0(k, false);
    const long long at = row0 * w + 4 * v;
    float o[4], q[4], x[4];
    unpack(load4(out, at, wk.total), o);
    unpack(load4(r, at, wk.total), q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = at + j < wk.total ? __ldg(ds + row0 + rows[j]) : 0.f;
      x[j] = __fadd_rn(__fmul_rn(o[j], s), q[j]);
    }
    store4(h, at, wk.total, x);
    cnt += 1.f;
    const float inv = 1.f / cnt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (at + j < wk.total) {  // the last group may lack rows
        const float d = x[j] - mean[j];
        mean[j] = fmaf(d, inv, mean[j]);
        m2[j] = fmaf(d, x[j] - mean[j], m2[j]);
      }
    }
  }
  write_partials(part, v, w, wk.R, mean, m2);
}

// Items [i0, i1) of range `slice` of SLICES over `items`.
__device__ __forceinline__ void slice_range(int items, int slice, int& i0,
                                            int& i1) {
  i0 = (int)((long long)items * slice / SLICES);
  i1 = (int)((long long)items * (slice + 1) / SLICES);
}

// The rows block b of `blocks` took at row `row` of its groups: one a
// group, less the last group's if it was b's and lacks that row.
__device__ __forceinline__ float rows_of(int b, int row, int blocks, int n,
                                         int R) {
  const int groups = (n + R - 1) / R;
  const int taken = (groups - b + blocks - 1) / blocks;
  const bool short_last =
      (groups - 1) % blocks == b && (groups - 1) * R + row >= n;
  return (float)(taken - (short_last ? 1 : 0));
}

// Fold (nb, mb, qb) (count, mean, M2) into (na, ma, qa): Chan's rule.
__device__ __forceinline__ void chan(float& na, float& ma, float& qa,
                                     float nb, float mb, float qb) {
  if (nb == 0.f) return;
  const float nn = na + nb;
  const float d = mb - ma;
  const float f = nb / nn;
  ma = fmaf(d, f, ma);
  qa = qa + qb + d * d * na * f;
  na = nn;
}

// The finalize kernels: block (32, SLICES), 32 columns; thread (x, s)
// folds the partials of column x in range s of the blocks' places (place
// i = block·R + row, in order), BATCH loaded before they are folded; then
// thread (x, 0) folds the ranges in order.
__global__ void __launch_bounds__(32 * SLICES)
fwd_finalize_kernel(const float* __restrict__ part, int n, int w, int blocks,
                    float eps, float* __restrict__ mean,
                    float* __restrict__ rstd) {
  __shared__ float sn[SLICES][32], sm[SLICES][32], sq[SLICES][32];
  const int c = blockIdx.x * 32 + threadIdx.x, sl = threadIdx.y;
  const int R = group_rows(w);
  float na = 0.f, ma = 0.f, qa = 0.f;
  if (c < w) {
    int i0, i1;
    slice_range(blocks * R, sl, i0, i1);
    for (int i = i0; i < i1; i += BATCH) {
      float mb[BATCH], qb[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i + u < i1) {
          const float* p = part + (size_t)(i + u) * 2 * w + c;
          mb[u] = p[0];
          qb[u] = p[w];
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (i + u < i1)
          chan(na, ma, qa, rows_of((i + u) / R, (i + u) % R, blocks, n, R),
               mb[u], qb[u]);
    }
  }
  sn[sl][threadIdx.x] = na;
  sm[sl][threadIdx.x] = ma;
  sq[sl][threadIdx.x] = qa;
  __syncthreads();
  if (sl != 0 || c >= w) return;
  for (int s = 1; s < SLICES; ++s)
    chan(na, ma, qa, sn[s][threadIdx.x], sm[s][threadIdx.x],
         sq[s][threadIdx.x]);
  mean[c] = ma;
  rstd[c] = 1.f / sqrtf(qa / na + eps);
}

// STEP groups loaded before the first of them is used (2: the design note).
template <int STEP>
__global__ void __launch_bounds__(MAX_THREADS)
fwd_apply_kernel(const float* __restrict__ h, const float* __restrict__ mean,
                 const float* __restrict__ rstd,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, int n, int w,
                 float* __restrict__ y) {
  const Walk wk(n, w);
  const int v = threadIdx.x;
  if (v >= wk.V) return;
  const Params pr(v, w, mean, rstd, gamma, beta);
  for (int k = 0; k < wk.count; k += STEP) {
    float hv[STEP][4];
#pragma unroll
    for (int gi = 0; gi < STEP; ++gi)
      if (k + gi < wk.count)
        unpack(load4(h, wk.row0(k + gi, true) * w + 4 * v, wk.total),
               hv[gi]);
#pragma unroll
    for (int gi = 0; gi < STEP; ++gi) {
      if (k + gi < wk.count) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = pre_act(normed(hv[gi][j], pr.mu[j], pr.rs[j]),
                                  pr.ga[j], pr.be[j]);
          o[j] = p < 0.f ? 0.f : p;  // ReLU; a NaN stays NaN
        }
        store4(y, wk.row0(k + gi, true) * w + 4 * v, wk.total, o);
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
bwd_reduce_kernel(const float* __restrict__ g, const float* __restrict__ h,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, int n, int w,
                  float* __restrict__ part) {
  const Walk wk(n, w);
  const int v = threadIdx.x;
  if (v >= wk.V) return;
  const Params pr(v, w, mean, rstd, gamma, beta);
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < wk.count; ++k) {
    const long long at = wk.row0(k, false) * w + 4 * v;
    float gv[4], hv[4];
    unpack(load4(g, at, wk.total), gv);
    unpack(load4(h, at, wk.total), hv);
    // Past the last row g reads 0: it adds nothing.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float xh = normed(hv[j], pr.mu[j], pr.rs[j]);
      const float gm = pre_act(xh, pr.ga[j], pr.be[j]) > 0.f ? gv[j] : 0.f;
      s1[j] += gm;
      s2[j] = fmaf(gm, xh, s2[j]);
    }
  }
  write_partials(part, v, w, wk.R, s1, s2);
}

__global__ void __launch_bounds__(32 * SLICES)
bwd_finalize_kernel(const float* __restrict__ part, int w, int blocks,
                    float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float s1s[SLICES][32], s2s[SLICES][32];
  const int c = blockIdx.x * 32 + threadIdx.x, sl = threadIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (c < w) {
    int i0, i1;
    slice_range(blocks * group_rows(w), sl, i0, i1);
    for (int i = i0; i < i1; i += BATCH) {
      float a[BATCH], b[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i + u < i1) {
          const float* p = part + (size_t)(i + u) * 2 * w + c;
          a[u] = p[0];
          b[u] = p[w];
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i + u < i1) {
          s1 += a[u];
          s2 += b[u];
        }
      }
    }
  }
  s1s[sl][threadIdx.x] = s1;
  s2s[sl][threadIdx.x] = s2;
  __syncthreads();
  if (sl != 0 || c >= w) return;
  for (int s = 1; s < SLICES; ++s) {
    s1 += s1s[s][threadIdx.x];
    s2 += s2s[s][threadIdx.x];
  }
  dbeta[c] = s1;
  dgamma[c] = s2;
}

__global__ void __launch_bounds__(MAX_THREADS)
bwd_apply_kernel(const float* __restrict__ g, const float* __restrict__ h,
                 const float* __restrict__ ds,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ dgamma,
                 const float* __restrict__ dbeta, int n, int w,
                 float* __restrict__ dh, float* __restrict__ dout) {
  const Walk wk(n, w);
  const int v = threadIdx.x;
  if (v >= wk.V) return;
  const Params pr(v, w, mean, rstd, gamma, beta);
  const float inv_n = 1.f / (float)n;
  int rows[4];
  float kk[4], a[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int col;
    place(v, j, w, rows[j], col);
    kk[j] = pr.ga[j] * pr.rs[j];
    a[j] = __ldg(dbeta + col) * inv_n;
    b[j] = __ldg(dgamma + col) * inv_n;
  }
  for (int k = 0; k < wk.count; ++k) {
    const long long row0 = wk.row0(k, true);
    const long long at = row0 * w + 4 * v;
    float gv[4], hv[4], d[4], e[4];
    unpack(load4(g, at, wk.total), gv);
    unpack(load4(h, at, wk.total), hv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = at + j < wk.total ? __ldg(ds + row0 + rows[j]) : 0.f;
      const float xh = normed(hv[j], pr.mu[j], pr.rs[j]);
      const float gm = pre_act(xh, pr.ga[j], pr.be[j]) > 0.f ? gv[j] : 0.f;
      d[j] = kk[j] * fmaf(-xh, b[j], gm - a[j]);
      e[j] = d[j] * s;
    }
    store4(dh, at, wk.total, d);
    store4(dout, at, wk.total, e);
  }
}

// The row passes' launch: blocks of one thread a vector of a group.
struct Shape {
  int blocks, threads;
};

Shape shape_of(int n, int w) {
  const int R = group_rows(w);
  const int groups = (n + R - 1) / R;
  const int vectors = R * w / 4;
  return {groups < MAX_BLOCKS ? groups : MAX_BLOCKS, (vectors + 31) / 32 * 32};
}

// n, w >= 1; a group at most MAX_THREADS vectors; the (n, w) arrays on 16
// bytes.
bool bad_args(int n, int w, const float* const* rows, int n_rows) {
  if (n < 1 || w < 1 || group_rows(w) * w / 4 > MAX_THREADS) return true;
  for (int i = 0; i < n_rows; ++i)
    if (reinterpret_cast<uintptr_t>(rows[i]) % 16 != 0) return true;
  return false;
}

}  // namespace

extern "C" {

// out (n, w) f32 (the attention's (n, h, d) as rows), ds (n,), r (n, w),
// gamma, beta (w,) -> h (n, w) = out·ds + r, y (n, w) = ReLU(BN(h)), mean,
// rstd (w,). part: 2 w floats a row of a group a block (scratch: R·2·w·
// min(MAX_BLOCKS, groups) floats, R rows a group). out, r, h and y lie on
// 16 bytes, and a group of R rows (8 / gcd(w, 8)) holds at most
// MAX_THREADS 16-byte vectors.
int norm_act_fwd_f32(const float* out, const float* ds, const float* r,
                     const float* gamma, const float* beta, int n, int w,
                     float eps, float* h, float* y, float* mean, float* rstd,
                     float* part, int device, cudaStream_t stream) {
  const float* rows[] = {out, r, h, y};
  if (bad_args(n, w, rows, 4)) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const Shape sh = shape_of(n, w);
  fwd_stats_kernel<<<sh.blocks, sh.threads, 0, stream>>>(
      out, ds, r, n, w, h, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_finalize_kernel<<<(w + 31) / 32, dim3(32, SLICES), 0, stream>>>(
      part, n, w, sh.blocks, eps, mean, rstd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_apply_kernel<2><<<sh.blocks, sh.threads, 0, stream>>>(
      h, mean, rstd, gamma, beta, n, w, y);
  return (int)cudaGetLastError();
}

// g (n, w) = dL/dy f32 and the forward's h, ds, mean, rstd, gamma, beta ->
// dh (n, w) (r's cotangent), dout (n, w) = dh·ds (out's), dgamma, dbeta
// (w,). part as for norm_act_fwd_f32; g, h, dh and dout on 16 bytes.
int norm_act_bwd_f32(const float* g, const float* h, const float* ds,
                     const float* mean, const float* rstd, const float* gamma,
                     const float* beta, int n, int w, float* dh, float* dout,
                     float* dgamma, float* dbeta, float* part, int device,
                     cudaStream_t stream) {
  const float* rows[] = {g, h, dh, dout};
  if (bad_args(n, w, rows, 4)) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const Shape sh = shape_of(n, w);
  bwd_reduce_kernel<<<sh.blocks, sh.threads, 0, stream>>>(
      g, h, mean, rstd, gamma, beta, n, w, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_finalize_kernel<<<(w + 31) / 32, dim3(32, SLICES), 0, stream>>>(
      part, w, sh.blocks, dgamma, dbeta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_apply_kernel<<<sh.blocks, sh.threads, 0, stream>>>(
      g, h, ds, mean, rstd, gamma, beta, dgamma, dbeta, n, w, dh, dout);
  return (int)cudaGetLastError();
}

}  // extern "C"
