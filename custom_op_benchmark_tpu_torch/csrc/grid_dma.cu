// Row-block-owned SpMM sweeps with asynchronous prefetch, for Hopper
// (sm_90a), f32.
//
// Replaces the two Pallas TPU kernels of scripts/exp_grid_dma.py:
//   S1 spmm_row_sweep_dma     <- spmm_row_sweep_dma
//     Y[i] = sum_{s < max_tpr} vals_pad[i, s] @ X[cols_pad[i, s]*128 : +128]
//     over a dense-padded layout whose zero padding contributes 0
//   S2 spmm_row_sweep_dma_v2  <- spmm_row_sweep_dma_v2
//     Y[i] = sum_{t in ptr[i]..ptr[i+1]} vals[t] @ X[cols[t]*128 : +128]
//     (K2's function on K2's (T, 128, 128) tile list)
// Both are single-head: x is (n_x, d), out (n_out, d).
//
// What the TPU experiment tested, and what is kept: one owner per output
// row block, and the next operands in flight while the current tile
// product runs (there, manual DMAs one row block ahead). What bounds it on
// this card: 2*128*128*d FLOP per tile in f32 FMA against 64 KB of vals
// and 128*d*4 bytes of x per tile, about 2*d/(4 + 4*d/128) FLOP per byte
// (51 at d = 128): the vals stream alone needs under a tenth of the FMA
// time, so f32 FMA issue bounds it, as for K2.
//
// What the design does about it: one block per (row block, 64 feature
// columns), 256 threads, each with an 8x4 register tile of accumulators
// (K2's compute loop). The operands move through a two-stage ring in
// shared memory filled with cp.async: a stage is one 32-column chunk of a
// vals tile (16 KB, rows padded to 36 floats so the compute reads hit
// distinct banks) and the matching 32 rows x 64 features of x (8 KB).
// While the block multiplies stage s, the copies of stage s+1 are in
// flight; the tile loop and the chunk loop are one flat loop, so the
// prefetch crosses tile boundaries. The TPU v2 kernel clamps its DMA start
// and shifts inside the buffer to read a row's tile range; here the block
// reads exactly ptr[i]..ptr[i+1]. Rows of x at or past n_x are filled with
// zeros by the copy (src-size 0), so callers never pad. No atomics:
// outputs repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_async.cuh"

namespace {

constexpr int TILE = 128;
constexpr int KC = 32;        // vals columns (x rows) per stage
constexpr int DC = 64;        // feature columns owned by one block
constexpr int THREADS = 256;  // 16 x 16
constexpr int VLD = KC + 4;   // padded vals stage row
constexpr int STAGE_V = TILE * VLD;
constexpr int STAGE_X = KC * DC;
constexpr size_t SMEM = 2 * sizeof(float) * (STAGE_V + STAGE_X);

// PADDED = true (S1): block i sweeps slots i*max_tpr .. +max_tpr of
// (cols_pad, vals_pad). PADDED = false (S2): tiles ptr[i] .. ptr[i+1].
// vec: x rows are 16-byte aligned (d % 4 == 0), so x moves as float4.
template <bool PADDED>
__global__ void __launch_bounds__(THREADS)
spmm_dma_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ out, int max_tpr, int d, int n_x,
                int n_out, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Vs = smem;                 // [2][TILE][VLD]
  float* Xs = smem + 2 * STAGE_V;   // [2][KC][DC]

  const int i = blockIdx.x, d0 = blockIdx.y * DC;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  int lo, n_t;
  if (PADDED) {
    lo = i * max_tpr;
    n_t = max_tpr;
  } else {
    lo = ptr[i];
    n_t = ptr[i + 1] - lo;
  }
  constexpr int CHUNKS = TILE / KC;
  const int steps = n_t * CHUNKS;

  auto issue = [&](int step) {
    const int t = lo + step / CHUNKS, k0 = (step % CHUNKS) * KC;
    float* vs = Vs + (step & 1) * STAGE_V;
    float* xs = Xs + (step & 1) * STAGE_X;
    const float* vt = vals + (long long)t * TILE * TILE + k0;
    for (int e = tid; e < TILE * KC / 4; e += THREADS) {
      const int r = e / (KC / 4), c4 = e % (KC / 4);
      cp_async16(vs + r * VLD + c4 * 4, vt + r * TILE + c4 * 4, 16);
    }
    const long long xr0 = (long long)cols[t] * TILE + k0;
    if (vec) {
      for (int e = tid; e < KC * DC / 4; e += THREADS) {
        const int kk = e / (DC / 4), f = d0 + (e % (DC / 4)) * 4;
        const long long gr = xr0 + kk;
        const bool ok = gr < n_x && f < d;
        cp_async16(xs + e * 4, ok ? x + gr * d + f : x, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < KC * DC; e += THREADS) {
        const int kk = e / DC, f = d0 + e % DC;
        const long long gr = xr0 + kk;
        const bool ok = gr < n_x && f < d;
        cp_async4(xs + e, ok ? x + gr * d + f : x, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  if (steps > 0) issue(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      issue(step + 1);   // into the stage consumed two steps ago
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* vs = Vs + (step & 1) * STAGE_V;
    const float* xs = Xs + (step & 1) * STAGE_X;
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) a[ii] = vs[(ty + 16 * ii) * VLD + kk];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = xs[kk * DC + tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
    }
    __syncthreads();   // this stage may be refilled
  }

#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const long long r = (long long)i * TILE + ty + 16 * ii;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int f = d0 + tx + 16 * jj;
      if (r < n_out && f < d) out[r * d + f] = acc[ii][jj];
    }
  }
}

template <bool PADDED>
int launch(const int* ptr, const int* cols, const float* vals,
           const float* x, float* out, int nrb, int max_tpr, int d, int n_x,
           int n_out, int vec, cudaStream_t stream) {
  auto kernel = spmm_dma_kernel<PADDED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nrb, (d + DC - 1) / DC);
  kernel<<<grid, THREADS, SMEM, stream>>>(ptr, cols, vals, x, out, max_tpr,
                                          d, n_x, n_out, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S1: cols_pad (nrb, max_tpr), vals_pad (nrb, max_tpr, 128, 128), x (n_x, d)
// -> out (n_out, d), n_out <= nrb * 128.
int spmm_row_sweep_dma_f32(const int* cols_pad, const float* vals_pad,
                           const float* x, float* out, int nrb, int max_tpr,
                           int d, int n_x, int n_out, int vec, int device,
                           cudaStream_t stream) {
  cudaSetDevice(device);
  return launch<true>(nullptr, cols_pad, vals_pad, x, out, nrb, max_tpr, d,
                      n_x, n_out, vec, stream);
}

// S2: tile_ptr (nrb + 1), tile_cols (T), vals (T, 128, 128), x (n_x, d)
// -> out (n_out, d), n_out <= nrb * 128.
int spmm_row_sweep_dma_v2_f32(const int* tile_ptr, const int* tile_cols,
                              const float* vals, const float* x, float* out,
                              int nrb, int d, int n_x, int n_out, int vec,
                              int device, cudaStream_t stream) {
  cudaSetDevice(device);
  return launch<false>(tile_ptr, tile_cols, vals, x, out, nrb, 0, d, n_x,
                       n_out, vec, stream);
}

}  // extern "C"
