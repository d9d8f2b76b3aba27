// Block-sparse (BSR) tile kernels for Hopper (sm_90a), f32.
//
// Replaces the three Pallas TPU kernels of
// custom_op_benchmark_tpu/ops/pallas/tiled_kernels.py:
//   K1 sddmm_tiles      <- sddmm_tiles_kernel
//     S[h,t] = mask[t] * (A[rows[t]*128 : +128, h] @ B[cols[t]*128 : +128, h]^T)
//   K2 spmm_row_sweep   <- spmm_row_sweep_kernel
//     Y[i, h] = sum_{t in ptr[i]..ptr[i+1]} vals[h,t] @ X[cols[t]*128 : +128, h]
//   K3 spmm_col_sweep   <- spmm_col_sweep_kernel
//     X'[j, h] = sum_{k in ptr_c[j]..ptr_c[j+1]} vals[h,t]^T @ Y[rows[t]*128 : +128, h],
//                with t = perm[k]
//
// What bounds them on this card: each is a batch of 128x128xd tile
// products in f32. At the GraphTransformer slice's shapes (T = 344 tiles,
// 8 heads, d = 64) each kernel does 2*T*H*128*128*d = 5.8 GFLOP and moves
// about 180 MB of tile-dense scores (written by K1, read by K2/K3), about
// 25 FLOP per byte: close to the card's f32 ratio of CUDA-core FLOP/s to
// HBM bandwidth, so f32 FMA issue and the score stream bound them together.
// K2/K3 at d = 1024 (one head) do 11.5 GFLOP on 22.5 MB of scores and are
// bound by f32 FMA issue.
//
// What the design does about it: each thread block owns one output block
// outright (a score tile for K1, a 128 x 64 slice of a row or column block
// for K2/K3), stages both operands through shared memory in 32-deep chunks
// with coalesced loads, and keeps an 8x8 (K1) or 8x4 (K2/K3) register tile
// of f32 accumulators per thread, so each shared-memory load feeds 4-8
// FMAs. No atomics: outputs repeat bit for bit. K2/K3 loop over each
// block's exact tile range (no padding to the longest row, as the TPU grid
// needed), and an empty row or column block writes zeros.
//
// Layouts: node arrays are (n, H, d) contiguous, read in place per head
// (row stride H*d, head offset h*d); rows at or past n read as zero, so
// callers never pad. Tile arrays are (H, T, 128, 128) contiguous; the mask
// is (T, 128, 128) bytes shared by every head. Indices are int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // tile_r == tile_c
constexpr int KC = 32;        // contraction depth staged per step
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int DC = 64;        // feature columns owned by one sweep block

__global__ void __launch_bounds__(THREADS)
sddmm_tiles_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ out, int T, int d, int nA, int nB) {
  const int t = blockIdx.x, h = blockIdx.y;
  const long long ld = (long long)gridDim.y * d;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long r0 = (long long)rows[t] * TILE;
  const long long c0 = (long long)cols[t] * TILE;
  const float* Ah = A + (long long)h * d;
  const float* Bh = B + (long long)h * d;

  // Stored k-major with one float of padding: the transposing store and
  // the row reads below both hit 32 distinct banks.
  __shared__ float As[KC][TILE + 1];
  __shared__ float Bs[KC][TILE + 1];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int r = e / KC, k = e % KC, gk = k0 + k;
      As[k][r] = (r0 + r < nA && gk < d) ? Ah[(r0 + r) * ld + gk] : 0.f;
      Bs[k][r] = (c0 + r < nB && gk < d) ? Bh[(c0 + r) * ld + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const uint8_t* m = mask + (long long)t * TILE * TILE;
  float* o = out + ((long long)h * T + t) * TILE * TILE;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = (ty + 16 * i) * TILE + tx + 16 * j;
      o[idx] = m[idx] ? acc[i][j] : 0.f;
    }
}

// One block per (row block or column block, 64-wide feature slice, head).
// COL = false: row sweep over tiles ptr[i]..ptr[i+1] (row-sorted order),
//   out row r = sum_c vals[t][r][c] * x[blk[t]*128 + c].
// COL = true: column sweep over perm[ptr[j]..ptr[j+1]],
//   out row c = sum_r vals[t][r][c] * x[blk[t]*128 + r].
template <bool COL>
__global__ void __launch_bounds__(THREADS)
spmm_sweep_kernel(const int* __restrict__ ptr, const int* __restrict__ perm,
                  const int* __restrict__ blk, const float* __restrict__ vals,
                  const float* __restrict__ x, float* __restrict__ out,
                  int T, int d, int n_x, int n_out) {
  const int i = blockIdx.x, d0 = blockIdx.y * DC, h = blockIdx.z;
  const long long ld = (long long)gridDim.z * d;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* xh = x + (long long)h * d;

  __shared__ float Ls[KC][TILE + 1];  // tile chunk, [contraction][out row]
  __shared__ float Xs[KC][DC];        // x chunk, [contraction][feature]
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  const int lo = ptr[i], hi = ptr[i + 1];
  for (int p = lo; p < hi; ++p) {
    const int t = COL ? perm[p] : p;
    const long long x0 = (long long)blk[t] * TILE;
    const float* v = vals + ((long long)h * T + t) * TILE * TILE;
    for (int k0 = 0; k0 < TILE; k0 += KC) {
      for (int e = tid; e < TILE * KC; e += THREADS) {
        if (COL) {
          const int k = e / TILE, c = e % TILE;
          Ls[k][c] = v[(k0 + k) * TILE + c];
        } else {
          const int r = e / KC, k = e % KC;
          Ls[k][r] = v[r * TILE + k0 + k];
        }
      }
      for (int e = tid; e < KC * DC; e += THREADS) {
        const int k = e / DC, f = e % DC;
        const long long gr = x0 + k0 + k;
        Xs[k][f] = (gr < n_x && d0 + f < d) ? xh[gr * ld + d0 + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) a[ii] = Ls[k][ty + 16 * ii];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b[jj] = Xs[k][tx + 16 * jj];
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
      }
      __syncthreads();
    }
  }

  float* oh = out + (long long)h * d;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const long long r = (long long)i * TILE + ty + 16 * ii;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int f = d0 + tx + 16 * jj;
      if (r < n_out && f < d) oh[r * ld + f] = acc[ii][jj];
    }
  }
}

}  // namespace

extern "C" {

// A: (nA, H, d), B: (nB, H, d), mask: (T, 128, 128) -> out: (H, T, 128, 128).
int sddmm_tiles_f32(const int* rows, const int* cols, const uint8_t* mask,
                    const float* A, const float* B, float* out, int T, int H,
                    int d, int nA, int nB, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  dim3 grid(T, H);
  sddmm_tiles_kernel<<<grid, THREADS, 0, stream>>>(rows, cols, mask, A, B,
                                                  out, T, d, nA, nB);
  return (int)cudaGetLastError();
}

// vals: (H, T, 128, 128), x: (n_x, H, d) -> out: (n_out, H, d), with
// n_out <= nrb * 128.
int spmm_row_sweep_f32(const int* tile_ptr, const int* tile_cols,
                       const float* vals, const float* x, float* out, int nrb,
                       int T, int H, int d, int n_x, int n_out, int device,
                       cudaStream_t stream) {
  cudaSetDevice(device);
  dim3 grid(nrb, (d + DC - 1) / DC, H);
  spmm_sweep_kernel<false><<<grid, THREADS, 0, stream>>>(
      tile_ptr, nullptr, tile_cols, vals, x, out, T, d, n_x, n_out);
  return (int)cudaGetLastError();
}

// vals: (H, T, 128, 128), y: (n_y, H, d) -> out: (n_out, H, d), with
// n_out <= ncb * 128.
int spmm_col_sweep_f32(const int* tile_ptr_c, const int* tile_perm_c,
                       const int* tile_rows, const float* vals, const float* y,
                       float* out, int ncb, int T, int H, int d, int n_y,
                       int n_out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  dim3 grid(ncb, (d + DC - 1) / DC, H);
  spmm_sweep_kernel<true><<<grid, THREADS, 0, stream>>>(
      tile_ptr_c, tile_perm_c, tile_rows, vals, y, out, T, d, n_y, n_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
