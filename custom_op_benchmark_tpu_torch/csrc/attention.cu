// Fused block-sparse graph attention for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel fused_attention_rows of
// custom_op_benchmark_tpu/ops/pallas/attention.py (K4): a flash-style
// forward over each row block's nonzero adjacency tiles,
//   s   = (Q[I] K[J]^T) * scale, with the tile's non-edges set to -1e30
//   m   = running max, starting at -1e9
//   l   = l * exp(m_old - m) + rowsum(exp(s - m))
//   acc = acc * exp(m_old - m) + exp(s - m) @ V[J]
//   out = acc / l where l > 0, else 0 (a row with no edges).
// Softmax runs over each row's tiles (the src direction); callers pass the
// transposed tiling for dst-normalised attention.
//
// What bounds it on this card: at the GraphTransformer slice's shapes
// (T = 344 tiles, 8 heads, d = 64) the two tile products are
// 4*T*H*128*128*d = 11.5 GFLOP of f32 FMA plus 45 M exponentials, while
// the bytes are small (q and out are 31 MB each, the K/V tiles 180 MB of
// reads that mostly hit L2 because a column block is shared by up to three
// row blocks). It is bound by f32 FMA issue, not by HBM.
//
// What the design does about it: one thread block per (row block, head),
// one thread per row. Each thread keeps its query row, its accumulator
// row and its running max and sum in registers for the whole sweep, so the
// scores never leave registers. K and V columns of the current tile are
// staged through shared memory 64 at a time and read as broadcast float4
// loads (every thread of a warp reads the same address), so each shared
// load feeds four FMAs; the mask is staged with a padded row stride so the
// per-row byte reads hit distinct banks. Every output row is owned by one
// thread: no atomics, results repeat bit for bit.
//
// Layouts: q, k, v and out are (n, H, d) contiguous, read in place per
// head; rows at or past n read as zero. The mask is (T, 128, 128) bytes
// shared by every head. Indices are int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // tile_r == tile_c; also threads per block
constexpr int KV = 64;     // key/value columns staged per step
constexpr int SC = 32;     // scores held in registers per step
constexpr float NEG_INF = -1e30f;
constexpr float M_INIT = -1e9f;
constexpr int D = 64;      // head width (the slice's; the only one built)

__global__ void __launch_bounds__(TILE)
fused_attention_rows_kernel(const int* __restrict__ ptr,
                            const int* __restrict__ cols,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int n_q, int n_kv,
                            int n_out, float scale) {
  const int i = blockIdx.x, h = blockIdx.y;
  const long long ld = (long long)gridDim.y * D;
  const int r = threadIdx.x;
  const long long row = (long long)i * TILE + r;

  __shared__ __align__(16) float Ks[KV][D];
  __shared__ __align__(16) float Vs[KV][D];
  __shared__ uint8_t Ms[TILE][KV + 4];

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = row < n_q ? q[row * ld + (long long)h * D + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = M_INIT, l = 0.f;

  const int lo = ptr[i], hi = ptr[i + 1];
  for (int t = lo; t < hi; ++t) {
    const long long c0 = (long long)cols[t] * TILE;
    const uint8_t* mt = mask + (long long)t * TILE * TILE;
    for (int s0 = 0; s0 < TILE; s0 += KV) {
      __syncthreads();  // the previous step's Ks/Vs/Ms are consumed
      for (int e = r; e < KV * D; e += TILE) {
        const int c = e / D, f = e % D;
        const long long gc = c0 + s0 + c;
        const long long off = gc * ld + (long long)h * D + f;
        Ks[c][f] = gc < n_kv ? k[off] : 0.f;
        Vs[c][f] = gc < n_kv ? v[off] : 0.f;
      }
      for (int e = r; e < TILE * KV; e += TILE) {
        const int rr = e / KV, c = e % KV;
        Ms[rr][c] = mt[rr * TILE + s0 + c];
      }
      __syncthreads();

      for (int j0 = 0; j0 < KV; j0 += SC) {
        float s[SC];
#pragma unroll
        for (int j = 0; j < SC; ++j) s[j] = 0.f;
#pragma unroll
        for (int f = 0; f < D; f += 4) {
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            const float4 k4 = *reinterpret_cast<const float4*>(&Ks[j0 + j][f]);
            s[j] = fmaf(qr[f], k4.x, s[j]);
            s[j] = fmaf(qr[f + 1], k4.y, s[j]);
            s[j] = fmaf(qr[f + 2], k4.z, s[j]);
            s[j] = fmaf(qr[f + 3], k4.w, s[j]);
          }
        }
        float m_new = m;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[j] = Ms[r][j0 + j] ? s[j] * scale : NEG_INF;
          m_new = fmaxf(m_new, s[j]);
        }
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int f = 0; f < D; ++f) acc[f] *= corr;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const float p = expf(s[j] - m_new);
          l += p;
#pragma unroll
          for (int f = 0; f < D; f += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(&Vs[j0 + j][f]);
            acc[f] = fmaf(p, v4.x, acc[f]);
            acc[f + 1] = fmaf(p, v4.y, acc[f + 1]);
            acc[f + 2] = fmaf(p, v4.z, acc[f + 2]);
            acc[f + 3] = fmaf(p, v4.w, acc[f + 3]);
          }
        }
        m = m_new;
      }
    }
  }

  if (row < n_out) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < D; ++c)
      out[row * ld + (long long)h * D + c] = l > 0.f ? acc[c] / den : 0.f;
  }
}

}  // namespace

extern "C" {

// q: (n_q, H, d), k/v: (n_kv, H, d), mask: (T, 128, 128)
// -> out: (n_out, H, d), n_out <= nrb * 128. d must be 64.
int fused_attention_rows_f32(const int* tile_ptr, const int* tile_cols,
                             const uint8_t* mask, const float* q,
                             const float* k, const float* v, float* out,
                             int nrb, int H, int d, int n_q, int n_kv,
                             int n_out, float scale, int device,
                             cudaStream_t stream) {
  if (d != D) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  dim3 grid(nrb, H);
  fused_attention_rows_kernel<<<grid, TILE, 0, stream>>>(
      tile_ptr, tile_cols, mask, q, k, v, out, n_q, n_kv, n_out, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
