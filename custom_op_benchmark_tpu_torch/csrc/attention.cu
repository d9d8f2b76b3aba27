// Fused block-sparse graph attention for Hopper (sm_90a), f32.
//
// Replaces two Pallas TPU kernels:
//   K4 fused_attention_rows <- custom_op_benchmark_tpu/ops/pallas/attention.py
//   S5 attn_variant         <- scripts/exp_grid_bisect.py (K4 with use_exp /
//                              use_mask switches, a diagnostic)
// Per row block I and head h, a flash-style forward over I's nonzero
// adjacency tiles, one tile at a time:
//   s      = (Q[I] K[J]^T) * scale, non-edges set to -1e30 (UseMask)
//   m_new  = max(m, rowmax(s)), m starting at -1e9
//   p      = exp(s - m_new),  corr = exp(m - m_new)     (UseExp)
//   p      = s - m_new,       corr = m - m_new          (!UseExp)
//   l      = l * corr + rowsum(p)
//   acc    = acc * corr + p @ V[J]
//   out    = acc / l where l > 0, else 0 (a row with no edges).
// Softmax runs over each row's tiles (the src direction); callers pass the
// transposed tiling for dst-normalised attention. The running max is
// updated once per whole tile, as the TPU kernel does: for !UseExp the
// recurrence is not associative, so a finer update would compute another
// function.
//
// What bounds it on this card: two 128x128xd tile products per tile
// (4*T*H*128*128*d FLOP) in f32 FMA plus 128*128 exponentials per tile;
// the K/V tiles mostly hit L2 because a column block is shared by a few
// row blocks. It is bound by f32 FMA issue, not by HBM.
//
// What the design does about it: a row's d features are split across
// S = D/32 neighbouring threads of one warp, each holding 32 query and 32
// accumulator values in registers, capped at 128 registers so that two
// blocks share an SM (measured on the H100: 20 % faster at d = 128 than
// one block of 204-210 registers, despite a few spilled scores). Partial
// dot products are summed with warp shuffles. Each thread owns interleaved
// float4 feature chunks, so the S threads of a row read S consecutive
// float4s of a staged K or V row (no bank conflicts). A tile is done in
// two phases: K columns staged 16 KB at a time give the scaled, masked
// scores, written to a shared score tile P and folded into the row max;
// then each thread turns its share of the row's scores into p, the row
// sums are reduced with shuffles, and V columns staged through the same
// 16 KB buffer feed acc += p * V. One block covers 256 / S rows of a row
// block. Every output row is owned by one group of threads: no atomics,
// results repeat bit for bit.
//
// Layouts: q, k, v and out are (n, H, d) contiguous, read in place per
// head; rows at or past n, and features at or past d, read as zero. The
// mask is (T, 128, 128) bytes shared by every head. Indices are int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // tile_r == tile_c
constexpr int THREADS = 256;
constexpr int F = 32;         // features held by one thread
constexpr int SC = 32;        // scores reduced per step
constexpr int KV_FLOATS = 4096;  // one staged K or V chunk: 16 KB
constexpr float NEG_INF = -1e30f;
constexpr float M_INIT = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int S = D / F;              // threads per row
  static constexpr int ROWS = THREADS / S;     // rows per block
  static constexpr int KV = KV_FLOATS / D;     // K/V columns per chunk
  static constexpr int SCN = KV < SC ? KV : SC;
  static constexpr int PLD = TILE + S;         // score row stride
  static constexpr int MLD = KV + 4;           // mask row stride
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)KV * D + (size_t)ROWS * PLD) +
      (size_t)ROWS * MLD;
};

template <int D, bool UseExp, bool UseMask>
__global__ void __launch_bounds__(THREADS, 2)
attention_rows_kernel(const int* __restrict__ ptr,
                      const int* __restrict__ cols,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int d, int n_q, int n_kv, int n_out, float scale) {
  using C = Cfg<D>;
  constexpr int S = C::S, ROWS = C::ROWS, KV = C::KV, SCN = C::SCN;
  constexpr int PLD = C::PLD, MLD = C::MLD, NC4 = F / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* KVs = reinterpret_cast<float*>(smem);            // [KV][D]
  float* Ps = KVs + KV * D;                               // [ROWS][PLD]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Ps + ROWS * PLD);  // [ROWS][MLD]

  constexpr int PER_TILE = TILE / ROWS;
  const int i = blockIdx.x / PER_TILE;
  const int r0 = (blockIdx.x % PER_TILE) * ROWS;
  const int h = blockIdx.y;
  const long long ld = (long long)gridDim.y * d;
  const int tid = threadIdx.x, lr = tid / S, part = tid % S;
  const long long row = (long long)i * TILE + r0 + lr;
  const float* qh = q + (long long)h * d;
  const float* kh = k + (long long)h * d;
  const float* vh = v + (long long)h * d;

  float qr[F], acc[F];
#pragma unroll
  for (int kk = 0; kk < NC4; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int f = (part + S * kk) * 4 + u;
      qr[kk * 4 + u] = (row < n_q && f < d) ? qh[row * ld + f] : 0.f;
      acc[kk * 4 + u] = 0.f;
    }
  float m = M_INIT, l = 0.f;
  float* prow = Ps + lr * PLD;

  const int lo = ptr[i], hi = ptr[i + 1];
  for (int t = lo; t < hi; ++t) {
    const long long c0 = (long long)cols[t] * TILE;
    const uint8_t* mt = mask + (long long)t * TILE * TILE + r0 * TILE;

    // Phase A: scores of the whole tile into P, and the tile's row max.
    float m_new = m;
    for (int s0 = 0; s0 < TILE; s0 += KV) {
      __syncthreads();  // KVs, Ms and P are free again
      for (int e = tid; e < KV * D; e += THREADS) {
        const int c = e / D, f = e % D;
        const long long gc = c0 + s0 + c;
        KVs[e] = (gc < n_kv && f < d) ? kh[gc * ld + f] : 0.f;
      }
      if (UseMask)
        for (int e = tid; e < ROWS * KV; e += THREADS) {
          const int rr = e / KV, c = e % KV;
          Ms[rr * MLD + c] = mt[rr * TILE + s0 + c];
        }
      __syncthreads();
      for (int j0 = 0; j0 < KV; j0 += SCN) {
        float s[SCN];
#pragma unroll
        for (int j = 0; j < SCN; ++j) s[j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NC4; ++kk) {
          const int f = (part + S * kk) * 4;
#pragma unroll
          for (int j = 0; j < SCN; ++j) {
            const float4 k4 =
                *reinterpret_cast<const float4*>(&KVs[(j0 + j) * D + f]);
            s[j] = fmaf(qr[kk * 4], k4.x, s[j]);
            s[j] = fmaf(qr[kk * 4 + 1], k4.y, s[j]);
            s[j] = fmaf(qr[kk * 4 + 2], k4.z, s[j]);
            s[j] = fmaf(qr[kk * 4 + 3], k4.w, s[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < SCN; ++j) {
#pragma unroll
          for (int o = 1; o < S; o <<= 1)
            s[j] += __shfl_xor_sync(FULL, s[j], o);
          float sj = s[j] * scale;
          if (UseMask && !Ms[lr * MLD + j0 + j]) sj = NEG_INF;
          m_new = fmaxf(m_new, sj);
          if ((j % S) == part) prow[s0 + j0 + j] = sj;
        }
      }
    }

    // Each thread turns the scores it wrote (columns part, part + S, ...)
    // into p; the row's S threads then sum them.
    const float corr = UseExp ? expf(m - m_new) : (m - m_new);
    float psum = 0.f;
    for (int c = part; c < TILE; c += S) {
      const float p = UseExp ? expf(prow[c] - m_new) : (prow[c] - m_new);
      prow[c] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 1; o < S; o <<= 1) psum += __shfl_xor_sync(FULL, psum, o);
    l = l * corr + psum;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] *= corr;
    m = m_new;

    // Phase B: acc += p @ V over the tile's columns.
    for (int s0 = 0; s0 < TILE; s0 += KV) {
      __syncthreads();  // P complete; the K chunk is consumed
      for (int e = tid; e < KV * D; e += THREADS) {
        const int c = e / D, f = e % D;
        const long long gc = c0 + s0 + c;
        KVs[e] = (gc < n_kv && f < d) ? vh[gc * ld + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < KV; ++j) {
        const float p = prow[s0 + j];
#pragma unroll
        for (int kk = 0; kk < NC4; ++kk) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              &KVs[j * D + (part + S * kk) * 4]);
          acc[kk * 4] = fmaf(p, v4.x, acc[kk * 4]);
          acc[kk * 4 + 1] = fmaf(p, v4.y, acc[kk * 4 + 1]);
          acc[kk * 4 + 2] = fmaf(p, v4.z, acc[kk * 4 + 2]);
          acc[kk * 4 + 3] = fmaf(p, v4.w, acc[kk * 4 + 3]);
        }
      }
    }
  }

  if (row < n_out) {
    const float den = fmaxf(l, 1e-30f);
    float* oh = out + row * ld + (long long)h * d;
#pragma unroll
    for (int kk = 0; kk < NC4; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = (part + S * kk) * 4 + u;
        if (f < d) oh[f] = l > 0.f ? acc[kk * 4 + u] / den : 0.f;
      }
  }
}

template <int D, bool UseExp, bool UseMask>
int launch(const int* ptr, const int* cols, const uint8_t* mask,
           const float* q, const float* k, const float* v, float* out,
           int nrb, int H, int d, int n_q, int n_kv, int n_out, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = attention_rows_kernel<D, UseExp, UseMask>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nrb * (TILE / C::ROWS), H);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(ptr, cols, mask, q, k, v, out,
                                             d, n_q, n_kv, n_out, scale);
  return (int)cudaGetLastError();
}

template <bool UseExp, bool UseMask>
int dispatch_width(const int* ptr, const int* cols, const uint8_t* mask,
                   const float* q, const float* k, const float* v,
                   float* out, int nrb, int H, int d, int n_q, int n_kv,
                   int n_out, float scale, cudaStream_t stream) {
  if (d >= 1 && d <= 64)
    return launch<64, UseExp, UseMask>(ptr, cols, mask, q, k, v, out, nrb, H,
                                       d, n_q, n_kv, n_out, scale, stream);
  if (d > 64 && d <= 128)
    return launch<128, UseExp, UseMask>(ptr, cols, mask, q, k, v, out, nrb,
                                        H, d, n_q, n_kv, n_out, scale,
                                        stream);
  if (d > 128 && d <= 256)
    return launch<256, UseExp, UseMask>(ptr, cols, mask, q, k, v, out, nrb,
                                        H, d, n_q, n_kv, n_out, scale,
                                        stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: (n_q, H, d), k/v: (n_kv, H, d), mask: (T, 128, 128)
// -> out: (n_out, H, d), n_out <= nrb * 128, 1 <= d <= 256.
int fused_attention_rows_f32(const int* tile_ptr, const int* tile_cols,
                             const uint8_t* mask, const float* q,
                             const float* k, const float* v, float* out,
                             int nrb, int H, int d, int n_q, int n_kv,
                             int n_out, float scale, int device,
                             cudaStream_t stream) {
  cudaSetDevice(device);
  return dispatch_width<true, true>(tile_ptr, tile_cols, mask, q, k, v, out,
                                    nrb, H, d, n_q, n_kv, n_out, scale,
                                    stream);
}

// S5: as fused_attention_rows_f32, with the exponentials (use_exp) and the
// mask (use_mask) switched on or off.
int attn_variant_f32(const int* tile_ptr, const int* tile_cols,
                     const uint8_t* mask, const float* q, const float* k,
                     const float* v, float* out, int nrb, int H, int d,
                     int n_q, int n_kv, int n_out, float scale, int use_exp,
                     int use_mask, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (use_exp && use_mask)
    return dispatch_width<true, true>(tile_ptr, tile_cols, mask, q, k, v,
                                      out, nrb, H, d, n_q, n_kv, n_out, scale,
                                      stream);
  if (use_exp)
    return dispatch_width<true, false>(tile_ptr, tile_cols, mask, q, k, v,
                                       out, nrb, H, d, n_q, n_kv, n_out,
                                       scale, stream);
  if (use_mask)
    return dispatch_width<false, true>(tile_ptr, tile_cols, mask, q, k, v,
                                       out, nrb, H, d, n_q, n_kv, n_out,
                                       scale, stream);
  return dispatch_width<false, false>(tile_ptr, tile_cols, mask, q, k, v,
                                      out, nrb, H, d, n_q, n_kv, n_out, scale,
                                      stream);
}

}  // extern "C"
