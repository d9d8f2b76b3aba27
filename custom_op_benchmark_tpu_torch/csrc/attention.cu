// Fused block-sparse graph attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels:
//   K4 fused_attention_rows <- custom_op_benchmark_tpu/ops/pallas/attention.py
//   S5 attn_variant         <- scripts/exp_grid_bisect.py (K4 with use_exp /
//                              use_mask switches, a diagnostic)
// with two kernels: attention_mma_kernel (K4 at any head width, f32 or
// bf16, on the tensor cores) and attention_rows_kernel (S5, f32, d <= 256,
// on the CUDA cores).
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
// (4*T*H*128*128*d FLOP) plus 128*128 exponentials per tile; the K/V
// tiles mostly hit L2 because a column block is shared by a few row
// blocks. At d = 64 that is about 90 FLOP per byte moved: above the
// card's ratio for f32 on either the CUDA cores (67 TFLOP/s) or 3xTF32 on
// the tensor cores (495 / 3 = 165 TFLOP/s) against 3.35 TB/s, so the tile
// products bound it, not HBM.
//
// attention_mma_kernel: one block of 8 warps owns a 128-row block and a
// head (and, for d > 128, 128 output features); each warp owns 16 query
// rows. S = Q K^T and acc += P V run as
// mma.sync m16n8k8 in 3xTF32 (mma_async.cuh), so the products are as
// accurate as f32 FMAs. A warp's 16 x 128 scores stay in its accumulator
// registers (no score tile in shared memory): the row max and sum are
// taken over the thread's own 32 values and then across the 4 threads of
// a quad with shuffles. P feeds the second product straight from those
// registers: the C fragment holds keys 2t, 2t+1 where the A fragment wants
// k = t, t+4, so the product runs over keys in the order (0, 2, 4, 6, 1,
// 3, 5, 7) of each 8, and V's B fragment is read in that same order.
// Splitting a B value into TF32 parts takes three instructions, and each
// of the 8 warps reads every K and V value, so splitting in each warp
// bounded the kernel by instruction issue. K and V therefore move in
// 64-feature chunks (a tile's K chunks, then its V chunks) through two
// shared-memory buffers by cp.async, one chunk ahead, and each landed
// chunk is split once, in place, into its hi parts and a lo copy. Q rows
// (stride d + 4 floats), chunks (stride 68) and the mask (144 bytes)
// make every fragment read hit distinct banks; the mask rides with a
// tile's first K chunk and is read as two bytes per row in the
// accumulator's layout. Shared memory: 128 * ((D + 4) + 4 * 68) * 4 +
// 128 * 144 bytes (188 KB at D = 64, 220 KB at D = 128). Exponentials are
// exp2 of log2e-scaled scores. A block writes only its own rows: no
// atomics, results repeat bit for bit.
//
// Heads wider than 128 (WIDE): Q no longer fits shared memory whole, so
// one block computes 128 output features of a row block. For each tile it
// runs ceil(d / 64) K steps, each staging a 64-feature chunk of Q beside
// the chunk of K (Q's fragments are split in registers, as before), then
// the V chunks of its own features; each 8-deep step of the long QK^T sum
// goes into a zeroed fragment and is added in f32. Two buffers of (K hi,
// K lo, Q) take 204 KB. The scores are recomputed by each of the
// ceil(d / 128) blocks of a row block: ceil(d / 128) times K4's QK^T work
// and Q, K reads, for widths no model of the reference uses.
//
// bf16: K and V (and WIDE's Q) chunks land as bf16 in the lo room of a
// buffer and are widened once into the hi room; Q resident is widened as
// it is loaded. QK^T is bf16 x bf16, one TF32 pass; P stays f32, so P V
// takes two (lo*v + hi*v). The output is rounded to bf16 once.
//
// attention_rows_kernel: a row's d features are split across
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

#include "mma_async.cuh"

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

// ---------------------------------------------------------------------------
// attention_mma_kernel: K4 on the tensor cores, any d >= 1, f32 or bf16
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;  // 8 warps x 16 query rows
constexpr int CHUNK = 64;         // features of Q, K or V staged at a time
constexpr int CLD = CHUNK + 4;    // staged chunk row stride, floats
constexpr int WIDE_D = 128;       // output features of a wide block
constexpr float LOG2E = 1.4426950408889634f;

// WIDE = false (d <= 128): Q resident in shared memory, a tile's D / 64 K
// chunks then its D / 64 V chunks. WIDE = true (d > 128): one block per
// 128 output features; a tile's ceil(d / 64) K steps each stage a Q chunk
// beside the K chunk, then the V chunks of the block's features.
template <int D, bool WIDE>
struct MmaCfg {
  static constexpr int QLD = D + 4;         // resident Q row stride, floats
  static constexpr int NC = D / CHUNK;      // K (and V) chunks, not WIDE
  // A buffer: hi [TILE][CLD], lo [TILE][CLD] (bf16: the staged chunks),
  // and WIDE, the Q chunk [TILE][CLD].
  static constexpr int BUF = (WIDE ? 3 : 2) * TILE * CLD;
  static constexpr size_t SMEM =
      sizeof(float) * ((WIDE ? 0 : TILE * QLD) + 2 * BUF) +
      (size_t)TILE * MASK_LD;
};

// scale2 = scale * log2(e). vec: q, k, v rows move as 16-byte copies.
template <typename E, int D, bool WIDE>
__global__ void __launch_bounds__(MMA_THREADS, 1)
attention_mma_kernel(const int* __restrict__ ptr,
                     const int* __restrict__ cols,
                     const uint8_t* __restrict__ mask,
                     const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, E* __restrict__ out, int d,
                     int n_q, int n_kv, int n_out, float scale2, int vec) {
  using C = MmaCfg<D, WIDE>;
  constexpr int QLD = C::QLD, BUF = C::BUF;
  constexpr int QS = WIDE ? CLD : QLD;  // row stride of Q's fragments
  constexpr int NT = D / 8, KEYS8 = TILE / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [TILE][QLD], not WIDE
  float* Bs = Qs + (WIDE ? 0 : TILE * QLD);    // two buffers
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Bs + 2 * BUF);

  const int i = blockIdx.x, h = blockIdx.y;
  const int fo = WIDE ? blockIdx.z * D : 0;  // the block's first feature
  const long long ld = (long long)gridDim.y * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const E* qh = q + (long long)h * d;
  const E* kh = k + (long long)h * d;
  const E* vh = v + (long long)h * d;
  const int lo = ptr[i], hi = ptr[i + 1];
  const int nk = WIDE ? (d + CHUNK - 1) / CHUNK : C::NC;  // K steps
  const int nv = WIDE ? (min(D, d - fo) + CHUNK - 1) / CHUNK : C::NC;
  const int steps = nk + nv;  // a tile's steps

  // The block's copies run in steps: for each tile, its K chunks (with Q
  // chunks, WIDE), then its V chunks, step s into buffer s % 2; the mask
  // rides with a tile's first K chunk. bf16 chunks land in the lo room.
  auto issue = [&](int step) {
    const int t = lo + step / steps, c = step % steps;
    if (t >= hi) return;
    float* buf = Bs + (step % 2) * BUF;
    const long long row = (long long)cols[t] * TILE;
    const bool kstep = c < nk;
    const int f0 = kstep ? c * CHUNK : fo + (c - nk) * CHUNK;
    const E* src = kstep ? kh : vh;
    if constexpr (is_f32<E>) {
      load_rows<TILE, CHUNK, CLD, MMA_THREADS>(buf, src, row, n_kv, f0, d,
                                               ld, vec, tid);
      if (WIDE && kstep)
        load_rows<TILE, CHUNK, CLD, MMA_THREADS>(
            buf + 2 * TILE * CLD, qh, (long long)i * TILE, n_q, f0, d, ld,
            vec, tid);
    } else {
      bf16* st = reinterpret_cast<bf16*>(buf + TILE * CLD);
      load_rows<TILE, CHUNK, CHUNK, MMA_THREADS>(st, src, row, n_kv, f0, d,
                                                 ld, vec, tid);
      if (WIDE && kstep)
        load_rows<TILE, CHUNK, CHUNK, MMA_THREADS>(
            st + TILE * CHUNK, qh, (long long)i * TILE, n_q, f0, d, ld, vec,
            tid);
    }
    if (c == 0)
      load_mask<MMA_THREADS>(Ms, mask + (long long)t * TILE * TILE, tid);
  };

  // This thread's rows of the warp's 16: g (index 0) and g + 8 (index 1).
  float m0 = M_INIT * LOG2E, m1 = M_INIT * LOG2E, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;

  if (lo < hi) {
    if constexpr (!WIDE) {
      if constexpr (is_f32<E>) {
        load_rows<TILE, D, QLD, MMA_THREADS>(Qs, qh, (long long)i * TILE, n_q,
                                             0, d, ld, vec, tid);
      } else {
        // Once per block: widened as it is read.
        for (int e = tid; e < TILE * D; e += MMA_THREADS) {
          const int r = e / D, f = e % D;
          const long long row = (long long)i * TILE + r;
          Qs[r * QLD + f] =
              (row < n_q && f < d) ? to_f32(qh[row * ld + f]) : 0.f;
        }
      }
    }
    issue(0);
    cp_async_commit();
    issue(1);
    cp_async_commit();
  }
  const int kw = g * CLD + t4, vw = 2 * t4 * CLD + g;  // B fragment offsets
  const uint8_t* mw = Ms + (warp * 16 + g) * MASK_LD + 2 * t4;
  const int kd = (d + 7) / 8;  // contraction steps of S; the rest is zero

  float s[KEYS8][4];  // the tile's scores, then its P
  for (int t = lo; t < hi; ++t) {
#pragma unroll
    for (int c = 0; c < steps; ++c) {
      const int step = (t - lo) * steps + c;
      float* bh = Bs + (step % 2) * BUF;
      float* bl = bh + TILE * CLD;
      cp_async_wait<1>();  // this step's chunk (and Q, mask) has landed
      __syncthreads();
      if constexpr (is_f32<E>) {
        split_rows<TILE, CHUNK, CLD, MMA_THREADS>(bh, bl, tid);
      } else {
        const bf16* st = reinterpret_cast<const bf16*>(bl);
        widen_rows<TILE, CHUNK, CHUNK, CLD, MMA_THREADS>(bh, st, tid);
        if (WIDE && c < nk)
          widen_rows<TILE, CHUNK, CHUNK, CLD, MMA_THREADS>(
              bh + 2 * TILE * CLD, st + TILE * CHUNK, tid);
      }
      __syncthreads();

      if (c < nk) {
        // S += Q[:, c*64 : +64] K_c^T.
        if (c == 0) {
#pragma unroll
          for (int j = 0; j < KEYS8; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) s[j][u] = 0.f;
        }
        const float* qw = WIDE ? bh + 2 * TILE * CLD + (warp * 16 + g) * CLD
                               : Qs + (warp * 16 + g) * QLD + c * CHUNK;
        const int kend = min(CHUNK / 8, kd - c * (CHUNK / 8));
        for (int kk = 0; kk < kend; ++kk) {
          const float* qa = qw + t4 + kk * 8;
          uint32_t ah[4], al[4];
          if constexpr (is_f32<E>) {
            split_a(qa[0], qa[8 * QS], qa[4], qa[8 * QS + 4], ah, al);
          } else {
            ah[0] = exact_tf32(qa[0]);
            ah[1] = exact_tf32(qa[8 * QS]);
            ah[2] = exact_tf32(qa[4]);
            ah[3] = exact_tf32(qa[8 * QS + 4]);
          }
          const int kb = kw + kk * 8;
#pragma unroll
          for (int j = 0; j < KEYS8; ++j) {
            const int o = kb + j * 8 * CLD;
            auto qk = [&](float(&dst)[4]) {
              if constexpr (is_f32<E>)
                mma_split(dst, ah, al, bh, bl, o, o + 4);
              else
                mma_tf32(dst, ah, exact_tf32(bh[o]), exact_tf32(bh[o + 4]));
            };
            if constexpr (WIDE) {
              // WIDE contracts up to d in one sum: each 8-deep step is
              // summed apart, then added in f32 (the tensor cores' sums
              // truncate; see K1).
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              qk(part);
#pragma unroll
              for (int u = 0; u < 4; ++u) s[j][u] += part[u];
            } else {
              qk(s[j]);
            }
          }
        }
      }

      if (c == nk - 1) {
        // Scale, mask, the tile's row max (log2 units), and P.
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < KEYS8; ++j) {
          const uint16_t b0 = *reinterpret_cast<const uint16_t*>(mw + 8 * j);
          const uint16_t b1 =
              *reinterpret_cast<const uint16_t*>(mw + 8 * MASK_LD + 8 * j);
          s[j][0] = (b0 & 0xff) ? s[j][0] * scale2 : NEG_INF;
          s[j][1] = (b0 >> 8) ? s[j][1] * scale2 : NEG_INF;
          s[j][2] = (b1 & 0xff) ? s[j][2] * scale2 : NEG_INF;
          s[j][3] = (b1 >> 8) ? s[j][3] * scale2 : NEG_INF;
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, o));
        }
        const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        // l is this thread's share of the row sum; the quad's shares are
        // added at the end (each is scaled by the same corrections).
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < KEYS8; ++j) {
          s[j][0] = exp2f(s[j][0] - m0);
          s[j][1] = exp2f(s[j][1] - m0);
          s[j][2] = exp2f(s[j][2] - m1);
          s[j][3] = exp2f(s[j][3] - m1);
          ps0 += s[j][0] + s[j][1];
          ps1 += s[j][2] + s[j][3];
        }
        l0 = l0 * c0 + ps0;
        l1 = l1 * c1 + ps1;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= c0;
          acc[n][1] *= c0;
          acc[n][2] *= c1;
          acc[n][3] *= c1;
        }
      }

      if (c >= nk) {
        // acc[:, (c-nk)*64 : +64] += P V_c over the tile's keys, 8 at a
        // time in the order (0, 2, 4, 6, 1, 3, 5, 7): a0..a3 of P are c0,
        // c2, c1, c3 of S. P is f32: three passes against f32 V, two
        // against bf16 V.
        auto pv = [&](const int N0) {
#pragma unroll
          for (int j = 0; j < KEYS8; ++j) {
            uint32_t ah[4], al[4];
            split_a(s[j][0], s[j][2], s[j][1], s[j][3], ah, al);
            const int vb = vw + j * 8 * CLD;
#pragma unroll
            for (int n = 0; n < CHUNK / 8; ++n)
              if (fo + (N0 + n) * 8 < d) {
                const int o0 = vb + n * 8, o1 = vb + CLD + n * 8;
                if constexpr (is_f32<E>)
                  mma_split(acc[N0 + n], ah, al, bh, bl, o0, o1);
                else
                  mma_2xtf32(acc[N0 + n], ah, al, exact_tf32(bh[o0]),
                             exact_tf32(bh[o1]));
              }
          }
        };
        // Constant first n-tiles, so acc stays in registers.
        if (c == nk)
          pv(0);
        else
          pv(CHUNK / 8);
      }

      __syncthreads();  // every warp is done with this buffer
      issue(step + 2);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, o);
    l1 += __shfl_xor_sync(FULL, l1, o);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long row0 = (long long)i * TILE + warp * 16 + g, row1 = row0 + 8;
  E* oh = out + (long long)h * d;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = fo + n * 8 + 2 * t4 + u;
      if (f >= d) continue;
      if (row0 < n_out)
        oh[row0 * ld + f] = from_f32<E>(l0 > 0.f ? acc[n][u] / den0 : 0.f);
      if (row1 < n_out)
        oh[row1 * ld + f] =
            from_f32<E>(l1 > 0.f ? acc[n][2 + u] / den1 : 0.f);
    }
}

template <typename E, int D, bool WIDE>
int launch_mma(const int* ptr, const int* cols, const uint8_t* mask,
               const E* q, const E* k, const E* v, E* out, int nrb, int H,
               int d, int n_q, int n_kv, int n_out, float scale, int vec,
               cudaStream_t stream) {
  auto kernel = attention_mma_kernel<E, D, WIDE>;
  const int smem = (int)MmaCfg<D, WIDE>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nrb, H, WIDE ? (d + D - 1) / D : 1);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(ptr, cols, mask, q, k, v, out,
                                             d, n_q, n_kv, n_out,
                                             scale * LOG2E, vec);
  return (int)cudaGetLastError();
}

template <typename E>
int fused_attention(const int* tile_ptr, const int* tile_cols,
                    const uint8_t* mask, const E* q, const E* k, const E* v,
                    E* out, int nrb, int H, int d, int n_q, int n_kv,
                    int n_out, float scale, int vec, int device,
                    cudaStream_t stream) {
  cudaSetDevice(device);
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return launch_mma<E, 64, false>(tile_ptr, tile_cols, mask, q, k, v, out,
                                    nrb, H, d, n_q, n_kv, n_out, scale, vec,
                                    stream);
  if (d <= 128)
    return launch_mma<E, 128, false>(tile_ptr, tile_cols, mask, q, k, v, out,
                                     nrb, H, d, n_q, n_kv, n_out, scale, vec,
                                     stream);
  return launch_mma<E, WIDE_D, true>(tile_ptr, tile_cols, mask, q, k, v, out,
                                     nrb, H, d, n_q, n_kv, n_out, scale, vec,
                                     stream);
}

}  // namespace

extern "C" {

// K4 on the tensor cores. q: (n_q, H, d), k/v: (n_kv, H, d), mask
// (T, 128, 128), 16-byte aligned -> out: (n_out, H, d), n_out <= nrb * 128,
// any d >= 1. vec: q, k, v are 16-byte aligned and their rows are whole
// 16-byte pieces.
int fused_attention_rows_f32(const int* tile_ptr, const int* tile_cols,
                             const uint8_t* mask, const float* q,
                             const float* k, const float* v, float* out,
                             int nrb, int H, int d, int n_q, int n_kv,
                             int n_out, float scale, int vec, int device,
                             cudaStream_t stream) {
  return fused_attention(tile_ptr, tile_cols, mask, q, k, v, out, nrb, H, d,
                         n_q, n_kv, n_out, scale, vec, device, stream);
}

int fused_attention_rows_bf16(const int* tile_ptr, const int* tile_cols,
                              const uint8_t* mask, const bf16* q,
                              const bf16* k, const bf16* v, bf16* out,
                              int nrb, int H, int d, int n_q, int n_kv,
                              int n_out, float scale, int vec, int device,
                              cudaStream_t stream) {
  return fused_attention(tile_ptr, tile_cols, mask, q, k, v, out, nrb, H, d,
                         n_q, n_kv, n_out, scale, vec, device, stream);
}

// S5 on attention_rows_kernel, 1 <= d <= 256, with the exponentials
// (use_exp) and the mask (use_mask) switched on or off; with both on it is
// K4 on the CUDA cores (for 128 < d <= 256).
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
