// Fused block-sparse graph attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels:
//   K4 fused_attention_rows <- custom_op_benchmark_tpu/ops/pallas/attention.py
//   S5 attn_variant         <- scripts/exp_grid_bisect.py (K4 with use_exp /
//                              use_mask switches, a diagnostic)
// with two kernels on the tensor cores: attention_mma_kernel, K4 in f32 at
// any head width, and S5 as the same kernel with its UseExp / UseMask
// template switches (with both on, the same instantiation as K4); and
// attention_bf16_kernel, K4 in bf16.
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
// function. UseExp keeps s and m in log2 units (scores times scale * log2e,
// then exp2); !UseExp keeps them in natural units.
//
// What bounds it on this card: two 128x128xd tile products per tile
// (4*T*H*128*128*d FLOP) plus 128*128 exponentials per tile; the K/V
// tiles mostly hit L2 because a column block is shared by a few row
// blocks. At d = 64 that is about 90 FLOP per byte moved: above the
// card's ratio for f32 on either the CUDA cores (67 TFLOP/s) or 3xTF32 on
// the tensor cores (495 / 3 = 165 TFLOP/s) against 3.35 TB/s, so the tile
// products bound it, not HBM.
//
// One block of 8 warps owns a 128-row block and a head (and, for d > 128,
// a 64- or 128-feature slice); each warp owns 16 query rows. In f32, S =
// Q K^T and acc += P V run as mma.sync m16n8k8 in 3xTF32 (mma_async.cuh),
// so the products are as accurate as f32 FMAs. A warp's 16 x 128 scores stay in
// its accumulator registers: the row max and sum are taken over the
// thread's own 32 values and then across the 4 threads of a quad with
// shuffles. P feeds the second product straight from those registers: the
// C fragment holds keys 2t, 2t+1 where the A fragment wants k = t, t+4, so
// the product runs over keys in the order (0, 2, 4, 6, 1, 3, 5, 7) of each
// 8, and V's B fragment is read in that same order. Splitting a B value
// into TF32 parts takes three instructions, and each of the 8 warps reads
// every K and V value, so splitting in each warp bounded the kernel by
// instruction issue. K and V therefore move in 64-feature chunks (a
// tile's K chunks, then its V chunks) through two shared-memory buffers by
// cp.async, one chunk ahead, and each landed chunk is split once, in
// place, into its hi parts and a lo copy. Q rows (stride D + 4 floats),
// chunks (stride 68) and the mask (144 bytes) make every fragment read hit
// distinct banks; the mask rides with a tile's first K chunk and is read as
// two bytes per row in the accumulator's layout. Shared memory: 128 *
// ((D + 4) + 4 * 68) * 4 + 128 * 144 bytes (188 KB at D = 64, 220 KB at
// D = 128). A block writes only its own rows: no atomics, results repeat
// bit for bit.
//
// Heads up to 128 wide (CLUSTER = false): Q is resident whole, and the
// block contracts over all d features and writes all d outputs.
//
// Wider heads (CLUSTER = true): a thread block cluster of C blocks (at most
// 8, the portable size) per row block and head, each owning a slice of
// D = 64 features (d <= 512, C = ceil(d / 64)) or 128 (C = ceil(d / 128)),
// so that each tile's scores are computed once and each block's chain of
// steps a tile is short: the 300-node graph has only a few row blocks, so
// that chain, not the card's throughput, sets the time. Block b keeps Q's
// features [Db, Db + D) resident, stages only those features of K and V,
// and writes those output features. Per tile it computes its share of
// QK^T (each 8-deep step summed apart in a zeroed fragment and added in
// f32: the tensor cores' sums truncate, see K1) and stores it in the
// buffer of its last K chunk (128 x 136 floats); the C shares are then
// summed across the cluster through distributed shared memory, in a
// fixed order of rank: a reduce-scatter (block b sums rows [b*R, b*R +
// R), R = ceil(128 / C), of every block's share, rank 0 first, its loads
// from all ranks in flight together) and an all-gather (each thread reads
// its fragment's rows from their owner), separated by cluster barriers.
// That moves 2 (C - 1) / C x 64 KB per block and tile between SMs in
// place of C - 1 recomputations of QK^T. Peers address each other's
// buffer by their own offset, so every block of a cluster takes the same
// steps a tile (chunks past d load zeros and take no product). Every
// block then applies the same mask, scale, max and exp2 to the same
// sums, so m and l agree bit for bit across the cluster, and runs P V for
// its own features. Heads wider than 1024 take ceil(d / 1024) clusters of
// 8 per row block, cluster z owning output slices 8z .. 8z + 7; each
// cluster computes its own scores (block b contracts over slices b, b +
// 8, ..., reloading its resident Q slice for each: correct, not tuned).
//
// bf16 (attention_bf16_kernel): the same blocks, warps, steps, softmax and
// cluster exchange on native bf16 products, mma.sync m16n8k16 .bf16 with
// f32 accumulators, every fragment read from a bf16 stage by ldmatrix;
// nothing is widened. Q stays resident as bf16 ([128][D + 8]); K and V
// chunks stay bf16 ([128][64 + 8], 144-byte rows) in a ring of cp.async
// stages, so a step takes one barrier (the f32 kernel takes three, two of
// them for its split pass). QK^T: per 16-deep step one ldmatrix.x4 gives
// the warp's A fragment and one (not transposed: K's rows are keys, n)
// the B fragments of two 8-key n-tiles. P V needs no trip through shared
// memory and no key permutation: the accumulators of keys 16m .. 16m + 7
// and 16m + 8 .. 16m + 15 are, in their natural order, the m16n8k16 A
// fragment of keys 16m .. 16m + 15. P is not rounded to one bf16, whose
// error (up to 2^-8 of p, against values of either sign) fails the
// per-element gate where an output cancels to near 0: it goes as hi =
// bf16(p) and lo = bf16(p - hi), two k16 passes (lo * v, then hi * v),
// good to 2^-16 of p; m, l and the row sums use the f32 p. V's B
// fragments come by ldmatrix.trans (V's rows are the contraction keys).
// The resident form sums QK^T in the mma; the cluster form sums each
// 16-deep step apart and adds it in f32, and exchanges its f32 scores in
// a region of its own.
// Shared memory: 72 KB at D = 64 (two blocks an SM), 88 KB at D = 128,
// plus 68 KB of exchange in the cluster form. The output is rounded to
// bf16 once and stored as 4-byte pairs.
//
// Layouts: q, k, v and out are (n, H, d) contiguous, read in place per
// head; rows at or past n, and features at or past d, read as zero. The
// mask is (T, 128, 128) bytes shared by every head. Indices are int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_async.cuh"

namespace {

constexpr int TILE = 128;         // tile_r == tile_c
constexpr int MMA_THREADS = 256;  // 8 warps x 16 query rows
constexpr int CHUNK = 64;         // features of K or V staged at a time
constexpr int CLD = CHUNK + 4;    // staged chunk row stride, floats
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int SLD = 2 * CLD;      // row stride of an exchanged score tile
constexpr float NEG_INF = -1e30f;
constexpr float M_INIT = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct MmaCfg {
  static constexpr int QLD = D + 4;     // resident Q row stride, floats
  static constexpr int NC = D / CHUNK;  // K (and V) chunks a slice
  // A buffer: hi [TILE][CLD], lo [TILE][CLD].
  static constexpr int BUF = 2 * TILE * CLD;
  static constexpr size_t SMEM =
      sizeof(float) * (TILE * QLD + 2 * BUF) + (size_t)TILE * MASK_LD;
};
static_assert(TILE * SLD <= MmaCfg<CHUNK>::BUF,
              "a score tile fits one chunk buffer");

// bf16: Q resident [TILE][QLD], a ring of STAGES chunks [TILE][BLD] (144-
// byte rows: ldmatrix's 8 rows of a phase on distinct bank groups), MASKS
// mask buffers and, for the cluster form, the score exchange [TILE][SLD]
// floats. One mask buffer is enough when the next tile's mask is copied
// after this tile's softmax step (a tile's V steps NC >= STAGES - 1). The
// resident form at D = 64 runs two blocks an SM (at most 128 registers a
// thread); D = 128 (acc and s alone are 128 floats) and the cluster form
// run one.
constexpr int BLD = CHUNK + 8;    // staged bf16 chunk row stride

template <int D, bool CLUSTER>
struct BfCfg {
  static constexpr int QLD = D + 8;
  static constexpr int NC = D / CHUNK;
  static constexpr int STAGES = 2;
  static constexpr int MASKS = NC >= STAGES - 1 ? 1 : 2;
  static constexpr int BLOCKS = !CLUSTER && D == 64 ? 2 : 1;
  static constexpr size_t SMEM =
      sizeof(bf16) * (TILE * QLD + STAGES * TILE * BLD) +
      (size_t)MASKS * TILE * MASK_LD +
      (CLUSTER ? sizeof(float) * TILE * SLD : 0);
};

// Cluster barriers (every thread of every block of the cluster arrives;
// arrive releases, wait acquires, at cluster scope).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// p's counterpart in the shared memory of block `rank` of this cluster.
__device__ __forceinline__ const float* peer(const float* p, int rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// s (a warp's 16 x 128 scores in accumulator layout, rows row0 and
// row0 + 8 of this thread) becomes the sum over the cluster's cl blocks of
// their s, in order of rank, through buf (TILE x SLD floats at the same
// offset in every block): each block stores its s; block b sums rows
// [b * rpc, b * rpc + rpc) of every block's share, its loads from all
// ranks in flight together (at most 8 float4 a thread); every thread then
// reads its rows' sums from their owners. Ends with this block's arrival
// at a cluster barrier: wait on it before buf is written again.
__device__ __forceinline__ void cluster_sum_scores(float (&s)[TILE / 8][4],
                                                   float* buf, int b, int cl,
                                                   int tid, int row0,
                                                   int t4) {
  constexpr int KEYS8 = TILE / 8, ROW4 = TILE / 4;
  constexpr int PER = TILE * ROW4 / 2 / MMA_THREADS;  // cl >= 2
  float* sw = buf + row0 * SLD + 2 * t4;
#pragma unroll
  for (int j = 0; j < KEYS8; ++j) {
    store2(sw + 8 * j, s[j][0], s[j][1]);
    store2(sw + 8 * SLD + 8 * j, s[j][2], s[j][3]);
  }
  cluster_arrive();
  cluster_wait();
  // Reduce-scatter.
  const int rpc = (TILE + cl - 1) / cl;
  const int r0 = b * rpc, n4 = (min(TILE, r0 + rpc) - r0) * ROW4;
  float4 sum[PER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) {
    if (r >= cl) break;
    const float* src = peer(buf, r);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * MMA_THREADS;
      if (e >= n4) break;
      const float4 x = *reinterpret_cast<const float4*>(
          src + (r0 + e / ROW4) * SLD + (e % ROW4) * 4);
      if (r == 0) {
        sum[u] = x;
      } else {
        sum[u].x += x.x;
        sum[u].y += x.y;
        sum[u].z += x.z;
        sum[u].w += x.w;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * MMA_THREADS;
    if (e >= n4) break;
    *reinterpret_cast<float4*>(buf + (r0 + e / ROW4) * SLD + (e % ROW4) * 4) =
        sum[u];
  }
  cluster_arrive();
  cluster_wait();
  // All-gather.
  const float* s0 = peer(buf, row0 / rpc) + row0 * SLD + 2 * t4;
  const float* s1 = peer(buf, (row0 + 8) / rpc) + (row0 + 8) * SLD + 2 * t4;
#pragma unroll
  for (int j = 0; j < KEYS8; ++j) {
    const float2 x0 = *reinterpret_cast<const float2*>(s0 + 8 * j);
    const float2 x1 = *reinterpret_cast<const float2*>(s1 + 8 * j);
    s[j][0] = x0.x;
    s[j][1] = x0.y;
    s[j][2] = x1.x;
    s[j][3] = x1.y;
  }
  cluster_arrive();
}

// scale2: scale times log2(e) (UseExp) or scale. vec: q, k, v rows move as
// 16-byte copies. cl: blocks per cluster (CLUSTER), each owning D
// features; gridDim.z clusters per row block.
template <int D, bool CLUSTER, bool UseExp, bool UseMask>
__global__ void __launch_bounds__(MMA_THREADS, 1)
attention_mma_kernel(const int* __restrict__ ptr,
                     const int* __restrict__ cols,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int d,
                     int n_q, int n_kv, int n_out, float scale2, int vec,
                     int cl) {
  using C = MmaCfg<D>;
  constexpr int QLD = C::QLD, BUF = C::BUF, NC = C::NC;
  constexpr int NT = D / 8, KEYS8 = TILE / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [TILE][QLD]
  float* Bs = Qs + TILE * QLD;                 // two buffers
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Bs + 2 * BUF);

  // CLUSTER: block b (its rank) contracts over slices b, b + cl, ... of
  // the d features and writes output slice cl * blockIdx.z + b.
  const int b = CLUSTER ? blockIdx.x % cl : 0;
  const int i = CLUSTER ? blockIdx.x / cl : blockIdx.x, h = blockIdx.y;
  const int fo = CLUSTER ? (cl * blockIdx.z + b) * D : 0;
  const long long ld = (long long)gridDim.y * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float* qh = q + (long long)h * d;
  const float* kh = k + (long long)h * d;
  const float* vh = v + (long long)h * d;
  const int lo = ptr[i], hi = ptr[i + 1];
  // K steps: NC a contraction slice; V steps: NC. CLUSTER: every block
  // takes as many slices as the cluster's first (past d they load zeros
  // and take no product), so all exchange in the same buffer.
  const int nsl = CLUSTER ? ((d + D - 1) / D + cl - 1) / cl : 1;
  const int nk = NC * nsl, nv = NC;
  const int steps = nk + nv;  // a tile's steps
  // The first feature of K step c.
  auto kfeat = [&](int c) {
    return CLUSTER ? (b + cl * (c / NC)) * D + (c % NC) * CHUNK : c * CHUNK;
  };

  // The block's copies run in steps: for each tile, its K chunks, then its
  // V chunks, step s into buffer s % 2; the mask rides with a tile's first
  // K chunk.
  auto issue = [&](int step) {
    const int t = lo + step / steps, c = step % steps;
    if (t >= hi) return;
    float* buf = Bs + (step % 2) * BUF;
    const long long row = (long long)cols[t] * TILE;
    const bool kstep = c < nk;
    const int f0 = kstep ? kfeat(c) : fo + (c - nk) * CHUNK;
    load_rows<TILE, CHUNK, CLD, MMA_THREADS>(buf, kstep ? kh : vh, row, n_kv,
                                             f0, d, ld, vec, tid);
    if (UseMask && c == 0)
      load_mask<MMA_THREADS>(Ms, mask + (long long)t * TILE * TILE, tid);
  };
  // Q's rows of the row block, features f0 .. f0 + D - 1, read by plain
  // loads (visible after the next barrier).
  auto load_q = [&](int f0) {
    for (int e = tid; e < TILE * D; e += MMA_THREADS) {
      const int r = e / D, f = e % D;
      const long long row = (long long)i * TILE + r;
      Qs[r * QLD + f] =
          (row < n_q && f0 + f < d) ? qh[row * ld + f0 + f] : 0.f;
    }
  };

  // This thread's rows of the warp's 16: g (index 0) and g + 8 (index 1).
  constexpr float m_init = UseExp ? M_INIT * LOG2E : M_INIT;
  float m0 = m_init, m1 = m_init, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;

  if (lo < hi) {
    load_rows<TILE, D, QLD, MMA_THREADS>(Qs, qh, (long long)i * TILE, n_q,
                                         kfeat(0), d, ld, vec, tid);
    issue(0);
    cp_async_commit();
    issue(1);
    cp_async_commit();
  }
  const int kw = g * CLD + t4, vw = 2 * t4 * CLD + g;  // B fragment offsets
  const uint8_t* mw = Ms + (warp * 16 + g) * MASK_LD + 2 * t4;
  const int row0 = warp * 16 + g;  // this thread's first row of the tile
  const int kd = (d + 7) / 8;      // contraction steps of S; the rest is 0

  float s[KEYS8][4];  // the tile's scores, then its P
  for (int t = lo; t < hi; ++t) {
#pragma unroll
    for (int c = 0; c < steps; ++c) {
      const int step = (t - lo) * steps + c;
      float* bh = Bs + (step % 2) * BUF;
      float* bl = bh + TILE * CLD;
      cp_async_wait<1>();  // this step's chunk (and Q, mask) has landed
      __syncthreads();
      // Heads wider than 1024: the next contraction slice's Q.
      if (CLUSTER && nsl > 1 && c < nk && c % NC == 0) load_q(kfeat(c));
      split_rows<TILE, CHUNK, CLD, MMA_THREADS>(bh, bl, tid);
      __syncthreads();

      if (c < nk) {
        // S += Q[:, f : f + 64] K_c^T, f = kfeat(c).
        if (c == 0) {
#pragma unroll
          for (int j = 0; j < KEYS8; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) s[j][u] = 0.f;
        }
        const float* qw =
            Qs + row0 * QLD + (CLUSTER ? c % NC : c) * CHUNK + t4;
        const int kend = min(CHUNK / 8, kd - kfeat(c) / 8);
        for (int kk = 0; kk < kend; ++kk) {
          const float* qa = qw + kk * 8;
          uint32_t ah[4], al[4];
          split_a(qa[0], qa[8 * QLD], qa[4], qa[8 * QLD + 4], ah, al);
          const int kb = kw + kk * 8;
#pragma unroll
          for (int j = 0; j < KEYS8; ++j) {
            const int o = kb + j * 8 * CLD;
            auto qk = [&](float(&dst)[4]) {
              mma_split(dst, ah, al, bh, bl, o, o + 4);
            };
            if constexpr (CLUSTER) {
              // Each 8-deep step is summed apart, then added in f32.
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
        if constexpr (CLUSTER) {
          // The cluster's sum of every block's share, into s: this
          // block's share goes to the buffer it just read K from (the same
          // buffer in every block of the cluster).
          __syncthreads();
          cluster_sum_scores(s, bh, b, cl, tid, row0, t4);
        }

        // Scale, mask, the tile's row max, and P.
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < KEYS8; ++j) {
          if constexpr (UseMask) {
            const uint16_t b0 = *reinterpret_cast<const uint16_t*>(mw + 8 * j);
            const uint16_t b1 =
                *reinterpret_cast<const uint16_t*>(mw + 8 * MASK_LD + 8 * j);
            s[j][0] = (b0 & 0xff) ? s[j][0] * scale2 : NEG_INF;
            s[j][1] = (b0 >> 8) ? s[j][1] * scale2 : NEG_INF;
            s[j][2] = (b1 & 0xff) ? s[j][2] * scale2 : NEG_INF;
            s[j][3] = (b1 >> 8) ? s[j][3] * scale2 : NEG_INF;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) s[j][u] *= scale2;
          }
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, o));
        }
        const float c0 = UseExp ? exp2f(m0 - mx0) : m0 - mx0;
        const float c1 = UseExp ? exp2f(m1 - mx1) : m1 - mx1;
        m0 = mx0;
        m1 = mx1;
        // l is this thread's share of the row sum; the quad's shares are
        // added at the end (each is scaled by the same corrections).
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < KEYS8; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            s[j][u] = UseExp ? exp2f(s[j][u] - m0) : s[j][u] - m0;
            s[j][2 + u] = UseExp ? exp2f(s[j][2 + u] - m1) : s[j][2 + u] - m1;
          }
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
        // c2, c1, c3 of S, three passes.
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
                mma_split(acc[N0 + n], ah, al, bh, bl, o0, o1);
              }
          }
        };
        // Constant first n-tiles, so acc stays in registers.
        if constexpr (NC == 1)
          pv(0);
        else if (c == nk)
          pv(0);
        else
          pv(CHUNK / 8);
      }

      if (CLUSTER && c == nk - 1) {
        cluster_wait();  // every block of the cluster is done with bh
        // One chunk a slice: step + 2 is the next tile's first, whose copy
        // overwrites the mask this block's warps have just read (after
        // their last cluster arrival).
        if (UseMask && NC == 1) __syncthreads();
      } else {
        __syncthreads();  // every warp is done with this buffer
      }
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
  const long long r0 = (long long)i * TILE + row0, r1 = r0 + 8;
  float* oh = out + (long long)h * d;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = fo + n * 8 + 2 * t4 + u;
      if (f >= d) continue;
      if (r0 < n_out)
        oh[r0 * ld + f] = l0 > 0.f ? acc[n][u] / den0 : 0.f;
      if (r1 < n_out)
        oh[r1 * ld + f] = l1 > 0.f ? acc[n][2 + u] / den1 : 0.f;
    }
}

// K4 in bf16: the f32 kernel's blocks, warps, steps, online softmax and
// cluster exchange, on native bf16 products (BfCfg above). scale2: scale
// times log2(e).
template <int D, bool CLUSTER>
__global__ void __launch_bounds__(MMA_THREADS, BfCfg<D, CLUSTER>::BLOCKS)
attention_bf16_kernel(const int* __restrict__ ptr,
                      const int* __restrict__ cols,
                      const uint8_t* __restrict__ mask,
                      const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int d, int n_q, int n_kv, int n_out, float scale2,
                      int vec, int cl) {
  using C = BfCfg<D, CLUSTER>;
  constexpr int QLD = C::QLD, NC = C::NC, NS = C::STAGES;
  constexpr int NT = D / 8, KEYS8 = TILE / 8, KEYS16 = TILE / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);    // [TILE][QLD]
  bf16* ring = Qs + TILE * QLD;                // NS chunks [TILE][BLD]
  uint8_t* Ms = reinterpret_cast<uint8_t*>(ring + NS * TILE * BLD);
  float* Xs = reinterpret_cast<float*>(Ms + C::MASKS * TILE * MASK_LD);

  const int b = CLUSTER ? blockIdx.x % cl : 0;
  const int i = CLUSTER ? blockIdx.x / cl : blockIdx.x, h = blockIdx.y;
  const int fo = CLUSTER ? (cl * blockIdx.z + b) * D : 0;
  const long long ld = (long long)gridDim.y * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bf16* qh = q + (long long)h * d;
  const bf16* kh = k + (long long)h * d;
  const bf16* vh = v + (long long)h * d;
  const int lo = ptr[i], hi = ptr[i + 1];
  const int nsl = CLUSTER ? ((d + D - 1) / D + cl - 1) / cl : 1;
  const int nk = NC * nsl, nv = NC;
  const int steps = nk + nv;
  auto kfeat = [&](int c) {
    return CLUSTER ? (b + cl * (c / NC)) * D + (c % NC) * CHUNK : c * CHUNK;
  };

  // Step s of the block's copies (a tile's K chunks, then its V chunks)
  // into stage s % NS; the mask rides with a tile's first K chunk, into
  // mask buffer (tile - lo) % MASKS.
  auto issue = [&](int step) {
    const int t = lo + step / steps, c = step % steps;
    if (t >= hi) return;
    bf16* st = ring + (step % NS) * TILE * BLD;
    const bool kstep = c < nk;
    load_rows<TILE, CHUNK, BLD, MMA_THREADS>(
        st, kstep ? kh : vh, (long long)cols[t] * TILE, n_kv,
        kstep ? kfeat(c) : fo + (c - nk) * CHUNK, d, ld, vec, tid);
    if (c == 0)
      load_mask<MMA_THREADS>(Ms + ((t - lo) % C::MASKS) * TILE * MASK_LD,
                             mask + (long long)t * TILE * TILE, tid);
  };

  float m0 = M_INIT * LOG2E, m1 = M_INIT * LOG2E, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;

  if (lo < hi) {
    // Q's slice rides with step 0's copies.
    load_rows<TILE, D, QLD, MMA_THREADS>(Qs, qh, (long long)i * TILE, n_q,
                                         kfeat(0), d, ld, vec, tid);
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      issue(s);
      cp_async_commit();
    }
  }
  // This lane's ldmatrix rows (mma_async.cuh): Q's rows m, m + 8 and
  // feature halves k, k + 8; K's rows (keys, n) n, n + 8 of an n-tile pair
  // and feature halves; V's rows (keys, k) k, k + 8 and feature halves
  // (n) of an n-tile pair.
  const int r8 = lane % 8, h8 = (lane / 8) % 2, q16 = lane / 16;
  const bf16* qw = Qs + (warp * 16 + r8 + 8 * h8) * QLD + 8 * q16;
  const int ko = (r8 + 8 * q16) * BLD + 8 * h8;
  const int vo = (r8 + 8 * h8) * BLD + 8 * q16;
  const int row0 = warp * 16 + g;  // this thread's first row of the tile
  const int kd = (d + 15) / 16;    // contraction steps of S; the rest is 0

  float s[KEYS8][4];             // the tile's scores, then its P
  uint32_t ph[KEYS16][4], pl[KEYS16][4];  // P's A fragments, hi and lo
  for (int t = lo; t < hi; ++t) {
    const uint8_t* mw = Ms + ((t - lo) % C::MASKS) * TILE * MASK_LD +
                        row0 * MASK_LD + 2 * t4;
#pragma unroll
    for (int c = 0; c < steps; ++c) {
      const int step = (t - lo) * steps + c;
      cp_async_wait<NS - 2>();  // this step's chunk (and Q, mask) landed
      __syncthreads();  // and every warp is done with the last step's stage
      issue(step + NS - 1);
      cp_async_commit();
      // Heads wider than 1024: this contraction slice's Q.
      if (CLUSTER && nsl > 1 && c < nk && c % NC == 0 && step > 0) {
        load_rows<TILE, D, QLD, MMA_THREADS>(Qs, qh, (long long)i * TILE,
                                             n_q, kfeat(c), d, ld, vec, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const bf16* st = ring + (step % NS) * TILE * BLD;

      if (c < nk) {
        // S += Q[:, f : f + 64] K_c^T, f = kfeat(c), 16 features a step.
        if (c == 0) {
#pragma unroll
          for (int j = 0; j < KEYS8; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) s[j][u] = 0.f;
        }
        const int kend = min(CHUNK / 16, kd - kfeat(c) / 16);
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk) {
          if (kk >= kend) break;
          uint32_t a[4];
          ldsm_x4(a, qw + (c % NC) * CHUNK + 16 * kk);
#pragma unroll
          for (int p = 0; p < KEYS16; ++p) {
            uint32_t bk[4];
            ldsm_x4(bk, st + ko + 16 * p * BLD + 16 * kk);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if constexpr (CLUSTER) {
                // Each 16-deep step is summed apart, then added in f32.
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(part, a, bk[2 * e], bk[2 * e + 1]);
#pragma unroll
                for (int u = 0; u < 4; ++u) s[2 * p + e][u] += part[u];
              } else {
                mma_bf16(s[2 * p + e], a, bk[2 * e], bk[2 * e + 1]);
              }
            }
          }
        }
      }

      if (c == nk - 1) {
        // The cluster's sum of every block's share, into s.
        if constexpr (CLUSTER)
          cluster_sum_scores(s, Xs, b, cl, tid, row0, t4);

        // Scale, mask, the tile's row max, and P.
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
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < KEYS8; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            s[j][u] = exp2f(s[j][u] - m0);
            s[j][2 + u] = exp2f(s[j][2 + u] - m1);
          }
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
        // The accumulators of keys 16m .. 16m + 7 and 16m + 8 .. 16m + 15
        // are, in order, the m16n8k16 A fragment of keys 16m .. 16m + 15:
        // (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..). P
        // goes as two bf16 parts, hi and lo.
#pragma unroll
        for (int m = 0; m < KEYS16; ++m) {
          split_bf16x2(s[2 * m][0], s[2 * m][1], ph[m][0], pl[m][0]);
          split_bf16x2(s[2 * m][2], s[2 * m][3], ph[m][1], pl[m][1]);
          split_bf16x2(s[2 * m + 1][0], s[2 * m + 1][1], ph[m][2], pl[m][2]);
          split_bf16x2(s[2 * m + 1][2], s[2 * m + 1][3], ph[m][3], pl[m][3]);
        }
      }

      if (c >= nk) {
        // acc[:, (c-nk)*64 : +64] += P V_c over the tile's keys, 16 at a
        // time: lo * v, then hi * v.
        auto pv = [&](const int N0) {
#pragma unroll
          for (int m = 0; m < KEYS16; ++m)
#pragma unroll
            for (int nj = 0; nj < CHUNK / 16; ++nj)
              if (fo + (N0 + 2 * nj) * 8 < d) {
                uint32_t bv[4];
                ldsm_x4_trans(bv, st + vo + 16 * m * BLD + 16 * nj);
                mma_bf16(acc[N0 + 2 * nj], pl[m], bv[0], bv[1]);
                mma_bf16(acc[N0 + 2 * nj], ph[m], bv[0], bv[1]);
                mma_bf16(acc[N0 + 2 * nj + 1], pl[m], bv[2], bv[3]);
                mma_bf16(acc[N0 + 2 * nj + 1], ph[m], bv[2], bv[3]);
              }
        };
        // Constant first n-tiles, so acc stays in registers.
        if constexpr (NC == 1)
          pv(0);
        else if (c == nk)
          pv(0);
        else
          pv(CHUNK / 8);
      }

      // Every block of the cluster is done with Xs before it is written
      // again (and before any block exits).
      if (CLUSTER && c == nk - 1) cluster_wait();
    }
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, o);
    l1 += __shfl_xor_sync(FULL, l1, o);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long r0 = (long long)i * TILE + row0, r1 = r0 + 8;
  bf16* oh = out + (long long)h * d;
  // A row's two values as one 4-byte pair where both lie below d and the
  // pair is 4-byte aligned, else each alone.
  auto put = [&](long long r, int f, float x, float y) {
    if (r >= n_out) return;
    bf16* p = oh + r * ld + f;
    if (f + 1 < d && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      store2(p, x, y);
    } else {
      p[0] = from_f32<bf16>(x);
      if (f + 1 < d) p[1] = from_f32<bf16>(y);
    }
  };
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int f = fo + n * 8 + 2 * t4;
    if (f >= d) continue;
    put(r0, f, l0 > 0.f ? acc[n][0] / den0 : 0.f,
        l0 > 0.f ? acc[n][1] / den0 : 0.f);
    put(r1, f, l1 > 0.f ? acc[n][2] / den1 : 0.f,
        l1 > 0.f ? acc[n][3] / den1 : 0.f);
  }
}

template <typename E, int D, bool CLUSTER, bool UseExp, bool UseMask>
auto kernel_for() {
  if constexpr (is_f32<E>)
    return attention_mma_kernel<D, CLUSTER, UseExp, UseMask>;
  else
    return attention_bf16_kernel<D, CLUSTER>;
}

template <typename E, int D, bool CLUSTER, bool UseExp, bool UseMask>
int launch(const int* ptr, const int* cols, const uint8_t* mask, const E* q,
           const E* k, const E* v, E* out, int nrb, int H, int d, int n_q,
           int n_kv, int n_out, float scale, int vec, int cl, int clusters,
           cudaStream_t stream) {
  static_assert(is_f32<E> || (UseExp && UseMask), "bf16 is K4 only");
  auto kernel = kernel_for<E, D, CLUSTER, UseExp, UseMask>();
  const int smem =
      (int)(is_f32<E> ? MmaCfg<D>::SMEM : BfCfg<D, CLUSTER>::SMEM);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && !is_f32<E>)  // room for two blocks an SM
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nrb * cl, H, clusters);
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, ptr, cols, mask, q, k, v, out, d,
                           n_q, n_kv, n_out,
                           UseExp ? scale * LOG2E : scale, vec, cl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The layout (cl blocks a cluster, `clusters` clusters a row block, `width`
// features a block) comes from the caller (ops/kernels/attention.py
// kernel_route): cl = 1 is the resident form (d <= width); otherwise
// 2 <= cl <= 8 blocks of `width` features, at most as many as d has
// slices, and just enough clusters to cover d.
template <typename E, bool UseExp, bool UseMask>
int attention(const int* tile_ptr, const int* tile_cols, const uint8_t* mask,
              const E* q, const E* k, const E* v, E* out, int nrb, int H,
              int d, int n_q, int n_kv, int n_out, float scale, int vec,
              int cl, int clusters, int width, int device,
              cudaStream_t stream) {
  cudaSetDevice(device);
  if (d < 1 || cl < 1 || cl > MAX_CLUSTER || clusters < 1 ||
      (width != 64 && width != 128))
    return (int)cudaErrorInvalidValue;
  const int slices = (d + width - 1) / width;
  if (cl == 1) {
    if (d > width || clusters != 1) return (int)cudaErrorInvalidValue;
    if (width == 64)
      return launch<E, 64, false, UseExp, UseMask>(
          tile_ptr, tile_cols, mask, q, k, v, out, nrb, H, d, n_q, n_kv,
          n_out, scale, vec, 1, 1, stream);
    return launch<E, 128, false, UseExp, UseMask>(
        tile_ptr, tile_cols, mask, q, k, v, out, nrb, H, d, n_q, n_kv, n_out,
        scale, vec, 1, 1, stream);
  }
  // Every block has a contraction slice, and every cluster an output one.
  if (d <= 128 || cl > slices || clusters != (slices + cl - 1) / cl)
    return (int)cudaErrorInvalidValue;
  if (width == 64)
    return launch<E, 64, true, UseExp, UseMask>(
        tile_ptr, tile_cols, mask, q, k, v, out, nrb, H, d, n_q, n_kv, n_out,
        scale, vec, cl, clusters, stream);
  return launch<E, 128, true, UseExp, UseMask>(
      tile_ptr, tile_cols, mask, q, k, v, out, nrb, H, d, n_q, n_kv, n_out,
      scale, vec, cl, clusters, stream);
}

}  // namespace

extern "C" {

// K4. q: (n_q, H, d), k/v: (n_kv, H, d), mask (T, 128, 128), 16-byte
// aligned -> out: (n_out, H, d), n_out <= nrb * 128, any d >= 1. vec: q,
// k, v are 16-byte aligned and their rows are whole 16-byte pieces.
// cluster, clusters, width: the launch layout of kernel_route(d).
int fused_attention_rows_f32(const int* tile_ptr, const int* tile_cols,
                             const uint8_t* mask, const float* q,
                             const float* k, const float* v, float* out,
                             int nrb, int H, int d, int n_q, int n_kv,
                             int n_out, float scale, int vec, int cluster,
                             int clusters, int width, int device,
                             cudaStream_t stream) {
  return attention<float, true, true>(tile_ptr, tile_cols, mask, q, k, v,
                                      out, nrb, H, d, n_q, n_kv, n_out, scale,
                                      vec, cluster, clusters, width, device,
                                      stream);
}

int fused_attention_rows_bf16(const int* tile_ptr, const int* tile_cols,
                              const uint8_t* mask, const bf16* q,
                              const bf16* k, const bf16* v, bf16* out,
                              int nrb, int H, int d, int n_q, int n_kv,
                              int n_out, float scale, int vec, int cluster,
                              int clusters, int width, int device,
                              cudaStream_t stream) {
  return attention<bf16, true, true>(tile_ptr, tile_cols, mask, q, k, v, out,
                                     nrb, H, d, n_q, n_kv, n_out, scale, vec,
                                     cluster, clusters, width, device, stream);
}

// S5: K4 in f32 with the exponentials (use_exp) and the mask (use_mask)
// switched on or off; with both on it is K4's own instantiation.
int attn_variant_f32(const int* tile_ptr, const int* tile_cols,
                     const uint8_t* mask, const float* q, const float* k,
                     const float* v, float* out, int nrb, int H, int d,
                     int n_q, int n_kv, int n_out, float scale, int vec,
                     int cluster, int clusters, int width, int use_exp,
                     int use_mask, int device, cudaStream_t stream) {
  auto run = [&](auto fn) {
    return fn(tile_ptr, tile_cols, mask, q, k, v, out, nrb, H, d, n_q, n_kv,
              n_out, scale, vec, cluster, clusters, width, device, stream);
  };
  if (use_exp && use_mask) return run(attention<float, true, true>);
  if (use_exp) return run(attention<float, true, false>);
  if (use_mask) return run(attention<float, false, true>);
  return run(attention<float, false, false>);
}

}  // extern "C"
