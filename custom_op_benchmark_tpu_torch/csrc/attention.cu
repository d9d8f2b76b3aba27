// Fused block-sparse graph attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels:
//   K4 fused_attention_rows <- custom_op_benchmark_tpu/ops/pallas/attention.py
//   S5 attn_variant         <- scripts/exp_grid_bisect.py (K4 with use_exp /
//                              use_mask switches, a diagnostic)
// with one kernel, attention_mma_kernel: K4 at any head width, f32 or bf16,
// on the tensor cores; S5 is the same kernel with its UseExp / UseMask
// template switches, f32 (with both on, the same instantiation as K4).
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
// a 128-feature slice); each warp owns 16 query rows. S = Q K^T and
// acc += P V run as mma.sync m16n8k8 in 3xTF32 (mma_async.cuh), so the
// products are as accurate as f32 FMAs. A warp's 16 x 128 scores stay in
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
// bf16: K and V chunks land as bf16 in the lo room of a buffer and are
// widened once into the hi room; Q is widened as it is loaded. QK^T is
// bf16 x bf16, one TF32 pass; P stays f32, so P V takes two (lo*v +
// hi*v). The output is rounded to bf16 once.
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
  // A buffer: hi [TILE][CLD], lo [TILE][CLD] (bf16: the staged chunk).
  static constexpr int BUF = 2 * TILE * CLD;
  static constexpr size_t SMEM =
      sizeof(float) * (TILE * QLD + 2 * BUF) + (size_t)TILE * MASK_LD;
};
static_assert(TILE * SLD <= MmaCfg<CHUNK>::BUF,
              "a score tile fits one chunk buffer");

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
template <typename E, int D, bool CLUSTER, bool UseExp, bool UseMask>
__global__ void __launch_bounds__(MMA_THREADS, 1)
attention_mma_kernel(const int* __restrict__ ptr,
                     const int* __restrict__ cols,
                     const uint8_t* __restrict__ mask,
                     const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, E* __restrict__ out, int d,
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
  const E* qh = q + (long long)h * d;
  const E* kh = k + (long long)h * d;
  const E* vh = v + (long long)h * d;
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
  // K chunk. bf16 chunks land in the lo room.
  auto issue = [&](int step) {
    const int t = lo + step / steps, c = step % steps;
    if (t >= hi) return;
    float* buf = Bs + (step % 2) * BUF;
    const long long row = (long long)cols[t] * TILE;
    const bool kstep = c < nk;
    const int f0 = kstep ? kfeat(c) : fo + (c - nk) * CHUNK;
    const E* src = kstep ? kh : vh;
    if constexpr (is_f32<E>)
      load_rows<TILE, CHUNK, CLD, MMA_THREADS>(buf, src, row, n_kv, f0, d,
                                               ld, vec, tid);
    else
      load_rows<TILE, CHUNK, CHUNK, MMA_THREADS>(
          reinterpret_cast<bf16*>(buf + TILE * CLD), src, row, n_kv, f0, d,
          ld, vec, tid);
    if (UseMask && c == 0)
      load_mask<MMA_THREADS>(Ms, mask + (long long)t * TILE * TILE, tid);
  };
  // Q's rows of the row block, features f0 .. f0 + D - 1, read and widened
  // by plain loads (visible after the next barrier).
  auto load_q = [&](int f0) {
    for (int e = tid; e < TILE * D; e += MMA_THREADS) {
      const int r = e / D, f = e % D;
      const long long row = (long long)i * TILE + r;
      Qs[r * QLD + f] =
          (row < n_q && f0 + f < d) ? to_f32(qh[row * ld + f0 + f]) : 0.f;
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
    if constexpr (is_f32<E>)
      load_rows<TILE, D, QLD, MMA_THREADS>(Qs, qh, (long long)i * TILE, n_q,
                                           kfeat(0), d, ld, vec, tid);
    else
      load_q(kfeat(0));  // once per block
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
      if constexpr (is_f32<E>)
        split_rows<TILE, CHUNK, CLD, MMA_THREADS>(bh, bl, tid);
      else
        widen_rows<TILE, CHUNK, CHUNK, CLD, MMA_THREADS>(
            bh, reinterpret_cast<const bf16*>(bl), tid);
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
          if constexpr (is_f32<E>) {
            split_a(qa[0], qa[8 * QLD], qa[4], qa[8 * QLD + 4], ah, al);
          } else {
            ah[0] = exact_tf32(qa[0]);
            ah[1] = exact_tf32(qa[8 * QLD]);
            ah[2] = exact_tf32(qa[4]);
            ah[3] = exact_tf32(qa[8 * QLD + 4]);
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
  E* oh = out + (long long)h * d;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int f = fo + n * 8 + 2 * t4 + u;
      if (f >= d) continue;
      if (r0 < n_out)
        oh[r0 * ld + f] = from_f32<E>(l0 > 0.f ? acc[n][u] / den0 : 0.f);
      if (r1 < n_out)
        oh[r1 * ld + f] = from_f32<E>(l1 > 0.f ? acc[n][2 + u] / den1 : 0.f);
    }
}

template <typename E, int D, bool CLUSTER, bool UseExp, bool UseMask>
int launch(const int* ptr, const int* cols, const uint8_t* mask, const E* q,
           const E* k, const E* v, E* out, int nrb, int H, int d, int n_q,
           int n_kv, int n_out, float scale, int vec, int cl, int clusters,
           cudaStream_t stream) {
  auto kernel = attention_mma_kernel<E, D, CLUSTER, UseExp, UseMask>;
  const int smem = (int)MmaCfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
