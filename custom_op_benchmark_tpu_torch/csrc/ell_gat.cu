// The GAT attention's ELL sweeps for Hopper (sm_90a), f32 and bf16.
//
// Replaces no TPU kernel: the JAX package's ell_gat_attention
// (custom_op_benchmark_tpu/ops/ell.py) is plain XLA, and so was the port's
// (ops/ell.py _EllGat, now its plain version on CPU tensors). That version
// gathers, for every degree bucket, a (R, D, h, d) tile of z's rows into
// memory, copies it to another layout for the per-head einsum and reads it
// back: each useful row read moved four to five times its bytes, in the
// forward and in both backward passes (0.9 of arxiv_gat's step). Here no
// gathered tile exists: each sweep loads the rows x[cols[slot]] into
// registers, uses them and drops them.
//
// Layout. z (n, h, d), W = h d features a node row, head-major. Each ELL
// packing comes as its GatherTable (graph/ell.py; the table S3 sweeps in
// one launch, csrc/gather_sum.cu): per bucket, widest first, the offset of
// its real rows' slots in cols, its width D and its first row; nodes[row]
// is each row's node, zero_nodes the nodes with no row. A slot whose
// column is outside [0, n_x) is a pad slot and is skipped. Per-slot values
// that cross between the packings (α, and the pre-activation cotangent
// dpre) live in the packing's flat slot order (the buckets' (R·D) flats
// concatenated: the order ops/ell.py's _flat builds and twin_slot
// indexes); `flat` gives each dst table slot's place there and `twin` each
// src table slot's, so the src sweep reads them through twin_slot.
//
// The sweeps, over the in-edge (dst) packing, then the out-edge (src) one:
//
//   forward (ell_gat_fwd): el = z·a_l, er = z·a_r a node and head
//     (gat_scores_kernel); per dst row v and head the LeakyReLU scores
//     el[u] + er[v] of its slots and their masked softmax α in f32, the
//     reference's -1e30 mask and 1e-30 floor, written as the residual
//     (gat_softmax_kernel: h floats a slot are read, no row of z); then
//     out[v] = Σ α·z[u], written to v's row, zero rows 0 (gat_sum_kernel).
//   backward pass 1 (ell_gat_bwd_dst): dα = <dy[v], z[u]> a slot and head
//     (gat_dot_kernel); per dst row dS = α(dα - Σ α·dα), dpre =
//     LeakyReLU'(el[u] + er[v])·dS, the (α, dpre) pairs and the row sums
//     der (gat_dpre_kernel).
//   backward pass 2 (ell_gat_bwd_src): per src row u, dz[u] = Σ α·dy[v]
//     and d_el[u] = Σ dpre, α and dpre read through twin; dz[u] =
//     (der[u]·a_r) + (Σ α·dy + d_el[u]·a_l), each term rounded to z's dtype
//     before they are added, as in the reference (gat_sum_kernel, BWD); then
//     d_a_l = Σ_n d_el·z and d_a_r = Σ_n der·z over fixed chunks of nodes,
//     summed in chunk order (gat_node_grad_kernel, _combine_kernel).
//
// What bounds it on this card: bytes, once the per-slot work is spread over
// enough of them. The heavy sweeps (the two sums and the dot) read one row
// of W elements a slot: 2 KB at the hidden layer of arxiv_gat, 2.75 M
// slots, from device memory (z is 347 MB, L2 50 MB), at 2 flops a 4 bytes.
// The softmax and dpre sweeps read h floats a slot.
//
// The design is S3's row engine (csrc/gather_sum.cu), whose table, task
// numbering and pad-skipping walk both take from ell_table.cuh:
// - Two ways to spread a row's W features, chosen from the shape and the
//   rows' alignment (the C entry points' `lanes`):
//   - 16-byte lanes, when rows are aligned and d % 4 == 0 (a lane's 4
//     features lie in one head): the sums spread a row over G lanes, 4 a
//     lane as one 16-byte load (8 bytes for bf16), G the smallest power of
//     two covering W, at most 32; wider rows take several feature chunks,
//     one group task each, and each task walks the row's slots. Each lane
//     reads the weight of its own head: the lanes of a head read one
//     address. At arxiv_gat's (4, 128) a task covers 512 features, so the
//     per-slot work (the column, the place, the weights) is paid once a
//     2 KB row in 4 tasks, and the rows' gather from device memory bounds
//     the sweep (0.7-0.85 of it on an H100).
//   - Whole rows, otherwise (d % 4 != 0, or rows off 16-byte alignment):
//     the sums take a row piece with one warp, each lane NC loads of PW
//     features (PW = 2, one 8-byte load for f32, when d is even and rows
//     are aligned to 2 elements, else 1), NC ROW_LOADS_NARROW or
//     ROW_LOADS: 24 floats a lane at DGL's (3, 250). Per slot the warp
//     takes the column and the place once, lane k loads the slot's weight
//     of head k and each lane takes each load's weight from its head's
//     lane (a shuffle), then makes all its loads, ROW_UNROLL slots at once
//     (3 KB a slot a warp at W = 750, f32). A row wider than 32 PW
//     ROW_LOADS features takes several tasks. At (3, 250) the sweeps reach
//     0.80-0.83 of the rows' bound on an H100.
//   - One float a lane in 32-feature chunks, for more than ROW_HEADS heads
//     off the 16-byte lanes: a task a chunk, each walking every slot (24
//     times a row at W = 750). At DGL's (3, 250) that path reached only
//     0.32-0.55 of the rows' bound on an H100, and bf16 was no faster:
//     per-slot work, not bytes, bounded it.
//   The dot sweep and the scores take G lanes a head (lanes sized to d),
//   loop over the head's chunks, and reduce across the group by a
//   butterfly; a warp-wide dot group sums four slots at once, transposing
//   them as it adds (6 shuffles for 4 slots, not 20). The dot keeps dy in
//   registers: one chunk at 16-byte lanes (64 registers, not 80; on an H100
//   the dot sweep at arxiv_gat's hidden layer went from 3.0 to 2.4 ms with
//   both), a head's chunks up to DOT_CHUNKS at one float a lane, so no
//   slot reads dy again.
// - Pad slots skipped: a warp-wide group loads 32 column ids at once,
//   takes a ballot of the valid ones and compacts them in slot order into
//   shared memory; narrower groups load their ids as they go.
// - Loads before use: UNROLL rows (ROW_UNROLL on whole rows) are loaded
//   into registers before their products are added (UNROLL = 8 lost on an
//   H100: the sums 3 to 63 % slower at arxiv_gat's widths).
// - Long rows in fixed pieces: in the sums, a row of more than PIECE slots
//   is summed as pieces of PIECE slots, each a task writing its f32 partial
//   to a scratch; a second launch adds each row's partials in piece order
//   and stores the row (with pass 2's epilogue). The dot sweep splits the
//   same way and needs no combine (each slot's dα is its own). The softmax
//   and dpre sweeps take a row whole (a warp, 32 slots a step): they read
//   h floats a slot.
// - Determinism: every sum is row-owned and in a fixed order (slot order
//   in a lane, then a fixed butterfly or piece order; a feature's sum is
//   the same on both paths, bit for bit), no atomics; every
//   output element is written once. The same inputs give the same bits on
//   every run.
//
// Arithmetic: f32 on the CUDA cores, products by fmaf (no TF32). bf16 rows
// are widened in registers (exact); sums and α are f32; outputs are
// rounded to bf16 once, at the store, and dz's two terms each before their
// add, where the reference rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_table.cuh"

namespace {

constexpr int HB = 8;            // heads a softmax/dpre lane holds at once
constexpr int NODE_CHUNK = 256;  // nodes a partial of d_a_l, d_a_r sums
constexpr int DOT_CHUNKS = 8;    // dy chunks a dot lane holds at PL = 1
// Whole-row sums: the loads a lane makes a slot (ROW_LOADS_NARROW for rows
// that fit, else ROW_LOADS), the slots loaded before their products are
// added, and the most heads (one lane each holds a slot's α of a head).
constexpr int ROW_LOADS = 12;
constexpr int ROW_LOADS_NARROW = 4;
constexpr int ROW_UNROLL = 2;
constexpr int ROW_HEADS = 32;
constexpr float MASK_VALUE = -1e30f;
constexpr float DENOM_FLOOR = 1e-30f;

using bf16 = __nv_bfloat16;

// PL elements at p widened to f32: one 16-byte (f32) or 8-byte (bf16) load
// for PL = 4, one 8-byte or 4-byte load for PL = 2.
template <int PL>
__device__ __forceinline__ void load(const float* p, float (&v)[PL]) {
  if constexpr (PL == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (PL == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int PL>
__device__ __forceinline__ void load(const bf16* p, float (&v)[PL]) {
  if constexpr (PL == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(raw.x << 16);
    v[1] = __uint_as_float(raw.x & 0xffff0000u);
    v[2] = __uint_as_float(raw.y << 16);
    v[3] = __uint_as_float(raw.y & 0xffff0000u);
  } else if constexpr (PL == 2) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    v[0] = __uint_as_float(raw << 16);
    v[1] = __uint_as_float(raw & 0xffff0000u);
  } else {
    v[0] = __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
}

template <int PL>
__device__ __forceinline__ void store(float* p, const float (&v)[PL]) {
  if constexpr (PL == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (PL == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    p[0] = v[0];
}

template <int PL>
__device__ __forceinline__ void store(bf16* p, const float (&v)[PL]) {
  if constexpr (PL == 4) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    q[0] = __floats2bfloat162_rn(v[0], v[1]);
    q[1] = __floats2bfloat162_rn(v[2], v[3]);
  } else if constexpr (PL == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// x rounded to E (to nearest even) and widened back.
template <typename E>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (sizeof(E) == 2)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

__device__ __forceinline__ float leaky(float pre, float slope) {
  return pre > 0.f ? pre : slope * pre;
}

__device__ __forceinline__ float group_sum(float v, int G, unsigned mask) {
  for (int off = G >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// The sums over the warp of four values a lane, v[u] for slots u = 0..3,
// transposed as they are added (6 shuffles, not 4 × 5): each lane ends with
// the sum of slot lane >> 3.
__device__ __forceinline__ float warp_sum4(const float (&v)[4], int lane) {
  const bool hi = lane & 16, odd = lane & 8;
  float a = hi ? v[2] : v[0], b = hi ? v[3] : v[1];
  a += __shfl_xor_sync(FULL, hi ? v[0] : v[2], 16);
  b += __shfl_xor_sync(FULL, hi ? v[1] : v[3], 16);
  float c = odd ? b : a;
  c += __shfl_xor_sync(FULL, odd ? a : b, 8);
  for (int off = 4; off > 0; off >>= 1) c += __shfl_xor_sync(FULL, c, off);
  return c;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// Node scores: el = z·a_l, er = z·a_r, a group of lanes a (node, head)
// ---------------------------------------------------------------------------

template <typename E, int PL>
__global__ void __launch_bounds__(THREADS)
gat_scores_kernel(const E* __restrict__ z, const float* __restrict__ a_l,
                  const float* __restrict__ a_r, int n_x, int h, int d,
                  int G, int n_ch, float* __restrict__ el,
                  float* __restrict__ er) {
  const Group g = group_of(G);
  const long long node = g.task / h;
  const int head = (int)(g.task % h);
  if (node >= n_x) return;
  const E* zr = z + (size_t)node * h * d + (size_t)head * d;
  const float* al = a_l + (size_t)head * d;
  const float* ar = a_r + (size_t)head * d;
  float sl = 0.f, sr = 0.f;
  for (int c = 0; c < n_ch; ++c) {
    const int f = (c * G + g.in_group) * PL;
    if (f < d) {
      float q[PL], wl[PL], wr[PL];
      load<PL>(zr + f, q);
      load<PL>(al + f, wl);
      load<PL>(ar + f, wr);
#pragma unroll
      for (int p = 0; p < PL; ++p) {
        sl = fmaf(q[p], wl[p], sl);
        sr = fmaf(q[p], wr[p], sr);
      }
    }
  }
  sl = group_sum(sl, G, g.mask);
  sr = group_sum(sr, G, g.mask);
  if (g.in_group == 0) {
    el[node * h + head] = sl;
    er[node * h + head] = sr;
  }
}

// ---------------------------------------------------------------------------
// Softmax (forward) and dpre (backward pass 1): a warp a dst row, its slots
// 32 a step, heads HB at a time
// ---------------------------------------------------------------------------

// The warp's row: r < n_rows, its bucket's width D and first slot base.
struct Row {
  int D, v;
  long long base;
};

__device__ __forceinline__ Row row_of(const Tab& t, int n_buckets,
                                      const int* nodes, int r) {
  Row w;
  const int b = bucket_of(t.first, n_buckets, r);
  w.D = t.width[b];
  w.base = t.off[b] + (long long)(r - t.first[b]) * w.D;
  w.v = nodes[r];
  return w;
}

__global__ void __launch_bounds__(THREADS)
gat_softmax_kernel(const int* __restrict__ table, int n_buckets,
                   const int* __restrict__ cols, const int* __restrict__ nodes,
                   int n_rows, const int* __restrict__ flat,
                   const float* __restrict__ el, const float* __restrict__ er,
                   int h, int n_x, float slope, float* __restrict__ alpha) {
  __shared__ Tab tab;
  load_tab(tab, table, n_buckets, n_rows);
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const Row w = row_of(tab, n_buckets, nodes, (int)r);
  for (int hb = 0; hb < h; hb += HB) {
    float erv[HB], m[HB], s[HB];
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      erv[j] = hb + j < h ? er[(size_t)w.v * h + hb + j] : 0.f;
      m[j] = MASK_VALUE;
      s[j] = 0.f;
    }
#pragma unroll 4
    for (int k = lane; k < w.D; k += 32) {
      const int c = __ldg(cols + w.base + k);
      if ((unsigned)c >= (unsigned)n_x) continue;
#pragma unroll
      for (int j = 0; j < HB; ++j)
        if (hb + j < h)
          m[j] = fmaxf(m[j], leaky(__ldg(el + (size_t)c * h + hb + j) +
                                       erv[j], slope));
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) m[j] = warp_max(m[j]);
#pragma unroll 4
    for (int k = lane; k < w.D; k += 32) {
      const int c = __ldg(cols + w.base + k);
      if ((unsigned)c >= (unsigned)n_x) continue;
#pragma unroll
      for (int j = 0; j < HB; ++j)
        if (hb + j < h)
          s[j] += expf(leaky(__ldg(el + (size_t)c * h + hb + j) + erv[j],
                             slope) - m[j]);
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) s[j] = fmaxf(group_sum(s[j], 32, FULL),
                                            DENOM_FLOOR);
#pragma unroll 4
    for (int k = lane; k < w.D; k += 32) {
      const int c = __ldg(cols + w.base + k);
      if ((unsigned)c >= (unsigned)n_x) continue;
      const size_t at = (size_t)__ldg(flat + w.base + k) * h + hb;
#pragma unroll
      for (int j = 0; j < HB; ++j)
        if (hb + j < h)
          alpha[at + j] =
              expf(leaky(__ldg(el + (size_t)c * h + hb + j) + erv[j], slope) -
                   m[j]) / s[j];
    }
  }
}

// Per dst row: agg = Σ α·dα, dS = α(dα - agg), dpre = LeakyReLU'·dS; the
// (α, dpre) pair of each slot at its flat place, der[v] = Σ dpre; the zero
// rows' der is 0 (warps past the rows).
__global__ void __launch_bounds__(THREADS)
gat_dpre_kernel(const int* __restrict__ table, int n_buckets,
                const int* __restrict__ cols, const int* __restrict__ nodes,
                int n_rows, const int* __restrict__ zero_nodes, int n_zero,
                const int* __restrict__ flat, const float* __restrict__ alpha,
                const float* __restrict__ dal, const float* __restrict__ el,
                const float* __restrict__ er, int h, int n_x, float slope,
                float* __restrict__ ad, float* __restrict__ der) {
  __shared__ Tab tab;
  load_tab(tab, table, n_buckets, n_rows);
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) {
    const long long zr = r - n_rows;
    if (zr < n_zero)
      for (int j = lane; j < h; j += 32)
        der[(size_t)zero_nodes[zr] * h + j] = 0.f;
    return;
  }
  const Row w = row_of(tab, n_buckets, nodes, (int)r);
  for (int hb = 0; hb < h; hb += HB) {
    float erv[HB], agg[HB], sum[HB];
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      erv[j] = hb + j < h ? er[(size_t)w.v * h + hb + j] : 0.f;
      agg[j] = 0.f;
      sum[j] = 0.f;
    }
#pragma unroll 4
    for (int k = lane; k < w.D; k += 32) {
      const int c = __ldg(cols + w.base + k);
      if ((unsigned)c >= (unsigned)n_x) continue;
      const size_t at = (size_t)__ldg(flat + w.base + k) * h + hb;
      const size_t ak = (size_t)(w.base + k) * h + hb;
#pragma unroll
      for (int j = 0; j < HB; ++j)
        if (hb + j < h) agg[j] = fmaf(alpha[at + j], dal[ak + j], agg[j]);
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) agg[j] = group_sum(agg[j], 32, FULL);
#pragma unroll 4
    for (int k = lane; k < w.D; k += 32) {
      const int c = __ldg(cols + w.base + k);
      if ((unsigned)c >= (unsigned)n_x) continue;
      const size_t fl = (size_t)__ldg(flat + w.base + k);
      const size_t ak = (size_t)(w.base + k) * h + hb;
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        if (hb + j >= h) continue;
        const float a = alpha[fl * h + hb + j];
        const float dS = a * (dal[ak + j] - agg[j]);
        const float pre = __ldg(el + (size_t)c * h + hb + j) + erv[j];
        const float dp = pre > 0.f ? dS : slope * dS;
        ad[fl * 2 * h + hb + j] = a;
        ad[fl * 2 * h + h + hb + j] = dp;
        sum[j] += dp;
      }
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      sum[j] = group_sum(sum[j], 32, FULL);
      if (lane == 0 && hb + j < h) der[(size_t)w.v * h + hb + j] = sum[j];
    }
  }
}

// ---------------------------------------------------------------------------
// The dot sweep (backward pass 1): dα[slot, head] = <dy[v, head], z[u, head]>,
// G lanes a (piece of a dst row, head), written in table slot order
// ---------------------------------------------------------------------------

template <typename E, int PL>
__global__ void __launch_bounds__(THREADS)
gat_dot_kernel(const int* __restrict__ table, int n_buckets,
               const int* __restrict__ cols, const int* __restrict__ nodes,
               int n_rows, const E* __restrict__ z, const E* __restrict__ dy,
               int n_x, int h, int d, int G, int n_ch,
               float* __restrict__ dal) {
  __shared__ Tab tab;
  __shared__ int compact[2 * THREADS];
  int* const cc = compact + 2 * (threadIdx.x & ~31);
  int* const ck = cc + 32;
  load_tab(tab, table, n_buckets, n_rows);
  const Group g = group_of(G);
  const long long unit = g.task / h;
  const int head = (int)(g.task % h);
  if (unit >= tab.unit0[n_buckets]) return;   // the whole group
  const Piece q = piece_of(tab, n_buckets, unit);
  const size_t W = (size_t)h * d, hoff = (size_t)head * d;
  const E* gyr = dy + (size_t)nodes[tab.first[q.b] + q.row] * W + hoff;
  // dy's first NCH chunks stay in registers: at PL = 1 a head's chunks, up
  // to DOT_CHUNKS; at PL = 4 the first. The chunks past them are read
  // again (from L1) for each slot.
  constexpr int NCH = PL == 1 ? DOT_CHUNKS : 1;
  float gy[NCH][PL];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int f = (c * G + g.in_group) * PL;
    if ((c == 0 || c < n_ch) && f < d) {
      load<PL>(gyr + f, gy[c]);
    } else {
#pragma unroll
      for (int p = 0; p < PL; ++p) gy[c][p] = 0.f;
    }
  }
  // This lane's share of <dy[v, head], z[col, head]>, its chunks in order.
  auto dot = [&](int col) {
    const E* zr = z + (size_t)col * W + hoff;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int f = (c * G + g.in_group) * PL;
      if ((c == 0 || c < n_ch) && f < d) {
        float v[PL];
        load<PL>(zr + f, v);
#pragma unroll
        for (int p = 0; p < PL; ++p) s = fmaf(gy[c][p], v[p], s);
      }
    }
    for (int c = NCH; c < n_ch; ++c) {
      const int f = (c * G + g.in_group) * PL;
      if (f < d) {
        float v[PL], y[PL];
        load<PL>(zr + f, v);
        load<PL>(gyr + f, y);
#pragma unroll
        for (int p = 0; p < PL; ++p) s = fmaf(y[p], v[p], s);
      }
    }
    return s;
  };
  const int* rc = cols + q.base;
  float* out = dal + (size_t)q.base * h + head;
  if (G == 32) {
    compact_walk(rc, q.k0, q.k1, n_x, g.lane, cc, ck,
                 [](int k) { return k; }, [&](int n) {
      // Four slots a step (the last step padded with zeros), summed over
      // the warp together: lanes 0, 8, 16, 24 hold slots j .. j + 3.
      for (int j = 0; j < n; j += 4) {
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = j + u < n ? dot(cc[j + u]) : 0.f;
        const float r = warp_sum4(s, g.lane);
        const int u = g.lane >> 3;
        if ((g.lane & 7) == 0 && j + u < n) out[(size_t)ck[j + u] * h] = r;
      }
    });
    return;
  }
  int k = q.k0;
  for (; k + UNROLL <= q.k1; k += UNROLL) {
    int c[UNROLL];
    float s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) c[u] = __ldg(rc + k + u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      s[u] = (unsigned)c[u] < (unsigned)n_x ? dot(c[u]) : 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] = group_sum(s[u], G, g.mask);
      if (g.in_group == 0 && (unsigned)c[u] < (unsigned)n_x)
        out[(size_t)(k + u) * h] = s[u];
    }
  }
  for (; k < q.k1; ++k) {
    const int c = __ldg(rc + k);
    if ((unsigned)c >= (unsigned)n_x) continue;   // the whole group
    const float s = group_sum(dot(c), G, g.mask);
    if (g.in_group == 0) out[(size_t)k * h] = s;
  }
}

// ---------------------------------------------------------------------------
// The weighted sums: out[v] = Σ α·z[u] (forward, dst table), and dz[u] =
// Σ α·dy[v] with d_el[u] = Σ dpre and the epilogue (BWD, src table)
// ---------------------------------------------------------------------------

// Where a lane works in a sum: its group's task (task / n_chunks the unit:
// a piece of a row or a zero row; task % n_chunks the feature chunk), its
// first feature f (active: f < W), its head, and whether it writes the
// head's scalar (the lane holding the head's first feature).
struct Lane {
  int lane, f, head;
  long long unit;
  bool active, writer;
};

template <int PL>
__device__ __forceinline__ Lane lane_of(int G, int W, int d, int n_chunks) {
  const Group g = group_of(G);
  Lane l;
  l.lane = g.lane;
  l.unit = g.task / n_chunks;
  l.f = ((int)(g.task % n_chunks) * G + g.in_group) * PL;
  l.active = l.f < W;
  l.head = l.active ? l.f / d : 0;
  l.writer = l.active && l.f == l.head * d;
  return l;
}

// Adds slots k0 .. k1 - 1 of a row (cols, and widx: each slot's place in w,
// of stride ws) to this lane's features: acc += w[., head]·x[col], and with
// BWD ds += w[., h + head]. Pad slots are skipped.
template <typename E, int PL, bool BWD>
__device__ __forceinline__ void weighted_sum(
    const int* __restrict__ cols, const int* __restrict__ widx, int k0,
    int k1, const float* __restrict__ w, int ws, int h,
    const E* __restrict__ x, int W, int n_x, const Lane& l, int G, int* cc,
    int* cw, float (&acc)[PL], float& ds) {
  const float* wh = w + l.head;
  if (G == 32) {
    compact_walk(cols, k0, k1, n_x, l.lane, cc, cw,
                 [&](int k) { return __ldg(widx + k); }, [&](int n) {
      if (!l.active) return;
      int j = 0;
      for (; j + UNROLL <= n; j += UNROLL) {
        float v[UNROLL][PL], a[UNROLL], e[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const size_t wi = (size_t)cw[j + u] * ws;
          a[u] = __ldg(wh + wi);
          e[u] = BWD ? __ldg(wh + wi + h) : 0.f;
          load<PL>(x + (size_t)cc[j + u] * W + l.f, v[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int p = 0; p < PL; ++p) acc[p] = fmaf(a[u], v[u][p], acc[p]);
          if (BWD) ds += e[u];
        }
      }
      for (; j < n; ++j) {
        const size_t wi = (size_t)cw[j] * ws;
        float v[PL];
        load<PL>(x + (size_t)cc[j] * W + l.f, v);
        const float a = __ldg(wh + wi);
#pragma unroll
        for (int p = 0; p < PL; ++p) acc[p] = fmaf(a, v[p], acc[p]);
        if (BWD) ds += __ldg(wh + wi + h);
      }
    });
    return;
  }
  if (!l.active) return;
  int k = k0;
  for (; k + UNROLL <= k1; k += UNROLL) {
    int c[UNROLL];
    bool ok[UNROLL];
    float v[UNROLL][PL], a[UNROLL], e[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      c[u] = __ldg(cols + k + u);
      ok[u] = (unsigned)c[u] < (unsigned)n_x;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (ok[u]) {
        const size_t wi = (size_t)__ldg(widx + k + u) * ws;
        a[u] = __ldg(wh + wi);
        e[u] = BWD ? __ldg(wh + wi + h) : 0.f;
        load<PL>(x + (size_t)c[u] * W + l.f, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int p = 0; p < PL; ++p) acc[p] = fmaf(a[u], v[u][p], acc[p]);
      if (BWD) ds += e[u];
    }
  }
  for (; k < k1; ++k) {
    const int c = __ldg(cols + k);
    if ((unsigned)c >= (unsigned)n_x) continue;
    const size_t wi = (size_t)__ldg(widx + k) * ws;
    float v[PL];
    load<PL>(x + (size_t)c * W + l.f, v);
    const float a = __ldg(wh + wi);
#pragma unroll
    for (int p = 0; p < PL; ++p) acc[p] = fmaf(a, v[p], acc[p]);
    if (BWD) ds += __ldg(wh + wi + h);
  }
}

// Stores a node's row: the forward's sum rounded to E; with BWD, dz =
// round(der·a_r) + round(acc + ds·a_l), and the head's d_el = ds.
template <typename E, int PL, bool BWD>
__device__ __forceinline__ void finish(
    int node, const Lane& l, int W, int h, const float (&acc)[PL], float ds,
    E* __restrict__ y, const float* __restrict__ der,
    const float* __restrict__ a_l, const float* __restrict__ a_r,
    float* __restrict__ d_el) {
  E* yr = y + (size_t)node * W + l.f;
  if constexpr (!BWD) {
    store<PL>(yr, acc);
  } else {
    const float dr = der[(size_t)node * h + l.head];
    float o[PL];
#pragma unroll
    for (int p = 0; p < PL; ++p) {
      const float t1 = rounded<E>(__fmul_rn(dr, a_r[l.f + p]));
      const float t2 =
          rounded<E>(__fadd_rn(acc[p], __fmul_rn(ds, a_l[l.f + p])));
      o[p] = __fadd_rn(t1, t2);
    }
    store<PL>(yr, o);
    if (l.writer) d_el[(size_t)node * h + l.head] = ds;
  }
}

// Pass 1 of a sum: one group per unit (a piece of a row, in table order; a
// row of one piece is stored at once, a longer row's pieces go to the
// scratch: W floats each, then with BWD h floats each of ds), then the
// zero rows.
template <typename E, int PL, bool BWD>
__global__ void __launch_bounds__(THREADS)
gat_sum_kernel(const int* __restrict__ table, int n_buckets,
               const int* __restrict__ cols, const int* __restrict__ nodes,
               int n_rows, const int* __restrict__ zero_nodes, int n_zero,
               const int* __restrict__ widx, const float* __restrict__ w,
               const E* __restrict__ x, int n_x, int h, int d, int G,
               int n_chunks, E* __restrict__ y, float* __restrict__ scratch,
               const float* __restrict__ der, const float* __restrict__ a_l,
               const float* __restrict__ a_r, float* __restrict__ d_el) {
  __shared__ Tab tab;
  __shared__ int compact[2 * THREADS];
  int* const cc = compact + 2 * (threadIdx.x & ~31);
  int* const cw = cc + 32;
  load_tab(tab, table, n_buckets, n_rows);
  const int W = h * d;
  const Lane l = lane_of<PL>(G, W, d, n_chunks);
  float acc[PL];
#pragma unroll
  for (int p = 0; p < PL; ++p) acc[p] = 0.f;
  float ds = 0.f;
  const long long n_units = tab.unit0[n_buckets];
  if (l.unit >= n_units) {
    const long long zr = l.unit - n_units;
    if (zr < n_zero && l.active)
      finish<E, PL, BWD>(zero_nodes[zr], l, W, h, acc, ds, y, der, a_l, a_r,
                         d_el);
    return;
  }
  const Piece q = piece_of(tab, n_buckets, l.unit);
  weighted_sum<E, PL, BWD>(cols + q.base, widx + q.base, q.k0, q.k1, w,
                           BWD ? 2 * h : h, h, x, W, n_x, l, G, cc, cw, acc,
                           ds);
  if (!l.active) return;
  if (q.P == 1) {
    finish<E, PL, BWD>(nodes[tab.first[q.b] + q.row], l, W, h, acc, ds, y,
                       der, a_l, a_r, d_el);
    return;
  }
  store<PL>(scratch + (size_t)q.part * W + l.f, acc);
  if (BWD && l.writer)
    scratch[(size_t)tab.part0[n_buckets] * W + (size_t)q.part * h + l.head] =
        ds;
}

// Pass 2 of a sum: one group per split row, in table order: its partials
// added in piece order, then stored as in pass 1.
template <typename E, int PL, bool BWD>
__global__ void __launch_bounds__(THREADS)
gat_combine_kernel(const int* __restrict__ table, int n_buckets,
                   const int* __restrict__ nodes, int n_rows, int h, int d,
                   int G, int n_chunks, const float* __restrict__ scratch,
                   E* __restrict__ y, const float* __restrict__ der,
                   const float* __restrict__ a_l,
                   const float* __restrict__ a_r, float* __restrict__ d_el) {
  __shared__ Tab tab;
  load_tab(tab, table, n_buckets, n_rows);
  const int W = h * d;
  const Lane l = lane_of<PL>(G, W, d, n_chunks);
  if (l.unit >= tab.split0[n_buckets] || !l.active) return;
  const Split sp = split_of(tab, n_buckets, l.unit);
  const float* dsp = scratch + (size_t)tab.part0[n_buckets] * W;
  float acc[PL];
#pragma unroll
  for (int p = 0; p < PL; ++p) acc[p] = 0.f;
  float ds = 0.f;
  for (int i = 0; i < sp.P; ++i) {
    float v[PL];
    load<PL>(scratch + (size_t)(sp.part + i) * W + l.f, v);
#pragma unroll
    for (int p = 0; p < PL; ++p) acc[p] += v[p];
    if (BWD) ds += dsp[(size_t)(sp.part + i) * h + l.head];
  }
  finish<E, PL, BWD>(nodes[tab.first[sp.b] + sp.row], l, W, h, acc, ds, y,
                     der, a_l, a_r, d_el);
}

// ---------------------------------------------------------------------------
// The weighted sums on whole rows (rows the 16-byte lanes do not take): a
// warp a task, a piece of a row and a span of its features; each lane holds
// NC loads of PW features and makes all of them for each slot
// ---------------------------------------------------------------------------

// The loads a lane makes a slot in a whole-row sum of rows of `width`
// features at pw a load (ROW_LOADS_NARROW or ROW_LOADS), and the tasks a
// row takes, each 32 pw NC features wide.
inline int row_loads(int width, int pw, int* tasks) {
  const int per = 32 * pw;
  *tasks = (width + per * ROW_LOADS - 1) / (per * ROW_LOADS);
  const int need = (width + *tasks * per - 1) / (*tasks * per);
  return need <= ROW_LOADS_NARROW ? ROW_LOADS_NARROW : ROW_LOADS;
}

// Where a lane works in a whole-row sum: its warp's unit (task / n_tasks: a
// piece of a row or a zero row), whether its task is the unit's first (the
// one that writes the heads' scalars), its first feature f0 and the head of
// each load: load c takes features f0 + 32·PW·c .. + PW − 1 (one head,
// since PW divides d), active below W.
template <int PW, int NC>
struct RowLane {
  int lane, f0;
  long long unit;
  bool first;
  int head[NC];
};

template <int PW, int NC>
__device__ __forceinline__ RowLane<PW, NC> row_lane_of(int W, int d,
                                                       int n_tasks) {
  RowLane<PW, NC> l;
  l.lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  l.unit = warp / n_tasks;
  const int task = (int)(warp % n_tasks);
  l.first = task == 0;
  l.f0 = task * 32 * PW * NC + l.lane * PW;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = l.f0 + 32 * PW * c;
    l.head[c] = f < W ? f / d : 0;
  }
  return l;
}

// Stores a node's row as finish does: the forward's sum rounded to E; with
// BWD, dz = round(der·a_r) + round(acc + ds·a_l), ds the head's sum, held by
// the lane of that number; the first task writes d_el.
template <typename E, int PW, int NC, bool BWD>
__device__ __forceinline__ void finish_row(
    int node, const RowLane<PW, NC>& l, int W, int h,
    const float (&acc)[NC][PW], float ds, E* __restrict__ y,
    const float* __restrict__ der, const float* __restrict__ a_l,
    const float* __restrict__ a_r, float* __restrict__ d_el) {
  E* yr = y + (size_t)node * W;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = l.f0 + 32 * PW * c;
    if constexpr (!BWD) {
      if (f < W) store<PW>(yr + f, acc[c]);
    } else {
      const float dsh = __shfl_sync(FULL, ds, l.head[c]);
      if (f >= W) continue;
      const float dr = der[(size_t)node * h + l.head[c]];
      float o[PW];
#pragma unroll
      for (int p = 0; p < PW; ++p) {
        const float t1 = rounded<E>(__fmul_rn(dr, a_r[f + p]));
        const float t2 =
            rounded<E>(__fadd_rn(acc[c][p], __fmul_rn(dsh, a_l[f + p])));
        o[p] = __fadd_rn(t1, t2);
      }
      store<PW>(yr + f, o);
    }
  }
  if (BWD && l.first && l.lane < h) d_el[(size_t)node * h + l.lane] = ds;
}

// Pass 1 of a whole-row sum, as gat_sum_kernel's: for each slot the warp
// takes its column and place once, lane k < h loads the slot's w[., k] (and
// with BWD w[., h + k], summed into ds: the lane's head's d_el), each lane
// takes the α of each load's head from that head's lane, and makes its NC
// loads together. Each feature sums its slots in slot order, as the chunked
// sum does. A split row's partials go to the scratch in its layout, for
// gat_combine_kernel.
template <typename E, int PW, int NC, bool BWD>
__global__ void __launch_bounds__(THREADS, 2)
gat_row_sum_kernel(const int* __restrict__ table, int n_buckets,
                   const int* __restrict__ cols, const int* __restrict__ nodes,
                   int n_rows, const int* __restrict__ zero_nodes, int n_zero,
                   const int* __restrict__ widx, const float* __restrict__ w,
                   const E* __restrict__ x, int n_x, int h, int d,
                   int n_tasks, E* __restrict__ y,
                   float* __restrict__ scratch, const float* __restrict__ der,
                   const float* __restrict__ a_l,
                   const float* __restrict__ a_r, float* __restrict__ d_el) {
  __shared__ Tab tab;
  __shared__ int compact[2 * THREADS];
  int* const cc = compact + 2 * (threadIdx.x & ~31);
  int* const cw = cc + 32;
  load_tab(tab, table, n_buckets, n_rows);
  const int W = h * d;
  const RowLane<PW, NC> l = row_lane_of<PW, NC>(W, d, n_tasks);
  float acc[NC][PW];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int p = 0; p < PW; ++p) acc[c][p] = 0.f;
  float ds = 0.f;
  const long long n_units = tab.unit0[n_buckets];
  if (l.unit >= n_units) {
    const long long zr = l.unit - n_units;
    if (zr < n_zero)
      finish_row<E, PW, NC, BWD>(zero_nodes[zr], l, W, h, acc, ds, y, der,
                                 a_l, a_r, d_el);
    return;
  }
  const Piece q = piece_of(tab, n_buckets, l.unit);
  const int ws = BWD ? 2 * h : h;
  const int* rw = widx + q.base;
  compact_walk(cols + q.base, q.k0, q.k1, n_x, l.lane, cc, cw,
               [&](int k) { return __ldg(rw + k); }, [&](int n) {
    for (int j = 0; j < n; j += ROW_UNROLL) {
      float v[ROW_UNROLL][NC][PW], a[ROW_UNROLL], e[ROW_UNROLL];
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u) {
        a[u] = e[u] = 0.f;
        if (j + u >= n) break;                // the same on every lane
        const float* wr = w + (size_t)cw[j + u] * ws;
        if (l.lane < h) {
          a[u] = __ldg(wr + l.lane);
          if (BWD) e[u] = __ldg(wr + h + l.lane);
        }
        const E* xr = x + (size_t)cc[j + u] * W;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int f = l.f0 + 32 * PW * c;
          if (f < W) {
            load<PW>(xr + f, v[u][c]);
          } else {
#pragma unroll
            for (int p = 0; p < PW; ++p) v[u][c][p] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u) {
        if (j + u >= n) break;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ac = __shfl_sync(FULL, a[u], l.head[c]);
#pragma unroll
          for (int p = 0; p < PW; ++p)
            acc[c][p] = fmaf(ac, v[u][c][p], acc[c][p]);
        }
        if (BWD) ds += e[u];
      }
    }
  });
  if (q.P == 1) {
    finish_row<E, PW, NC, BWD>(nodes[tab.first[q.b] + q.row], l, W, h, acc,
                               ds, y, der, a_l, a_r, d_el);
    return;
  }
  float* sp = scratch + (size_t)q.part * W;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = l.f0 + 32 * PW * c;
    if (f < W) store<PW>(sp + f, acc[c]);
  }
  if (BWD && l.first && l.lane < h)
    scratch[(size_t)tab.part0[n_buckets] * W + (size_t)q.part * h + l.lane] =
        ds;
}

// ---------------------------------------------------------------------------
// The attention vectors' cotangents: d_a_l = Σ_n d_el[n]·z[n], d_a_r =
// Σ_n der[n]·z[n], a block a chunk of NODE_CHUNK nodes, then the chunks'
// partials added in chunk order
// ---------------------------------------------------------------------------

template <typename E>
__global__ void __launch_bounds__(THREADS)
gat_node_grad_kernel(const E* __restrict__ z, const float* __restrict__ d_el,
                     const float* __restrict__ der, int n_x, int h, int d,
                     float* __restrict__ part) {
  const int W = h * d;
  const int n0 = blockIdx.x * NODE_CHUNK;
  const int n1 = min(n_x, n0 + NODE_CHUNK);
  for (int f = threadIdx.x; f < W; f += THREADS) {
    const int head = f / d;
    float sl = 0.f, sr = 0.f;
#pragma unroll 4
    for (int n = n0; n < n1; ++n) {
      float v[1];
      load<1>(z + (size_t)n * W + f, v);
      sl = fmaf(__ldg(d_el + (size_t)n * h + head), v[0], sl);
      sr = fmaf(__ldg(der + (size_t)n * h + head), v[0], sr);
    }
    part[(size_t)blockIdx.x * 2 * W + f] = sl;
    part[(size_t)blockIdx.x * 2 * W + W + f] = sr;
  }
}

__global__ void __launch_bounds__(THREADS)
gat_node_grad_combine_kernel(const float* __restrict__ part, int n_parts,
                             int W, float* __restrict__ d_a) {
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= 2 * W) return;
  float s = 0.f;
  for (int i = 0; i < n_parts; ++i) s += part[(size_t)i * 2 * W + o];
  d_a[o] = s;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The weighted sum of one table, both passes (csrc/gather_sum.cu launch).
template <typename E, int PL, bool BWD>
int launch_sum(const int* table, int n_buckets, const int* cols,
               const int* nodes, int n_rows, const int* zero_nodes,
               int n_zero, const int* widx, const float* w, const E* x,
               int n_x, int h, int d, E* y, float* scratch, const float* der,
               const float* a_l, const float* a_r, float* d_el, int n_units,
               int n_split, cudaStream_t stream) {
  const int W = h * d;
  const int G = lanes_for(W, PL);
  const int n_chunks = (W + G * PL - 1) / (G * PL);
  unsigned b1, b2;
  int err = blocks_for((long long)n_units * n_chunks, G, &b1);
  if (!err) err = blocks_for((long long)n_split * n_chunks, G, &b2);
  if (err) return err;
  if (b1 == 0) return 0;
  gat_sum_kernel<E, PL, BWD><<<b1, THREADS, 0, stream>>>(
      table, n_buckets, cols, nodes, n_rows, zero_nodes, n_zero, widx, w, x,
      n_x, h, d, G, n_chunks, y, scratch, der, a_l, a_r, d_el);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || b2 == 0) return (int)e;
  gat_combine_kernel<E, PL, BWD><<<b2, THREADS, 0, stream>>>(
      table, n_buckets, nodes, n_rows, h, d, G, n_chunks, scratch, y, der,
      a_l, a_r, d_el);
  return (int)cudaGetLastError();
}

// The same on whole rows at PW features a load, the combine on the chunked
// sum's one-float lanes.
template <typename E, int PW, bool BWD>
int launch_row_sum(const int* table, int n_buckets, const int* cols,
                   const int* nodes, int n_rows, const int* zero_nodes,
                   int n_zero, const int* widx, const float* w, const E* x,
                   int n_x, int h, int d, E* y, float* scratch,
                   const float* der, const float* a_l, const float* a_r,
                   float* d_el, int n_units, int n_split,
                   cudaStream_t stream) {
  if (h > ROW_HEADS) return (int)cudaErrorInvalidValue;
  const int W = h * d;
  int n_tasks;
  const int nc = row_loads(W, PW, &n_tasks);
  const int G = lanes_for(W, 1);
  const int n_chunks = (W + G - 1) / G;
  unsigned b1, b2;
  int err = blocks_for((long long)n_units * n_tasks, 32, &b1);
  if (!err) err = blocks_for((long long)n_split * n_chunks, G, &b2);
  if (err) return err;
  if (b1 == 0) return 0;
  if (nc == ROW_LOADS_NARROW)
    gat_row_sum_kernel<E, PW, ROW_LOADS_NARROW, BWD><<<b1, THREADS, 0,
                                                       stream>>>(
        table, n_buckets, cols, nodes, n_rows, zero_nodes, n_zero, widx, w,
        x, n_x, h, d, n_tasks, y, scratch, der, a_l, a_r, d_el);
  else
    gat_row_sum_kernel<E, PW, ROW_LOADS, BWD><<<b1, THREADS, 0, stream>>>(
        table, n_buckets, cols, nodes, n_rows, zero_nodes, n_zero, widx, w,
        x, n_x, h, d, n_tasks, y, scratch, der, a_l, a_r, d_el);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || b2 == 0) return (int)e;
  gat_combine_kernel<E, 1, BWD><<<b2, THREADS, 0, stream>>>(
      table, n_buckets, nodes, n_rows, h, d, G, n_chunks, scratch, y, der,
      a_l, a_r, d_el);
  return (int)cudaGetLastError();
}

// A sum of one table: on whole rows at rows features a load (1 or 2), else
// (rows 0) at PL features a lane.
template <typename E, int PL, bool BWD>
int sum(int rows, const int* table, int n_buckets, const int* cols,
        const int* nodes, int n_rows, const int* zero_nodes, int n_zero,
        const int* widx, const float* w, const E* x, int n_x, int h, int d,
        E* y, float* scratch, const float* der, const float* a_l,
        const float* a_r, float* d_el, int n_units, int n_split,
        cudaStream_t stream) {
  if (rows == 2)
    return launch_row_sum<E, 2, BWD>(table, n_buckets, cols, nodes, n_rows,
                                     zero_nodes, n_zero, widx, w, x, n_x, h,
                                     d, y, scratch, der, a_l, a_r, d_el,
                                     n_units, n_split, stream);
  if (rows == 1)
    return launch_row_sum<E, 1, BWD>(table, n_buckets, cols, nodes, n_rows,
                                     zero_nodes, n_zero, widx, w, x, n_x, h,
                                     d, y, scratch, der, a_l, a_r, d_el,
                                     n_units, n_split, stream);
  return launch_sum<E, PL, BWD>(table, n_buckets, cols, nodes, n_rows,
                                zero_nodes, n_zero, widx, w, x, n_x, h, d, y,
                                scratch, der, a_l, a_r, d_el, n_units,
                                n_split, stream);
}

template <typename E, int PL>
int fwd(int rows, const int* table, int n_buckets, const int* cols,
        const int* nodes,
        int n_rows, const int* zero_nodes, int n_zero, const int* flat,
        const E* z, const float* a_l, const float* a_r, int n_x, int h, int d,
        float slope, E* out, float* alpha, float* el, float* er,
        float* scratch, int n_units, int n_split, cudaStream_t stream) {
  const int G = lanes_for(d, PL);
  const int n_ch = (d + G * PL - 1) / (G * PL);
  unsigned b;
  int err = blocks_for((long long)n_x * h, G, &b);
  if (err) return err;
  if (b) {
    gat_scores_kernel<E, PL><<<b, THREADS, 0, stream>>>(z, a_l, a_r, n_x, h,
                                                         d, G, n_ch, el, er);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (n_rows > 0) {
    gat_softmax_kernel<<<(n_rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        table, n_buckets, cols, nodes, n_rows, flat, el, er, h, n_x, slope,
        alpha);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return sum<E, PL, false>(rows, table, n_buckets, cols, nodes, n_rows,
                           zero_nodes, n_zero, flat, alpha, z, n_x, h, d, out,
                           scratch, nullptr, nullptr, nullptr, nullptr,
                           n_units, n_split, stream);
}

template <typename E, int PL>
int bwd_dst(const int* table, int n_buckets, const int* cols,
            const int* nodes, int n_rows, const int* zero_nodes, int n_zero,
            const int* flat, const E* z, const E* dy, const float* alpha,
            const float* el, const float* er, int n_x, int h, int d,
            float slope, float* dal, float* ad, float* der, int n_units,
            cudaStream_t stream) {
  const int G = lanes_for(d, PL);
  const int n_ch = (d + G * PL - 1) / (G * PL);
  unsigned b;
  int err = blocks_for((long long)n_units * h, G, &b);
  if (err) return err;
  if (b) {
    gat_dot_kernel<E, PL><<<b, THREADS, 0, stream>>>(
        table, n_buckets, cols, nodes, n_rows, z, dy, n_x, h, d, G, n_ch,
        dal);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const long long warps = (long long)n_rows + n_zero;
  if (warps == 0) return 0;
  gat_dpre_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, 0,
                    stream>>>(table, n_buckets, cols, nodes, n_rows,
                              zero_nodes, n_zero, flat, alpha, dal, el, er, h,
                              n_x, slope, ad, der);
  return (int)cudaGetLastError();
}

template <typename E, int PL>
int bwd_src(int rows, const int* table, int n_buckets, const int* cols,
            const int* nodes, int n_rows, const int* zero_nodes, int n_zero,
            const int* twin, const E* dy, const float* ad, const float* der,
            const E* z, const float* a_l, const float* a_r, int n_x, int h,
            int d, E* dz, float* d_el, float* d_a, float* scratch,
            float* node_scratch, int n_units, int n_split,
            cudaStream_t stream) {
  int err = sum<E, PL, true>(rows, table, n_buckets, cols, nodes, n_rows,
                             zero_nodes, n_zero, twin, ad, dy, n_x, h, d, dz,
                             scratch, der, a_l, a_r, d_el, n_units, n_split,
                             stream);
  if (err) return err;
  const int W = h * d;
  const int n_parts = (n_x + NODE_CHUNK - 1) / NODE_CHUNK;
  if (n_parts == 0) {
    return (int)cudaMemsetAsync(d_a, 0, sizeof(float) * 2 * W, stream);
  }
  gat_node_grad_kernel<E><<<n_parts, THREADS, 0, stream>>>(z, d_el, der, n_x,
                                                           h, d, node_scratch);
  if ((err = (int)cudaGetLastError())) return err;
  gat_node_grad_combine_kernel<<<(2 * W + THREADS - 1) / THREADS, THREADS, 0,
                                 stream>>>(node_scratch, n_parts, W, d_a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `lanes`, in each entry point, says how the rows' features are spread
// (ops/kernels/ell_gat.py lane_mode): 4, four features of one head a lane
// as one 16-byte (f32) or 8-byte (bf16) load (d % 4 == 0, the row arrays
// aligned to 4 elements); 2 or 1, whole rows (the sums a warp a row piece,
// 2 features a load when d is even and the row arrays are aligned to 2
// elements; h <= ROW_HEADS); 0, one feature a lane in 32-feature chunks.
// The dot sweep takes one feature a lane unless lanes is 4.

// The forward on the dst packing's table (table, cols, nodes, zero_nodes
// as for gather_sum_f32; flat: each table slot's place in the packing's
// flat slot order). z (n_x, h, d) f32, a_l and a_r (h, d) f32 ->
// out (n_x, h, d) f32, alpha (flat slots, h) f32 (the slots of real rows
// written; a pad slot's place is not), el and er (n_x, h) f32. lanes: z,
// out, a_l, a_r aligned as it says. scratch: h d floats a piece of a split
// row (null when none is split); n_units and n_split as for
// gather_sum_f32.
int ell_gat_fwd_f32(const int* table, int n_buckets, const int* cols,
                    const int* nodes, int n_rows, const int* zero_nodes,
                    int n_zero, const int* flat, const float* z,
                    const float* a_l, const float* a_r, int n_x, int h, int d,
                    float slope, float* out, float* alpha, float* el,
                    float* er, float* scratch, int n_units, int n_split,
                    int lanes, int device, cudaStream_t stream) {
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return lanes == 4
             ? fwd<float, 4>(0, table, n_buckets, cols, nodes, n_rows,
                             zero_nodes, n_zero, flat, z, a_l, a_r, n_x, h,
                             d, slope, out, alpha, el, er, scratch, n_units,
                             n_split, stream)
             : fwd<float, 1>(lanes, table, n_buckets, cols, nodes, n_rows,
                             zero_nodes, n_zero, flat, z, a_l, a_r, n_x, h,
                             d, slope, out, alpha, el, er, scratch, n_units,
                             n_split, stream);
}

// The same with z and out bf16; a_l, a_r and every other float array f32.
int ell_gat_fwd_bf16(const int* table, int n_buckets, const int* cols,
                     const int* nodes, int n_rows, const int* zero_nodes,
                     int n_zero, const int* flat, const bf16* z,
                     const float* a_l, const float* a_r, int n_x, int h,
                     int d, float slope, bf16* out, float* alpha, float* el,
                     float* er, float* scratch, int n_units, int n_split,
                     int lanes, int device, cudaStream_t stream) {
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return lanes == 4
             ? fwd<bf16, 4>(0, table, n_buckets, cols, nodes, n_rows,
                            zero_nodes, n_zero, flat, z, a_l, a_r, n_x, h, d,
                            slope, out, alpha, el, er, scratch, n_units,
                            n_split, stream)
             : fwd<bf16, 1>(lanes, table, n_buckets, cols, nodes, n_rows,
                            zero_nodes, n_zero, flat, z, a_l, a_r, n_x, h, d,
                            slope, out, alpha, el, er, scratch, n_units,
                            n_split, stream);
}

// Backward pass 1 on the dst packing's table: z, dy (n_x, h, d) f32, alpha,
// el, er from the forward -> dal (table slots, h) f32 (scratch: dα in table
// slot order), ad (flat slots, 2 h) f32 (each real slot's α then dpre),
// der (n_x, h) f32 (0 for the zero rows). lanes: z and dy aligned as it
// says. n_units as for gather_sum_f32.
int ell_gat_bwd_dst_f32(const int* table, int n_buckets, const int* cols,
                        const int* nodes, int n_rows, const int* zero_nodes,
                        int n_zero, const int* flat, const float* z,
                        const float* dy, const float* alpha, const float* el,
                        const float* er, int n_x, int h, int d, float slope,
                        float* dal, float* ad, float* der, int n_units,
                        int lanes, int device, cudaStream_t stream) {
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return lanes == 4
             ? bwd_dst<float, 4>(table, n_buckets, cols, nodes, n_rows,
                                 zero_nodes, n_zero, flat, z, dy, alpha, el,
                                 er, n_x, h, d, slope, dal, ad, der, n_units,
                                 stream)
             : bwd_dst<float, 1>(table, n_buckets, cols, nodes, n_rows,
                                 zero_nodes, n_zero, flat, z, dy, alpha, el,
                                 er, n_x, h, d, slope, dal, ad, der, n_units,
                                 stream);
}

// The same with z and dy bf16.
int ell_gat_bwd_dst_bf16(const int* table, int n_buckets, const int* cols,
                         const int* nodes, int n_rows, const int* zero_nodes,
                         int n_zero, const int* flat, const bf16* z,
                         const bf16* dy, const float* alpha, const float* el,
                         const float* er, int n_x, int h, int d, float slope,
                         float* dal, float* ad, float* der, int n_units,
                         int lanes, int device, cudaStream_t stream) {
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return lanes == 4
             ? bwd_dst<bf16, 4>(table, n_buckets, cols, nodes, n_rows,
                                zero_nodes, n_zero, flat, z, dy, alpha, el,
                                er, n_x, h, d, slope, dal, ad, der, n_units,
                                stream)
             : bwd_dst<bf16, 1>(table, n_buckets, cols, nodes, n_rows,
                                zero_nodes, n_zero, flat, z, dy, alpha, el,
                                er, n_x, h, d, slope, dal, ad, der, n_units,
                                stream);
}

// Backward pass 2 on the src packing's table (twin: each table slot's place
// in the dst packing's flat order): dy, z (n_x, h, d) f32, ad and der from
// pass 1, a_l, a_r (h, d) f32 -> dz (n_x, h, d) f32, d_el (n_x, h) f32,
// d_a (2, h, d) f32 (d_a_l then d_a_r). scratch: h d + h floats a piece of
// a split row (null when none is split); node_scratch: ceil(n_x / 256) * 2
// h d floats. lanes: dy, z, dz, a_l, a_r aligned as it says.
int ell_gat_bwd_src_f32(const int* table, int n_buckets, const int* cols,
                        const int* nodes, int n_rows, const int* zero_nodes,
                        int n_zero, const int* twin, const float* dy,
                        const float* ad, const float* der, const float* z,
                        const float* a_l, const float* a_r, int n_x, int h,
                        int d, float* dz, float* d_el, float* d_a,
                        float* scratch, float* node_scratch, int n_units,
                        int n_split, int lanes, int device,
                        cudaStream_t stream) {
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return lanes == 4
             ? bwd_src<float, 4>(0, table, n_buckets, cols, nodes, n_rows,
                                 zero_nodes, n_zero, twin, dy, ad, der, z,
                                 a_l, a_r, n_x, h, d, dz, d_el, d_a, scratch,
                                 node_scratch, n_units, n_split, stream)
             : bwd_src<float, 1>(lanes, table, n_buckets, cols, nodes,
                                 n_rows, zero_nodes, n_zero, twin, dy, ad,
                                 der, z, a_l, a_r, n_x, h, d, dz, d_el, d_a,
                                 scratch, node_scratch, n_units, n_split,
                                 stream);
}

// The same with dy, z and dz bf16 (a_l, a_r f32).
int ell_gat_bwd_src_bf16(const int* table, int n_buckets, const int* cols,
                         const int* nodes, int n_rows, const int* zero_nodes,
                         int n_zero, const int* twin, const bf16* dy,
                         const float* ad, const float* der, const bf16* z,
                         const float* a_l, const float* a_r, int n_x, int h,
                         int d, bf16* dz, float* d_el, float* d_a,
                         float* scratch, float* node_scratch, int n_units,
                         int n_split, int lanes, int device,
                         cudaStream_t stream) {
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return lanes == 4
             ? bwd_src<bf16, 4>(0, table, n_buckets, cols, nodes, n_rows,
                                zero_nodes, n_zero, twin, dy, ad, der, z,
                                a_l, a_r, n_x, h, d, dz, d_el, d_a, scratch,
                                node_scratch, n_units, n_split, stream)
             : bwd_src<bf16, 1>(lanes, table, n_buckets, cols, nodes, n_rows,
                                zero_nodes, n_zero, twin, dy, ad, der, z,
                                a_l, a_r, n_x, h, d, dz, d_el, d_a, scratch,
                                node_scratch, n_units, n_split, stream);
}

}  // extern "C"
