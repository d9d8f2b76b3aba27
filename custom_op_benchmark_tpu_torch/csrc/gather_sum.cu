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
// Each sum is written once, straight to its node's row.
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
// are random, so the rate is set by how many of them are in flight and by
// the L2's rate for them; x itself often fits the 50 MB L2.
//
// The design (one row engine for both entries; the table, its task
// numbering and the pad-skipping walk are ell_table.cuh's, which the GAT
// attention's sweeps in ell_gat.cu share):
//
// - Lanes sized to the width. A row's features are spread over G lanes,
//   4 a lane as one 16-byte load (8 bytes for bf16) when rows are
//   aligned, else 1 a lane; G is the smallest power of two that covers d,
//   at most 32, and a warp takes 32 / G rows. Wider rows take several
//   feature chunks of 32 lanes, one warp task each. At d = 64 two rows
//   share a warp; at d = 4, 32.
// - Slot order, compensated. Each lane sums its features over the row's
//   slots in slot order, in f32 registers, with a compensated (Kahan) sum:
//   a plain running sum loses about sqrt(D) roundings (4.6e-4 on a
//   power-law hub row of D = 8192 against a tree-summed reference), the
//   compensated sum stays within a few roundings at any D. A row is the
//   same sequence of operations as in the earlier kernel (one warp a row),
//   so a row that is neither split nor padded gives the same bits.
// - Pad slots skipped. A warp-wide group loads 32 column ids at once,
//   coalesced, takes a ballot of those inside [0, n_x) and compacts them
//   in slot order into shared memory (each valid lane writes its id at
//   its rank among them), then walks only those; narrower groups load
//   their ids as they go and skip the same slots. The earlier kernel
//   added 0 for a pad slot inside a group of 4, and a Kahan add of 0 can
//   move the sum by its carry: rows with pad slots may change bits.
// - Loads before adds. UNROLL rows are loaded into registers before they
//   are added, so each group keeps 4 rows in flight, an SM 160 or more
//   (48 registers a thread: 40 warps). A ring of asynchronous copies
//   (cp.async) into each lane's own stages of shared memory was measured
//   against it on the card (experiments/ab_gather.py, 2 to 8 stages, f32
//   and bf16, all rounds or only those of 4, 8 or 16 valid slots): it won
//   up to 7 % on the uniform 16-slot experiment shape and lost up to 11 %
//   on the power-law dst table and on bf16, so rows stay in registers.
// - Long rows in fixed pieces. A row of more than PIECE slots is summed as
//   pieces of PIECE consecutive slots, each a task of its own that writes
//   its compensated partial (sum and carry, f32) to a scratch the wrapper
//   allocates; a second launch combines each row's partials in piece
//   order, compensated, and stores the row. So a hub row of 27,565 slots
//   is 108 tasks that run at once instead of one warp's chain of 6,900
//   rounds. The split depends only on the inputs and PIECE, never on the
//   grid or the SM count; no atomics are used (every task owns what it
//   writes, and each output row is named once), so the same inputs give
//   the same bits on every run and every card. PIECE = 256: the
//   power-of-two ELL buckets up to 256 slots stay whole (their bits do
//   not change), a piece is a chain of 64 rounds of 4 loads, about what a
//   row of an ordinary bucket takes, and the scratch is at most 4 d
//   floats for each PIECE slots (1.6 % of an identity x).
//   ELL entry: bucket b's rows have ceil(D_b / PIECE) pieces each (1 for
//   D_b <= PIECE), so the task numbering follows from the table, which
//   every block copies to shared memory (at most 64 buckets) with each
//   bucket's first task, first partial and first split row. Tasks run in
//   table order, widest bucket first, so hub rows' pieces start first;
//   the zero rows come last.
//   CSR entry: ptr lives on the card and is not scanned. The slot range
//   [0, n_slots) is cut into windows of PIECE slots, one piece task each,
//   and rows are tasks of their own: a row of at most PIECE slots is
//   summed by its row task; a longer row, by the piece tasks of the
//   windows it covers. A window meets at most two long rows (the one
//   holding its first slot, and one starting inside it), found by a
//   search in ptr that the row's G lanes share (G rows probed a step);
//   each writes its partial to the window's two slots, and
//   the window holding a long row's end names that row for the combine.
//   The launch is sized from what the host knows: n_rows + ceil(n_slots /
//   PIECE) tasks, n_slots = idx's length, or x's rows for identity slots.
//   Piece tasks come first.
//
// bf16 (gather_sum_bf16, csr_sum_bf16): x and y are bf16, as the TPU
// kernel runs in x.dtype. Rows are read as bf16 (half the bytes of f32:
// the bound halves) and widened to f32, which is exact; the sums and
// partials are f32 exactly as above, and each sum is rounded to bf16 once,
// at the store (to nearest even). The vector path moves 4 bf16 a lane as
// one 8-byte load; it needs d % 4 == 0 and 8-byte aligned rows, else one
// bf16 a lane.

// CSR entry (csr_sum): y[r, :] = sum_{k in [ptr[r], ptr[r+1])} x[idx[k], :]
// with idx optional (the identity: slot k reads row k). This is S3's
// function over a CSR row range instead of an ELL table: the sorted
// segment sum of the segment ops (ops/xla.py segment_sum, with idx the
// CSC permutation on the dst side), the copy forms of gspmm (idx = the
// other endpoint, so the (E, d) message never reaches memory) and the
// backward of the sampled copy-sum (ops/sampled.py). It needs no padding
// and no table build, which matters where a sampled batch brings a new
// graph every step. It replaces index_add_, whose atomics on the card add
// in an order that changes from run to run. Slots at or past n_slots add
// zero (ptr is clipped there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_table.cuh"

namespace {

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
  static constexpr int PER_LANE = 4;
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T neg(const T& v) {
    return make_float4(-v.x, -v.y, -v.z, -v.w);
  }
  __device__ static void add(T& s, T& c, const T& v) {
    kahan_add(s.x, c.x, v.x);
    kahan_add(s.y, c.y, v.y);
    kahan_add(s.z, c.z, v.z);
    kahan_add(s.w, c.w, v.w);
  }
  // f32 partials in the scratch (16-byte aligned: d % 4 == 0).
  __device__ static void put(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static T get(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

struct Vec1 {
  static constexpr int PER_LANE = 1;
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T neg(const T& v) { return -v; }
  __device__ static void add(T& s, T& c, const T& v) { kahan_add(s, c, v); }
  __device__ static void put(float* p, const T& v) { *p = v; }
  __device__ static T get(const float* p) { return *p; }
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

// Where a lane works: its group's task (task / n_chunks is the unit: a
// row, a piece or a zero row; task % n_chunks the feature chunk), its lane
// in the group and its first feature f (active: f < d).
struct Lane {
  int lane, in_group, chunk, f;
  long long unit;
  bool active;
};

template <typename C>
__device__ __forceinline__ Lane lane_of(int G, int d, int n_chunks) {
  const Group g = group_of(G);
  Lane l;
  l.lane = g.lane;
  l.in_group = g.in_group;
  l.unit = g.task / n_chunks;
  l.chunk = (int)(g.task % n_chunks);
  l.f = (l.chunk * G + l.in_group) * C::PER_LANE;
  l.active = l.f < d;
  return l;
}

// The sum, at this lane's features, of x's rows named by slots k0 ..
// k1 - 1, in slot order, compensated, added to (acc, carry). With IDX slot
// k names row ids[k], else row k itself; a slot naming a row outside
// [0, n_x) is skipped. A warp-wide group (G == 32) with ids walks only
// the valid slots (compact_walk, into its warp's 32 ints of shared memory
// `compact`); narrower groups and slots that are rows load as they go.
// UNROLL rows are loaded before they are added.
template <typename E, bool VEC, bool IDX>
__device__ __forceinline__ void seg_sum(
    const int* __restrict__ ids, int k0, int k1, const E* __restrict__ x,
    int d, int n_x, const Lane& l, int G, int* compact,
    typename Chunk<E, VEC>::T& acc, typename Chunk<E, VEC>::T& carry) {
  using C = Chunk<E, VEC>;
  if (IDX && G == 32) {
    compact_walk(ids, k0, k1, n_x, l.lane, compact, nullptr,
                 [](int) { return 0; }, [&](int n) {
      int j = 0;
      for (; j + UNROLL <= n; j += UNROLL) {
        typename C::T v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          v[u] = l.active ? C::load(x + (size_t)compact[j + u] * d + l.f)
                          : C::zero();
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) C::add(acc, carry, v[u]);
      }
      for (; j < n; ++j)
        if (l.active)
          C::add(acc, carry, C::load(x + (size_t)compact[j] * d + l.f));
    });
    return;
  }
  int k = k0;
  for (; k + UNROLL <= k1; k += UNROLL) {
    int c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) c[u] = IDX ? __ldg(ids + k + u) : k + u;
    typename C::T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = (l.active && (unsigned)c[u] < (unsigned)n_x)
                 ? C::load(x + (size_t)c[u] * d + l.f)
                 : C::zero();
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if ((unsigned)c[u] < (unsigned)n_x) C::add(acc, carry, v[u]);
  }
  for (; k < k1; ++k) {
    const int c = IDX ? __ldg(ids + k) : k;
    if (l.active && (unsigned)c < (unsigned)n_x)
      C::add(acc, carry, C::load(x + (size_t)c * d + l.f));
  }
}

// A partial (sum, carry) of d floats each, at index s of the scratch.
__device__ __forceinline__ float* partial(float* scratch, long long s,
                                          int d) {
  return scratch + (size_t)s * 2 * d;
}

template <typename C>
__device__ __forceinline__ void put_partial(float* p, int d, int f,
                                            const typename C::T& acc,
                                            const typename C::T& carry) {
  C::put(p + f, acc);
  C::put(p + d + f, carry);
}

// Adds a partial to (s, c): its sum, then minus its carry (the partial's
// value is sum - carry), each compensated.
template <typename C>
__device__ __forceinline__ void add_partial(const float* p, int d, int f,
                                            typename C::T& s,
                                            typename C::T& c) {
  C::add(s, c, C::get(p + f));
  C::add(s, c, C::neg(C::get(p + d + f)));
}

// ---------------------------------------------------------------------------
// ELL entry
// ---------------------------------------------------------------------------

// Pass 1: one group per unit: a piece of a row, in table order (a row of
// one piece is stored at once, a longer row's pieces go to the scratch),
// then the zero rows.
template <typename E, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const int* __restrict__ table, int n_buckets,
                  const int* __restrict__ cols, const int* __restrict__ nodes,
                  int n_rows, const int* __restrict__ zero_nodes, int n_zero,
                  const E* __restrict__ x, E* __restrict__ y, int d, int n_x,
                  int G, int n_chunks, float* __restrict__ scratch) {
  using C = Chunk<E, VEC>;
  __shared__ Tab tab;
  __shared__ int compact_ids[THREADS];
  int* const compact = compact_ids + (threadIdx.x & ~31);
  load_tab(tab, table, n_buckets, n_rows);
  const Lane l = lane_of<C>(G, d, n_chunks);
  const long long n_units = tab.unit0[n_buckets];
  if (l.unit >= n_units) {
    const long long z = l.unit - n_units;
    if (z < n_zero && l.active)
      C::store(y + (size_t)zero_nodes[z] * d + l.f, C::zero());
    return;
  }
  const Piece q = piece_of(tab, n_buckets, l.unit);
  typename C::T acc = C::zero(), carry = C::zero();
  seg_sum<E, VEC, true>(cols + q.base, q.k0, q.k1, x, d, n_x, l, G, compact,
                        acc, carry);
  if (!l.active) return;
  if (q.P == 1)
    C::store(y + (size_t)nodes[tab.first[q.b] + q.row] * d + l.f, acc);
  else
    put_partial<C>(partial(scratch, q.part, d), d, l.f, acc, carry);
}

// Pass 2: one group per split row, in table order: its partials combined
// in piece order, compensated, and stored.
template <typename E, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_combine_kernel(const int* __restrict__ table, int n_buckets,
                      const int* __restrict__ nodes, int n_rows,
                      E* __restrict__ y, int d, int G, int n_chunks,
                      const float* __restrict__ scratch) {
  using C = Chunk<E, VEC>;
  __shared__ Tab tab;
  load_tab(tab, table, n_buckets, n_rows);
  const Lane l = lane_of<C>(G, d, n_chunks);
  if (l.unit >= tab.split0[n_buckets] || !l.active) return;
  const Split sp = split_of(tab, n_buckets, l.unit);
  typename C::T s = C::zero(), c = C::zero();
  for (int p = 0; p < sp.P; ++p)
    add_partial<C>(partial(const_cast<float*>(scratch), sp.part + p, d), d,
                   l.f, s, c);
  C::store(y + (size_t)nodes[tab.first[sp.b] + sp.row] * d + l.f, s);
}

// Units (pass 1) and split rows (pass 2) are bounds from the host; the
// kernels count the exact numbers from the table and the rest exit.
template <typename E, bool VEC>
int launch(const int* table, int n_buckets, const int* cols,
           const int* nodes, int n_rows, const int* zero_nodes, int n_zero,
           const E* x, E* y, int d, int n_x, float* scratch, int n_units,
           int n_split, cudaStream_t stream) {
  using C = Chunk<E, VEC>;
  if (n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  const int G = lanes_for(d, C::PER_LANE);
  const int n_chunks = (d + G * C::PER_LANE - 1) / (G * C::PER_LANE);
  unsigned b1, b2;
  int bad = blocks_for((long long)n_units * n_chunks, G, &b1);
  if (!bad) bad = blocks_for((long long)n_split * n_chunks, G, &b2);
  if (bad) return bad;
  if (b1 == 0) return 0;
  gather_sum_kernel<E, VEC><<<b1, THREADS, 0, stream>>>(
      table, n_buckets, cols, nodes, n_rows, zero_nodes, n_zero, x, y, d,
      n_x, G, n_chunks, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || b2 == 0) return (int)err;
  gather_combine_kernel<E, VEC><<<b2, THREADS, 0, stream>>>(
      table, n_buckets, nodes, n_rows, y, d, G, n_chunks, scratch);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const int* table, int n_buckets, const int* cols,
             const int* nodes, int n_rows, const int* zero_nodes, int n_zero,
             const E* x, E* y, int d, int n_x, int vec, float* scratch,
             int n_units, int n_split, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  return vec ? launch<E, true>(table, n_buckets, cols, nodes, n_rows,
                               zero_nodes, n_zero, x, y, d, n_x, scratch,
                               n_units, n_split, stream)
             : launch<E, false>(table, n_buckets, cols, nodes, n_rows,
                                zero_nodes, n_zero, x, y, d, n_x, scratch,
                                n_units, n_split, stream);
}

// ---------------------------------------------------------------------------
// CSR entry
// ---------------------------------------------------------------------------

// The row whose range holds slot k: the last r in [lo, n_rows] with
// ptr[r] <= k (n_rows: k lies past every row), given ptr[lo] <= k. The
// group's G lanes probe G rows a step, ballot, and keep the range after
// the last row that is not past k: log_G(n_rows) steps of one load a lane
// (a single lane: binary search). With `near` the first step probes the G
// rows from lo on, where the row is when lo's row is close before it.
__device__ __forceinline__ int row_from(const int* __restrict__ ptr,
                                        int n_rows, int k, int lo, bool near,
                                        const Lane& l, int G) {
  int hi = n_rows + 1;             // ptr[lo] <= k; hi past the answer
  if (G == 1) {
    while (hi - lo > 1) {
      const int mid = lo + ((hi - lo) >> 1);
      if (__ldg(ptr + mid) <= k) lo = mid; else hi = mid;
    }
    return lo;
  }
  const int base = l.lane & ~(G - 1);
  const unsigned mask = (G == 32 ? FULL : (1u << G) - 1) << base;
  int step = near ? 1 : 0;
  while (hi - lo > 1) {
    if (step == 0) step = (hi - lo + G - 1) / G;
    const int p = lo + l.in_group * step;
    const bool ok = p < hi && __ldg(ptr + p) <= k;
    const unsigned m = (__ballot_sync(mask, ok) & mask) >> base;
    const int j = 31 - __clz(m);   // lane 0 probes lo: m has bit 0
    if (j < G - 1) hi = min(hi, lo + (j + 1) * step);
    lo += j * step;
    step = 0;
  }
  return lo;
}

// row_from over every row, or -1 when k lies before the first.
__device__ __forceinline__ int row_of(const int* __restrict__ ptr,
                                      int n_rows, int k, const Lane& l,
                                      int G) {
  return __ldg(ptr) > k ? -1 : row_from(ptr, n_rows, k, 0, false, l, G);
}

// Row r's slots, clipped to [0, n_slots).
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span span_of(const int* __restrict__ ptr, int r,
                                        int n_slots) {
  const int lo = min(__ldg(ptr + r), n_slots);
  return {lo, max(lo, min(__ldg(ptr + r + 1), n_slots))};
}

// The scratch of the CSR entry: window t's two partials (2t: the long row
// holding its first slot; 2t + 1: a long row starting inside it), then one
// int a window naming the long row that ends in it (-1: none).
__device__ __forceinline__ int* window_ends(float* scratch, int n_windows,
                                            int d) {
  return reinterpret_cast<int*>(scratch + (size_t)n_windows * 4 * d);
}

// Pass 1: windows' piece tasks (units 0 .. n_windows - 1), then rows.
template <typename E, bool VEC, bool IDX>
__global__ void __launch_bounds__(THREADS)
csr_sum_kernel(const int* __restrict__ ptr, int n_rows,
               const int* __restrict__ idx, const E* __restrict__ x,
               E* __restrict__ y, int d, int n_x, int n_slots, int n_windows,
               int G, int n_chunks, float* __restrict__ scratch) {
  using C = Chunk<E, VEC>;
  __shared__ int compact_ids[THREADS];
  int* const compact = compact_ids + (threadIdx.x & ~31);
  const Lane l = lane_of<C>(G, d, n_chunks);
  typename C::T acc = C::zero(), carry = C::zero();
  if (l.unit < n_windows) {
    const int t = (int)l.unit;
    const int w0 = t * PIECE, w1 = w0 + min(PIECE, n_slots - w0);
    int ends = -1;
    const int a = row_of(ptr, n_rows, w0, l, G);
    if (a >= 0 && a < n_rows) {
      const Span s = span_of(ptr, a, n_slots);
      if (s.hi - s.lo > PIECE) {        // a long row holds w0
        seg_sum<E, VEC, IDX>(idx, w0, min(w1, s.hi), x, d, n_x, l, G,
                             compact, acc, carry);
        if (l.active)
          put_partial<C>(partial(scratch, 2LL * t, d), d, l.f, acc, carry);
        if (s.hi <= w1) ends = a;
      }
    }
    // The row holding the window's last slot: a few rows after a.
    const int b = a >= 0 ? row_from(ptr, n_rows, w1 - 1, a, true, l, G)
                         : row_of(ptr, n_rows, w1 - 1, l, G);
    if (b != a && b >= 0 && b < n_rows) {
      const Span s = span_of(ptr, b, n_slots);
      if (s.hi - s.lo > PIECE) {        // a long row starts inside
        acc = carry = C::zero();
        seg_sum<E, VEC, IDX>(idx, s.lo, w1, x, d, n_x, l, G, compact, acc,
                             carry);
        if (l.active)
          put_partial<C>(partial(scratch, 2LL * t + 1, d), d, l.f, acc,
                         carry);
      }
    }
    if (l.chunk == 0 && l.in_group == 0)
      window_ends(scratch, n_windows, d)[t] = ends;
    return;
  }
  const long long r = l.unit - n_windows;
  if (r >= n_rows) return;
  const Span s = span_of(ptr, (int)r, n_slots);
  if (s.hi - s.lo > PIECE) return;      // summed by the windows
  seg_sum<E, VEC, IDX>(idx, s.lo, s.hi, x, d, n_x, l, G, compact, acc,
                       carry);
  if (l.active) C::store(y + (size_t)r * d + l.f, acc);
}

// Pass 2: window t combines the long row that ends in it: the partials of
// windows t0 .. t in order (in t0, the second partial unless the row
// starts at t0's first slot).
template <typename E, bool VEC>
__global__ void __launch_bounds__(THREADS)
csr_combine_kernel(const int* __restrict__ ptr, E* __restrict__ y, int d,
                   int n_slots, int n_windows, int G, int n_chunks,
                   const float* __restrict__ scratch) {
  using C = Chunk<E, VEC>;
  const Lane l = lane_of<C>(G, d, n_chunks);
  if (l.unit >= n_windows || !l.active) return;
  const int t = (int)l.unit;
  float* sc = const_cast<float*>(scratch);
  const int r = window_ends(sc, n_windows, d)[t];
  if (r < 0) return;
  const int lo = min(__ldg(ptr + r), n_slots);
  const int t0 = lo / PIECE;
  typename C::T s = C::zero(), c = C::zero();
  for (int p = t0; p <= t; ++p) {
    const long long which = 2LL * p + (p == t0 && lo != t0 * PIECE);
    add_partial<C>(partial(sc, which, d), d, l.f, s, c);
  }
  C::store(y + (size_t)r * d + l.f, s);
}

template <typename E, bool VEC>
int launch_csr(const int* ptr, int n_rows, const int* idx, const E* x,
               E* y, int d, int n_x, float* scratch, int n_slots,
               cudaStream_t stream) {
  using C = Chunk<E, VEC>;
  const int G = lanes_for(d, C::PER_LANE);
  const int n_chunks = (d + G * C::PER_LANE - 1) / (G * C::PER_LANE);
  const long long per_block = (long long)WARPS * (32 / G);
  const int n_windows = (int)(((long long)n_slots + PIECE - 1) / PIECE);
  const long long b1 =
      (((long long)n_windows + n_rows) * n_chunks + per_block - 1) /
      per_block;
  const long long b2 =
      ((long long)n_windows * n_chunks + per_block - 1) / per_block;
  if (b1 > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (b1 == 0) return 0;
  if (idx)
    csr_sum_kernel<E, VEC, true><<<(unsigned)b1, THREADS, 0, stream>>>(
        ptr, n_rows, idx, x, y, d, n_x, n_slots, n_windows, G, n_chunks,
        scratch);
  else
    csr_sum_kernel<E, VEC, false><<<(unsigned)b1, THREADS, 0, stream>>>(
        ptr, n_rows, idx, x, y, d, n_x, n_slots, n_windows, G, n_chunks,
        scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || b2 == 0) return (int)err;
  csr_combine_kernel<E, VEC><<<(unsigned)b2, THREADS, 0, stream>>>(
      ptr, y, d, n_slots, n_windows, G, n_chunks, scratch);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_csr(const int* ptr, int n_rows, const int* idx, const E* x,
                 E* y, int d, int n_x, int vec, float* scratch, int n_slots,
                 int device, cudaStream_t stream) {
  cudaSetDevice(device);
  return vec ? launch_csr<E, true>(ptr, n_rows, idx, x, y, d, n_x, scratch,
                                   n_slots, stream)
             : launch_csr<E, false>(ptr, n_rows, idx, x, y, d, n_x, scratch,
                                    n_slots, stream);
}

}  // namespace

extern "C" {

// table (n_buckets, 3) int32, cols int32, nodes (n_rows,) int32,
// zero_nodes (n_zero,) int32, x (n_x, d) f32 -> y (n_out, d) f32, every
// row of y named once by nodes or zero_nodes. vec: x and y rows are
// 16-byte aligned (d % 4 == 0 and aligned base pointers). d > 0.
// scratch: f32, 2 d floats for each piece of a split row (a bucket wider
// than PIECE slots), or null when no bucket is split; n_units and n_split
// bound the rows' pieces plus the zero rows, and the split rows (the host
// counts them from its copy of the table; the kernels count them again
// from the table and the rest of the launch exits).
int gather_sum_f32(const int* table, int n_buckets, const int* cols,
                   const int* nodes, int n_rows, const int* zero_nodes,
                   int n_zero, const float* x, float* y, int d, int n_x,
                   int vec, float* scratch, int n_units, int n_split,
                   int device, cudaStream_t stream) {
  return dispatch<float>(table, n_buckets, cols, nodes, n_rows, zero_nodes,
                         n_zero, x, y, d, n_x, vec, scratch, n_units,
                         n_split, device, stream);
}

// The same in bf16: x (n_x, d) bf16 -> y (n_out, d) bf16, sums in f32,
// rounded once. vec: d % 4 == 0 and 8-byte aligned base pointers.
int gather_sum_bf16(const int* table, int n_buckets, const int* cols,
                    const int* nodes, int n_rows, const int* zero_nodes,
                    int n_zero, const bf16* x, bf16* y, int d, int n_x,
                    int vec, float* scratch, int n_units, int n_split,
                    int device, cudaStream_t stream) {
  return dispatch<bf16>(table, n_buckets, cols, nodes, n_rows, zero_nodes,
                        n_zero, x, y, d, n_x, vec, scratch, n_units, n_split,
                        device, stream);
}

// ptr (n_rows + 1,) int32, sorted; idx int32 naming a row of x for each
// slot, or null for the identity (slot k reads row k); x (n_x, d) f32 ->
// y (n_rows, d) f32, y[r] = sum of x's rows over slots ptr[r] ..
// ptr[r+1]-1 in slot order (compensated); a slot naming a row outside
// [0, n_x) adds zero, and so does a slot at or past n_slots (idx's length,
// or n_x for the identity). vec as for gather_sum_f32. d > 0. scratch:
// ceil(n_slots / PIECE) * (4 d + 1) floats.
int csr_sum_f32(const int* ptr, int n_rows, const int* idx, const float* x,
                float* y, int d, int n_x, int vec, float* scratch,
                int n_slots, int device, cudaStream_t stream) {
  return dispatch_csr<float>(ptr, n_rows, idx, x, y, d, n_x, vec, scratch,
                             n_slots, device, stream);
}

// The same in bf16: sums in f32, rounded once.
int csr_sum_bf16(const int* ptr, int n_rows, const int* idx, const bf16* x,
                 bf16* y, int d, int n_x, int vec, float* scratch,
                 int n_slots, int device, cudaStream_t stream) {
  return dispatch_csr<bf16>(ptr, n_rows, idx, x, y, d, n_x, vec, scratch,
                            n_slots, device, stream);
}

}  // extern "C"
