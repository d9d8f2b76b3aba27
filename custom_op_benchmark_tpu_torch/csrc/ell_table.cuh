// The ELL row engine shared by the kernels that sweep a packing's
// GatherTable in one launch: S3's copy-sum (gather_sum.cu) and the GAT
// attention's sweeps (ell_gat.cu).
//
// The table (graph/ell.py GatherTable) lists per bucket, widest first, 3
// ints: the offset of its rows' slots in cols, its width D and its first
// row; nodes[row] is each row's node and zero_nodes the nodes with no row.
// A slot whose column lies outside [0, n_x) is a pad slot.
//
// Tasks. A row of more than PIECE slots is taken as ceil(D / PIECE) pieces
// of PIECE consecutive slots, each a unit of its own (a row of at most
// PIECE slots is one unit). The units are numbered in table order, widest
// bucket first, so hub rows' pieces start first; a sum writes each split
// row's pieces as partials, in the same numbering, and a second launch
// combines each split row's partials in piece order. The split depends
// only on the inputs and PIECE, never on the grid or the SM count, so the
// same inputs give the same bits on every run and every card. A unit is
// taken by a group of G lanes (a power of two, 32 / G groups a warp),
// numbered over the grid (group_of).
//
// Pad slots are skipped (compact_walk): a warp-wide group loads 32 column
// ids at once, coalesced, takes a ballot of the valid ones and compacts
// them in slot order into shared memory, then walks only those.

#pragma once

#include <cuda_runtime.h>

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// Rows loaded into registers before they are used.
constexpr int UNROLL = 4;
constexpr int PIECE = 256;
constexpr int MAX_BUCKETS = 64;

// The lanes a row takes: the smallest power of two that covers width at
// per_lane features a lane, at most 32.
inline int lanes_for(int width, int per_lane) {
  const int need = (width + per_lane - 1) / per_lane;
  int g = 1;
  while (g < need && g < 32) g <<= 1;
  return g;
}

// The blocks that hold `groups` groups of G lanes, or an error when more
// than a grid takes.
inline int blocks_for(long long groups, int G, unsigned* out) {
  const long long per_block = (long long)WARPS * (32 / G);
  const long long b = (groups + per_block - 1) / per_block;
  if (b > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *out = (unsigned)b;
  return 0;
}

// A group of G lanes: its task (numbered over the grid, 32 / G a warp),
// the lane in the warp and in the group, and the mask of its lanes.
struct Group {
  long long task;
  int lane, in_group;
  unsigned mask;
};

__device__ __forceinline__ Group group_of(int G) {
  Group g;
  g.lane = threadIdx.x & 31;
  g.in_group = g.lane & (G - 1);
  g.task = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * (32 / G) +
           g.lane / G;
  g.mask = (G == 32 ? FULL : (1u << G) - 1) << (g.lane & ~(G - 1));
  return g;
}

// The table in shared memory, with each bucket's pieces a row and where its
// units, partials and split rows begin; the entry at n_buckets holds the
// totals.
struct Tab {
  int off[MAX_BUCKETS], width[MAX_BUCKETS], pieces[MAX_BUCKETS];
  int first[MAX_BUCKETS + 1];
  long long unit0[MAX_BUCKETS + 1], part0[MAX_BUCKETS + 1],
      split0[MAX_BUCKETS + 1];
};

__device__ __forceinline__ void load_tab(Tab& t, const int* table,
                                         int n_buckets, int n_rows) {
  for (int b = threadIdx.x; b < n_buckets; b += THREADS) {
    t.off[b] = table[3 * b];
    t.width[b] = table[3 * b + 1];
    t.first[b] = table[3 * b + 2];
    t.pieces[b] = t.width[b] > PIECE ? (t.width[b] + PIECE - 1) / PIECE : 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    t.first[n_buckets] = n_rows;
    long long u = 0, p = 0, s = 0;
    for (int b = 0; b < n_buckets; ++b) {
      t.unit0[b] = u;
      t.part0[b] = p;
      t.split0[b] = s;
      const long long rows = t.first[b + 1] - t.first[b];
      u += rows * t.pieces[b];
      if (t.pieces[b] > 1) {
        p += rows * t.pieces[b];
        s += rows;
      }
    }
    t.unit0[n_buckets] = u;
    t.part0[n_buckets] = p;
    t.split0[n_buckets] = s;
  }
  __syncthreads();
}

// The bucket whose range of a (a prefix over the buckets) holds v.
template <typename T>
__device__ __forceinline__ int bucket_of(const T* a, int n_buckets,
                                         long long v) {
  int b = 0;
  while (b + 1 < n_buckets && a[b + 1] <= v) ++b;
  return b;
}

// A unit: its bucket, its row in the table, the row's pieces P, its slots
// [base + k0, base + k1) of cols, and its partial (when P > 1).
struct Piece {
  int b, row, P, k0, k1;
  long long base, part;
};

__device__ __forceinline__ Piece piece_of(const Tab& t, int n_buckets,
                                          long long unit) {
  Piece q;
  q.b = bucket_of(t.unit0, n_buckets, unit);
  const long long local = unit - t.unit0[q.b];
  q.P = t.pieces[q.b];
  const int D = t.width[q.b];
  q.row = (int)(local / q.P);
  const int piece = (int)(local % q.P);
  q.base = t.off[q.b] + (long long)q.row * D;
  q.k0 = piece * PIECE;
  q.k1 = min(D, q.k0 + PIECE);
  q.part = t.part0[q.b] + local;
  return q;
}

// A split row of the combine: its bucket, its row in the table, its pieces
// P and its first partial.
struct Split {
  int b, row, P;
  long long part;
};

__device__ __forceinline__ Split split_of(const Tab& t, int n_buckets,
                                          long long unit) {
  Split s;
  s.b = bucket_of(t.split0, n_buckets, unit);
  s.row = (int)(unit - t.split0[s.b]);
  s.P = t.pieces[s.b];
  s.part = t.part0[s.b] + (long long)s.row * s.P;
  return s;
}

// A warp's walk over the slots [k0, k1) of a row whose column ids start at
// cols, 32 at a time: each lane loads one id, a ballot takes those inside
// [0, n_x), and each valid lane writes its id at its rank among them into
// the warp's ids[32] and, with more, extra(k) of its slot k into more[32];
// then visit(n) reads the n compacted slots. A pad slot costs nothing but
// its share of one load. Every lane of the warp calls it.
template <typename Extra, typename Visit>
__device__ __forceinline__ void compact_walk(const int* __restrict__ cols,
                                             int k0, int k1, int n_x,
                                             int lane, int* ids, int* more,
                                             Extra extra, Visit visit) {
  for (int base = k0; base < k1; base += 32) {
    const int k = base + lane;
    const int mine = k < k1 ? __ldg(cols + k) : -1;
    const unsigned valid =
        __ballot_sync(FULL, (unsigned)mine < (unsigned)n_x);
    if ((valid >> lane) & 1) {
      const int at = __popc(valid & ((1u << lane) - 1));
      ids[at] = mine;
      if (more) more[at] = extra(k);
    }
    __syncwarp();
    visit(__popc(valid));
    __syncwarp();                           // read before rewritten
  }
}
