// graphcore — native host-side graph preprocessing for
// custom_op_benchmark_tpu_torch.
//
// The port's own copy of the JAX package's library of the same name
// (custom_op_benchmark_tpu/csrc/graphcore.cpp), so that the port builds
// and reads nothing of that package's tree. It is the cold-path graph
// preprocessing that the reference does in Python loops (wrapper.py:84-116
// dual-CSR construction; part_csr.py row chunking) and that real datasets
// (ogbn-*, papers100M-scale) need at C speed: canonical edge sorting,
// dual-CSR construction, edge-balanced partitioning, union-find
// components, degree-bucketed ELL packing, layered uniform neighbor
// sampling, and the halo planner and packer of the distributed plans.
//
// Exposed as a plain C ABI consumed via ctypes (graph/native.py) — no
// pybind11 dependency. All index arrays are int32; callers allocate
// outputs. Plain C++17, no CUDA.
//
// Build: graph/native.py runs g++ at first use into build/graphcore/ at
// the repository root.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

namespace {

// splitmix64 — cheap per-stream generator so every (hop, node) pair owns
// an independent deterministic stream: the sampled edge SET is invariant
// under frontier order and thread count.
inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Lemire bounded draw in [0, bound) — one multiply, no division.
inline uint32_t bounded(uint64_t& s, uint32_t bound) {
  return static_cast<uint32_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(splitmix64(s))) * bound)
      >> 32);
}

}  // namespace

extern "C" {

// Sort edges into canonical (src-major, dst-minor) order and build the
// dual CSR/CSC with canonical-eid permutations.
//
// Inputs:  src[e], dst[e] (any order), n_nodes, e.
// Outputs (caller-allocated):
//   src_c[e], dst_c[e]          — canonical-sorted endpoints
//   indptr_r[n_nodes + 2]       — CSR pointers (dummy pad segment last)
//   csc_perm[e], csc_perm_inv[e]
//   indptr_c[n_nodes + 2]
// Returns 0 on success, nonzero on bad input.
int32_t graphcore_build_dual_csr(
    const int64_t* src, const int64_t* dst, int64_t e, int64_t n_nodes,
    int32_t* src_c, int32_t* dst_c, int32_t* indptr_r,
    int32_t* csc_perm, int32_t* csc_perm_inv, int32_t* indptr_c) {
  if (e < 0 || n_nodes <= 0) return 1;

  // Counting sort by src (stable), then by dst within src via a second
  // counting pass — O(e + n), no comparison sort.
  std::vector<int64_t> cnt(n_nodes + 2, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] < 0 || src[i] >= n_nodes || dst[i] < 0 || dst[i] >= n_nodes)
      return 2;
    ++cnt[src[i] + 1];
  }
  std::partial_sum(cnt.begin(), cnt.end(), cnt.begin());

  // Bucket edges by src, then sort each src bucket by dst (buckets are
  // typically short; std::sort per bucket beats a global radix here).
  std::vector<int64_t> order(e);
  {
    std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < e; ++i) order[cursor[src[i]]++] = i;
  }
  for (int64_t u = 0; u < n_nodes; ++u) {
    auto beg = order.begin() + cnt[u];
    auto end = order.begin() + cnt[u + 1];
    std::stable_sort(beg, end, [&](int64_t a, int64_t b) {
      return dst[a] < dst[b];
    });
  }
  for (int64_t i = 0; i < e; ++i) {
    src_c[i] = static_cast<int32_t>(src[order[i]]);
    dst_c[i] = static_cast<int32_t>(dst[order[i]]);
  }
  for (int64_t u = 0; u <= n_nodes; ++u)
    indptr_r[u] = static_cast<int32_t>(cnt[u]);
  indptr_r[n_nodes + 1] = static_cast<int32_t>(e);

  // CSC: stable counting sort of canonical positions by dst.
  std::vector<int64_t> ccnt(n_nodes + 2, 0);
  for (int64_t i = 0; i < e; ++i) ++ccnt[dst_c[i] + 1];
  std::partial_sum(ccnt.begin(), ccnt.end(), ccnt.begin());
  {
    std::vector<int64_t> cursor(ccnt.begin(), ccnt.end() - 1);
    for (int64_t i = 0; i < e; ++i) {
      int64_t pos = cursor[dst_c[i]]++;
      csc_perm[pos] = static_cast<int32_t>(i);
      csc_perm_inv[i] = static_cast<int32_t>(pos);
    }
  }
  for (int64_t v = 0; v <= n_nodes; ++v)
    indptr_c[v] = static_cast<int32_t>(ccnt[v]);
  indptr_c[n_nodes + 1] = static_cast<int32_t>(e);
  return 0;
}

// Row chunking (reference contract: part_csr.py:13-27): split each CSR row
// into chunks of <= chunk_size edges. Two-phase: count then fill.
// Returns the number of chunks; if out arrays are null, only counts.
int64_t graphcore_partition_csr(
    const int32_t* indptr, int64_t n_rows, int32_t chunk_size,
    int32_t* row_out, int32_t* chunk_indptr_out) {
  int64_t total = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t deg = indptr[r + 1] - indptr[r];
    total += (deg + chunk_size - 1) / chunk_size;
  }
  if (row_out == nullptr || chunk_indptr_out == nullptr) return total;
  int64_t c = 0;
  chunk_indptr_out[0] = indptr[0];
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int32_t s = indptr[r]; s < indptr[r + 1]; s += chunk_size) {
      row_out[c] = static_cast<int32_t>(r);
      chunk_indptr_out[c + 1] =
          std::min<int32_t>(s + chunk_size, indptr[r + 1]);
      ++c;
    }
  }
  return total;
}

// Layered uniform neighbor sampling over a CSC (in-neighbor) structure.
// For each seed, draw <= fanout in-edges without replacement.
// Outputs: src_out/dst_out sized n_seeds*fanout; returns edges written.
int64_t graphcore_sample_in_edges(
    const int32_t* indptr_c, const int32_t* indices_c, int64_t n_nodes,
    const int32_t* seeds, int64_t n_seeds, int32_t fanout, uint64_t seed,
    int32_t* src_out, int32_t* dst_out) {
  std::mt19937_64 rng(seed);
  int64_t w = 0;
  std::vector<int32_t> reservoir(fanout);
  for (int64_t i = 0; i < n_seeds; ++i) {
    int32_t v = seeds[i];
    if (v < 0 || v >= n_nodes) continue;
    int64_t lo = indptr_c[v], hi = indptr_c[v + 1];
    int64_t deg = hi - lo;
    if (deg <= fanout) {
      for (int64_t p = lo; p < hi; ++p) {
        src_out[w] = indices_c[p];
        dst_out[w] = v;
        ++w;
      }
    } else {
      // Reservoir sampling without replacement.
      for (int32_t j = 0; j < fanout; ++j) reservoir[j] = indices_c[lo + j];
      for (int64_t p = fanout; p < deg; ++p) {
        uint64_t j = rng() % (p + 1);
        if (j < static_cast<uint64_t>(fanout))
          reservoir[j] = indices_c[lo + p];
      }
      for (int32_t j = 0; j < fanout; ++j) {
        src_out[w] = reservoir[j];
        dst_out[w] = v;
        ++w;
      }
    }
  }
  return w;
}

// Whole-minibatch layered neighbor sampling (data/sampling.py
// NeighborSampler.sample, at C speed): layered fanout expansion over the
// CSC, local renumbering (seeds first, then visited nodes ascending),
// optional self loops, and the dense single-bucket in-neighbor matrix
// (`in_cols`), in one call. The Python path pays ~35 ms/batch of numpy
// set algebra + gathers at the Reddit shape; this does the same work in
// a few ms and parallelizes the per-seed draws across `n_threads`
// (per-(hop,node) RNG streams keep the sampled edge SET thread-count
// invariant; only edge order varies with n_threads).
//
// Per-seed draws: all in-edges when deg <= fanout; otherwise Floyd's
// algorithm (O(fanout) draws) for fanout <= 64, reservoir sampling
// beyond that.
//
// Outputs (caller-allocated): node_ids[max_nodes] (tail zeros),
// lsrc/ldst[max_edges] (local-id edges), in_cols[max_nodes*w] (pad =
// max_nodes; pass w=0 to skip), n_out[2] = {n_local, n_edges}.
// Returns 0, or negative on error (-4: in-degree exceeded w).
int64_t graphcore_sample_subgraph(
    const int32_t* indptr_c, const int32_t* indices_c, int64_t n_nodes,
    const int32_t* seeds, int64_t n_seeds,
    const int32_t* fanouts, int64_t n_hops,
    uint64_t seed, int32_t add_self_loops,
    int64_t max_nodes, int64_t max_edges, int32_t w, int32_t n_threads,
    int32_t* node_ids, int32_t* lsrc, int32_t* ldst, int32_t* in_cols,
    int64_t* n_out) {
  if (n_nodes <= 0 || n_seeds < 0 || n_hops < 0 || max_nodes <= 0 ||
      max_edges < 0)
    return -1;
  std::vector<uint8_t> visited(n_nodes, 0);
  std::vector<int32_t> frontier;
  frontier.reserve(n_seeds);
  for (int64_t i = 0; i < n_seeds; ++i) {
    int32_t v = seeds[i];
    if (v < 0 || v >= n_nodes) return -2;
    if (!visited[v]) {
      visited[v] = 1;
      frontier.push_back(v);
    }
  }
  std::sort(frontier.begin(), frontier.end());

  std::vector<int32_t> gsrc, gdst;   // global-id sampled edges
  std::vector<int32_t> newcomers;    // visited non-seed nodes (any order)
  if (n_threads < 1) n_threads = 1;

  for (int64_t hop = 0; hop < n_hops; ++hop) {
    const int32_t f = fanouts[hop];
    if (f < 0) return -1;
    const int64_t nf = static_cast<int64_t>(frontier.size());
    const int64_t base = static_cast<int64_t>(gsrc.size());
    // Per-seed slot capacity f; compact after the parallel fill.
    gsrc.resize(base + nf * f);
    gdst.resize(base + nf * f);
    std::vector<int32_t> taken(nf, 0);
    const uint64_t hop_salt =
        seed ^ (0x9e3779b97f4a7c15ULL * static_cast<uint64_t>(hop + 1));

    auto draw_range = [&](int64_t lo_i, int64_t hi_i) {
      std::vector<int32_t> fset(std::max<int32_t>(f, 1));
      // Software-prefetching the CSC rows ahead was tried and measured
      // NO faster at the Reddit shape (12.5 ms with vs without) — the
      // hardware prefetcher already covers the sorted-frontier access
      // pattern. Keep the loop simple.
      for (int64_t i = lo_i; i < hi_i; ++i) {
        const int32_t v = frontier[i];
        const int64_t lo = indptr_c[v], hi = indptr_c[v + 1];
        const int64_t deg = hi - lo;
        int32_t* sp = gsrc.data() + base + i * f;
        int32_t t = 0;
        if (deg <= f) {
          for (int64_t p = lo; p < hi; ++p) sp[t++] = indices_c[p];
        } else {
          uint64_t st = hop_salt ^ (0xda942042e4dd58b5ULL *
                                    static_cast<uint64_t>(v + 1));
          if (f <= 64) {
            // Floyd: f draws regardless of degree; the candidate set is
            // tiny so a linear membership scan beats any hash here.
            for (int64_t j = deg - f; j < deg; ++j) {
              uint32_t r = bounded(st, static_cast<uint32_t>(j + 1));
              bool dup = false;
              for (int32_t q = 0; q < t; ++q)
                if (fset[q] == static_cast<int32_t>(r)) { dup = true; break; }
              fset[t] = dup ? static_cast<int32_t>(j)
                            : static_cast<int32_t>(r);
              ++t;
            }
            for (int32_t q = 0; q < t; ++q)
              sp[q] = indices_c[lo + fset[q]];
          } else {
            for (int32_t j = 0; j < f; ++j) sp[j] = indices_c[lo + j];
            for (int64_t p = f; p < deg; ++p) {
              uint32_t r = bounded(st, static_cast<uint32_t>(p + 1));
              if (r < static_cast<uint32_t>(f)) sp[r] = indices_c[lo + p];
            }
            t = f;
          }
        }
        for (int32_t q = 0; q < t; ++q)
          gdst[base + i * f + q] = v;
        taken[i] = t;
      }
    };

    if (n_threads == 1 || nf < 4096) {
      draw_range(0, nf);
    } else {
      std::vector<std::thread> pool;
      const int64_t chunk = (nf + n_threads - 1) / n_threads;
      for (int32_t th = 0; th < n_threads; ++th) {
        const int64_t lo_i = th * chunk;
        const int64_t hi_i = std::min(nf, lo_i + chunk);
        if (lo_i >= hi_i) break;
        pool.emplace_back(draw_range, lo_i, hi_i);
      }
      for (auto& th : pool) th.join();
    }

    // Compact the per-seed slots and collect this hop's new nodes.
    int64_t wpos = base;
    for (int64_t i = 0; i < nf; ++i) {
      const int64_t rpos = base + i * f;
      for (int32_t q = 0; q < taken[i]; ++q) {
        gsrc[wpos] = gsrc[rpos + q];
        gdst[wpos] = gdst[rpos + q];
        ++wpos;
      }
    }
    gsrc.resize(wpos);
    gdst.resize(wpos);
    frontier.clear();
    for (int64_t p = base; p < wpos; ++p) {
      const int32_t u = gsrc[p];
      if (!visited[u]) {
        visited[u] = 1;
        frontier.push_back(u);
        newcomers.push_back(u);
      }
    }
    std::sort(frontier.begin(), frontier.end());
  }

  // Local order: seeds (given order) first, then the rest ascending —
  // exactly the Python path's [seeds, flatnonzero(visited & ~seed)].
  std::sort(newcomers.begin(), newcomers.end());
  int64_t n_local = n_seeds + static_cast<int64_t>(newcomers.size());
  if (n_local > max_nodes) n_local = max_nodes;  // trim deepest extras

  std::vector<int32_t> lookup(n_nodes, -1);
  for (int64_t i = 0; i < n_local; ++i) {
    const int32_t gid =
        i < n_seeds ? seeds[i] : newcomers[i - n_seeds];
    node_ids[i] = gid;
    lookup[gid] = static_cast<int32_t>(i);
  }
  for (int64_t i = n_local; i < max_nodes; ++i) node_ids[i] = 0;

  int64_t ne = 0;
  const int64_t total = static_cast<int64_t>(gsrc.size());
  for (int64_t p = 0; p < total && ne < max_edges; ++p) {
    const int32_t lu = lookup[gsrc[p]];
    const int32_t lv = lookup[gdst[p]];
    if (lu < 0 || lv < 0) continue;  // endpoint trimmed away
    lsrc[ne] = lu;
    ldst[ne] = lv;
    ++ne;
  }
  if (add_self_loops) {
    for (int64_t i = 0; i < n_local && ne < max_edges; ++i) {
      lsrc[ne] = static_cast<int32_t>(i);
      ldst[ne] = static_cast<int32_t>(i);
      ++ne;
    }
  }

  if (w > 0 && in_cols != nullptr) {
    const int64_t cells = max_nodes * w;
    for (int64_t i = 0; i < cells; ++i)
      in_cols[i] = static_cast<int32_t>(max_nodes);
    std::vector<int32_t> cnt(n_local, 0);
    for (int64_t p = 0; p < ne; ++p) {
      const int32_t v = ldst[p];
      if (cnt[v] >= w) return -4;  // sampler in-degree invariant broken
      in_cols[static_cast<int64_t>(v) * w + cnt[v]] = lsrc[p];
      ++cnt[v];
    }
  }
  n_out[0] = n_local;
  n_out[1] = ne;
  return 0;
}

// Block-sparse tiling metadata: assign each canonical edge to its
// (row-block, col-block) tile; emit sorted unique tiles + per-edge tile
// coordinates. Two-phase like partition_csr. Returns tile count.
int64_t graphcore_tile_edges(
    const int32_t* src_c, const int32_t* dst_c, int64_t e, int64_t n_nodes,
    int32_t tile_r, int32_t tile_c,
    int32_t* tile_rows_out, int32_t* tile_cols_out,
    int32_t* edge_tile_out, int32_t* edge_r_out, int32_t* edge_c_out) {
  int64_t ncb = (n_nodes + tile_c - 1) / tile_c;
  std::vector<int64_t> keys(e);
  for (int64_t i = 0; i < e; ++i)
    keys[i] = static_cast<int64_t>(src_c[i] / tile_r) * ncb +
              (dst_c[i] / tile_c);
  std::vector<int64_t> uniq(keys);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  int64_t t = static_cast<int64_t>(uniq.size());
  if (tile_rows_out == nullptr) return t;
  for (int64_t k = 0; k < t; ++k) {
    tile_rows_out[k] = static_cast<int32_t>(uniq[k] / ncb);
    tile_cols_out[k] = static_cast<int32_t>(uniq[k] % ncb);
  }
  for (int64_t i = 0; i < e; ++i) {
    int64_t k = std::lower_bound(uniq.begin(), uniq.end(), keys[i]) -
                uniq.begin();
    edge_tile_out[i] = static_cast<int32_t>(k);
    edge_r_out[i] = src_c[i] % tile_r;
    edge_c_out[i] = dst_c[i] % tile_c;
  }
  return t;
}

// Weakly-connected components: union-find with union-by-size and path
// halving — O(e·α). Python/numpy has no vectorized equivalent (the
// tile-aligned reorder, graph/reorder.py, needs this at ogbn scales).
// Writes the component root id per node into labels_out; returns the
// number of distinct components.
int64_t graphcore_connected_components(
    const int32_t* src, const int32_t* dst, int64_t e, int64_t n_nodes,
    int32_t* labels_out) {
  std::vector<int32_t> parent(n_nodes);
  std::vector<int32_t> size(n_nodes, 1);
  std::iota(parent.begin(), parent.end(), 0);
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  for (int64_t i = 0; i < e; ++i) {
    int32_t a = src[i], b = dst[i];
    if (a < 0 || a >= n_nodes || b < 0 || b >= n_nodes) continue;
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) continue;
    if (size[ra] < size[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    size[ra] += size[rb];
  }
  int64_t n_comp = 0;
  for (int64_t v = 0; v < n_nodes; ++v) {
    int32_t r = find(static_cast<int32_t>(v));
    labels_out[v] = r;
    if (r == v) ++n_comp;
  }
  return n_comp;
}

// Degree-bucketed ELL packing for one traversal direction
// (graph/ell.py `ell_pack` contract, at C speed for the 1B+ edge
// regime where the vectorized-numpy cold path stops being "cold").
//
// Inputs: the direction's CSR (indptr[n+1], cols_all[e'], eids_all[e']
// where e' = indptr[n]); `widths` ascending, already extended to cover
// the max degree; row_pad for per-bucket row rounding.
//
// Two-phase protocol (like graphcore_partition_csr): with the flat
// output pointers null, only fills bucket_rows[w] = padded row count
// per width (0 for empty buckets) and returns 0. With outputs non-null
// (caller sizes them from bucket_rows: rows_flat = sum r_pad,
// cols/eid_flat = sum r_pad*width), fills:
//   rows_flat / cols_flat / eid_flat — per-bucket arrays concatenated
//     in width order (pads: rows=n, cols=n, eid=e_pad);
//   row_pos[n]     — packed-row index per node (total_rows if empty);
//   edge_pos[e_pad] — flat slot per canonical eid (total_slots if pad).
int64_t graphcore_ell_pack(
    const int32_t* indptr, int64_t n, const int32_t* cols_all,
    const int64_t* eids_all, int64_t e_pad, const int64_t* widths,
    int64_t n_widths, int64_t row_pad, int64_t* bucket_rows,
    int32_t* rows_flat, int32_t* cols_flat, int32_t* eid_flat,
    int32_t* row_pos, int64_t* edge_pos) {
  if (n < 0 || n_widths <= 0 || row_pad <= 0) return -1;
  // int32 guard: eid_flat and the e_pad pad sentinel are int32; at
  // e_pad >= 2^31 the casts below would overflow SILENTLY (writing
  // truncated indices before any Python-side size check could run).
  // Refuse here so ell_pack_native falls back to the numpy path.
  const int64_t kI32Max = 2147483647LL;
  if (e_pad >= kI32Max || n >= kI32Max) return -3;
  // Bucket index per node by degree (degree-0 nodes -> no bucket).
  std::vector<int32_t> bucket_of(n, -1);
  std::vector<int64_t> counts(n_widths, 0);
  for (int64_t v = 0; v < n; ++v) {
    int64_t deg = indptr[v + 1] - indptr[v];
    if (deg <= 0) continue;
    int64_t b = 0;
    while (b < n_widths && widths[b] < deg) ++b;
    if (b >= n_widths) return -2;  // widths don't cover max degree
    bucket_of[v] = static_cast<int32_t>(b);
    ++counts[b];
  }
  int64_t slots_total = 0;
  for (int64_t b = 0; b < n_widths; ++b) {
    bucket_rows[b] =
        counts[b] ? ((counts[b] + row_pad - 1) / row_pad) * row_pad : 0;
    slots_total += bucket_rows[b] * widths[b];
  }
  // row_pos/edge_pos hold flat row/slot positions as int32 (edge_pos is
  // int64 but graph/ell.py downcasts it); refuse before writing.
  if (slots_total >= kI32Max) return -3;
  if (rows_flat == nullptr) return 0;  // count phase done

  // Flat offsets per bucket.
  std::vector<int64_t> row_base(n_widths + 1, 0), slot_base(n_widths + 1, 0);
  for (int64_t b = 0; b < n_widths; ++b) {
    row_base[b + 1] = row_base[b] + bucket_rows[b];
    slot_base[b + 1] = slot_base[b] + bucket_rows[b] * widths[b];
  }
  const int64_t total_rows = row_base[n_widths];
  const int64_t total_slots = slot_base[n_widths];
  // Pad fills.
  for (int64_t i = 0; i < total_rows; ++i)
    rows_flat[i] = static_cast<int32_t>(n);
  for (int64_t i = 0; i < total_slots; ++i) {
    cols_flat[i] = static_cast<int32_t>(n);
    eid_flat[i] = static_cast<int32_t>(e_pad);
  }
  for (int64_t i = 0; i < e_pad; ++i) edge_pos[i] = total_slots;

  std::vector<int64_t> cursor(n_widths, 0);  // next row within bucket
  for (int64_t v = 0; v < n; ++v) {
    int32_t b = bucket_of[v];
    if (b < 0) {
      row_pos[v] = static_cast<int32_t>(total_rows);
      continue;
    }
    const int64_t r = cursor[b]++;
    const int64_t w = widths[b];
    row_pos[v] = static_cast<int32_t>(row_base[b] + r);
    rows_flat[row_base[b] + r] = static_cast<int32_t>(v);
    const int64_t slot0 = slot_base[b] + r * w;
    const int64_t lo = indptr[v], hi = indptr[v + 1];
    for (int64_t j = lo; j < hi; ++j) {
      const int64_t k = j - lo;
      cols_flat[slot0 + k] = cols_all[j];
      const int64_t eid = eids_all[j];
      eid_flat[slot0 + k] = static_cast<int32_t>(eid);
      if (eid >= 0 && eid < e_pad) edge_pos[eid] = slot0 + k;
    }
  }
  return total_rows;
}

// Halo plan (parallel/halo.py `halo_graph` contract, at C speed):
// stable counting-sort of edges by dst, owner-of-dst placement into
// (P, E_p) shard-local arrays, and the per-(src_owner r, dst_owner s)
// sorted-unique halo send lists — bitwise-identical to the vectorized
// numpy builder (which pays radix argsort + np.unique over e-scale
// int64 keys; this is O(e + n + p²) counting passes).
//
// Two-phase: with the array outputs null, fills sizes[0] = e_p (padded
// edges per shard) and sizes[1] = m_max (padded halo rows per owner
// pair) and returns 0. Second call fills
//   send_idx[p*p*m_max] — local src id each r sends to s (pad n_per)
//   src_ext [p*e_p]     — extended local src per edge (pad n_per)
//   dst_loc [p*e_p]     — local dst per edge (pad n_per)
//   eid     [p*e_p]     — canonical edge position (pad e_pad_sentinel)
// Returns 0, -1 bad input, -2 endpoint out of range, -3 int32 overflow
// (callers fall back to numpy).
int64_t graphcore_halo_plan(
    const int32_t* src, const int32_t* dst, int64_t e, int64_t n,
    int64_t p, int64_t n_per, int64_t pad_multiple,
    int64_t e_pad_sentinel,
    int64_t* sizes, int32_t* send_idx, int32_t* src_ext,
    int32_t* dst_loc, int32_t* eid) {
  if (e < 0 || n <= 0 || p <= 0 || n_per <= 0 || pad_multiple <= 0)
    return -1;
  const int64_t kI32Max = 2147483647LL;
  if (e >= kI32Max || n >= kI32Max || e_pad_sentinel > kI32Max) return -3;

  // Stable counting sort by dst.
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] < 0 || src[i] >= n || dst[i] < 0 || dst[i] >= n) return -2;
    ++cnt[dst[i] + 1];
  }
  std::partial_sum(cnt.begin(), cnt.end(), cnt.begin());
  std::vector<int32_t> order(e);
  {
    std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < e; ++i)
      order[cursor[dst[i]]++] = static_cast<int32_t>(i);
  }

  // Per-shard edge counts (shard s owns dst in [s·n_per, (s+1)·n_per)).
  auto clampn = [&](int64_t v) { return v < n ? v : n; };
  int64_t max_cnt = 0;
  std::vector<int64_t> shard_begin(p + 1);
  for (int64_t s = 0; s <= p; ++s)
    shard_begin[s] = cnt[clampn(s * n_per)];
  for (int64_t s = 0; s < p; ++s) {
    int64_t c = shard_begin[s + 1] - shard_begin[s];
    if (c > max_cnt) max_cnt = c;
  }
  auto round_up = [&](int64_t x) {
    return ((x + pad_multiple - 1) / pad_multiple) * pad_multiple;
  };
  const int64_t e_p = round_up(e ? max_cnt : 1);

  // Remote edges, counting-sorted by (pair = r·p + s, v_local): LSD —
  // stable by v_local first, then by pair.
  int64_t n_rem = 0;
  std::vector<int32_t> rem_pair, rem_v, rem_i;
  {
    // First pass over sorted order to count remotes.
    for (int64_t i = 0; i < e; ++i) {
      const int64_t ed = order[i];
      if (src[ed] / n_per != dst[ed] / n_per) ++n_rem;
    }
    rem_pair.resize(n_rem);
    rem_v.resize(n_rem);
    rem_i.resize(n_rem);
    std::vector<int32_t> tp(n_rem), tv(n_rem), ti(n_rem);
    int64_t w = 0;
    for (int64_t i = 0; i < e; ++i) {
      const int64_t ed = order[i];
      const int64_t r = src[ed] / n_per, s = dst[ed] / n_per;
      if (r == s) continue;
      tp[w] = static_cast<int32_t>(r * p + s);
      tv[w] = static_cast<int32_t>(src[ed] - r * n_per);
      ti[w] = static_cast<int32_t>(i);  // position in dst-sorted order
      ++w;
    }
    // Sort by v_local (stable counting).
    std::vector<int64_t> vc(n_per + 1, 0);
    for (int64_t j = 0; j < n_rem; ++j) ++vc[tv[j] + 1];
    std::partial_sum(vc.begin(), vc.end(), vc.begin());
    std::vector<int32_t> t2p(n_rem), t2v(n_rem), t2i(n_rem);
    for (int64_t j = 0; j < n_rem; ++j) {
      const int64_t q = vc[tv[j]]++;
      t2p[q] = tp[j];
      t2v[q] = tv[j];
      t2i[q] = ti[j];
    }
    // Then by pair (stable counting) — final order (pair, v_local).
    std::vector<int64_t> pc(p * p + 1, 0);
    for (int64_t j = 0; j < n_rem; ++j) ++pc[t2p[j] + 1];
    std::partial_sum(pc.begin(), pc.end(), pc.begin());
    for (int64_t j = 0; j < n_rem; ++j) {
      const int64_t q = pc[t2p[j]]++;
      rem_pair[q] = t2p[j];
      rem_v[q] = t2v[j];
      rem_i[q] = t2i[j];
    }
  }

  // Unique (pair, v) counts → m_max.
  int64_t m_max_raw = 0;
  {
    int64_t j = 0;
    while (j < n_rem) {
      const int32_t pr = rem_pair[j];
      int64_t m = 0;
      int32_t prev_v = -1;
      for (; j < n_rem && rem_pair[j] == pr; ++j)
        if (rem_v[j] != prev_v) {
          ++m;
          prev_v = rem_v[j];
        }
      if (m > m_max_raw) m_max_raw = m;
    }
  }
  const int64_t m_max = round_up(n_rem ? m_max_raw : 1);
  if (sizes != nullptr) {
    sizes[0] = e_p;
    sizes[1] = m_max;
  }
  if (send_idx == nullptr) return 0;  // count phase done
  if (p * e_p >= kI32Max || p * p * m_max >= kI32Max ||
      n_per + 1 + p * m_max >= kI32Max)
    return -3;

  // send_idx + extended ids for remote edges.
  for (int64_t i = 0; i < p * p * m_max; ++i)
    send_idx[i] = static_cast<int32_t>(n_per);
  std::vector<int32_t> ext(e);
  for (int64_t i = 0; i < e; ++i) {
    const int64_t ed = order[i];
    ext[i] = static_cast<int32_t>(src[ed] - (dst[ed] / n_per) * n_per);
  }
  {
    int64_t j = 0;
    while (j < n_rem) {
      const int32_t pr = rem_pair[j];
      const int64_t r = pr / p;
      const int64_t base_ext = n_per + 1 + r * m_max;
      int64_t rank = -1;
      int32_t prev_v = -1;
      for (; j < n_rem && rem_pair[j] == pr; ++j) {
        if (rem_v[j] != prev_v) {
          ++rank;
          prev_v = rem_v[j];
          send_idx[static_cast<int64_t>(pr) * m_max + rank] = rem_v[j];
        }
        ext[rem_i[j]] = static_cast<int32_t>(base_ext + rank);
      }
    }
  }

  // Shard-local fills (pads first, then the owned prefix per shard).
  for (int64_t i = 0; i < p * e_p; ++i) {
    src_ext[i] = static_cast<int32_t>(n_per);
    dst_loc[i] = static_cast<int32_t>(n_per);
    eid[i] = static_cast<int32_t>(e_pad_sentinel);
  }
  for (int64_t s = 0; s < p; ++s) {
    const int64_t lo = shard_begin[s], hi = shard_begin[s + 1];
    int32_t* se = src_ext + s * e_p;
    int32_t* dl = dst_loc + s * e_p;
    int32_t* ei = eid + s * e_p;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t j = i - lo;
      const int64_t ed = order[i];
      se[j] = ext[i];
      dl[j] = static_cast<int32_t>(dst[ed] - s * n_per);
      ei[j] = static_cast<int32_t>(ed);
    }
  }
  return 0;
}

// Shared-shape degree-bucket packer over P shards (parallel/halo.py
// `_pack_shared` contract, at C speed) — used for BOTH halo-ELL
// packings. Edges come as the (P, e_p) shard-local plan matrices
// halo_graph already produced: edge (s, j) has row row_mat[s][j], col
// col_mat[s][j], slot-order position j, and is real iff
// valid_mat[s][j] < valid_lt (pass dst_loc both times — its pad is
// n_per). Iterating (s asc, j asc) IS the pos-ascending-within-shard
// order, so every rank assignment is a single counting pass — the
// numpy path pays six radix argsorts + searchsorted over e-scale
// arrays (plus the flat-list construction) for the same result.
//
// spec_mode 0: a row is special iff ANY of its cols > spec_thresh
//   (dst packing: boundary rows read halo columns);
// spec_mode 1: a row is special iff its row id >= spec_thresh
//   (transpose packing: halo rows).
// special_side 0 = special rows pinned to a statically-sized bucket
// TAIL, 1 = HEAD (the overlap sections).
//
// Two-phase: first call (flat outputs null) extends `widths` in place
// by doubling until the max degree is covered (nw_io in/out, capacity
// nw_cap), fills r_pad_b[n_widths] (padded row count per bucket, 0 if
// empty) and n_spec_b[n_widths] (static special-section rows), and
// returns total_rows. Second call fills
//   rows_flat — buckets concatenated, each (P, r_pad) row-major
//   cols_flat/epos_flat — each bucket (P, r_pad, w) row-major
//   row_pos[p*n_rows]  — packed-row position per row key (pad total)
//   section_pos[p*n_rows] (nullable) — position in the concatenation
//     of the special sections only, -1 for non-special rows
//   slot_pos[p*e_p] (nullable) — per-shard flat bucket position of
//     each slot-order edge (pad = total flat slots)
// and returns total_rows. Returns -1 bad input, -3 overflow/size guard
// (callers fall back to numpy).
int64_t graphcore_halo_pack(
    const int32_t* row_mat, const int32_t* col_mat,
    const int32_t* valid_mat, int64_t valid_lt,
    int64_t p, int64_t e_p, int64_t n_rows,
    int64_t* widths, int64_t* nw_io, int64_t nw_cap,
    int32_t spec_mode, int64_t spec_thresh, int32_t special_side,
    int64_t pad_row, int64_t pad_col, int64_t row_pad,
    int64_t* r_pad_b, int64_t* n_spec_b,
    int32_t* rows_flat, int32_t* cols_flat, int32_t* epos_flat,
    int32_t* row_pos, int32_t* section_pos, int32_t* slot_pos) {
  // bktv below is int8 — bucket indices must stay < 127.
  if (e_p <= 0 || p <= 0 || n_rows <= 0 || *nw_io <= 0 || row_pad <= 0 ||
      nw_cap <= 0 || nw_cap > 120)
    return -1;
  const int64_t kI32Max = 2147483647LL;
  const int64_t nk = p * n_rows;
  // ~10 B/key of working state; refuse absurd key spaces (fallback).
  if (nk >= kI32Max || nk > (int64_t)200e6 || e_p >= kI32Max) return -3;

  std::vector<int32_t> deg(nk, 0);
  std::vector<uint8_t> spec;
  if (spec_mode == 0) spec.assign(nk, 0);
  int64_t max_deg = 0;
  for (int64_t s = 0; s < p; ++s) {
    const int32_t* rm = row_mat + s * e_p;
    const int32_t* cm = col_mat + s * e_p;
    const int32_t* vm = valid_mat + s * e_p;
    const int64_t kbase = s * n_rows;
    for (int64_t j = 0; j < e_p; ++j) {
      if (vm[j] >= valid_lt || vm[j] < 0) continue;  // pad slot
      const int64_t r = rm[j];
      if (r < 0 || r >= n_rows) return -2;
      const int64_t k = kbase + r;
      if (++deg[k] > max_deg) max_deg = deg[k];
      if (spec_mode == 0 && cm[j] > spec_thresh) spec[k] = 1;
    }
  }
  int64_t nw = *nw_io;
  while (widths[nw - 1] < max_deg) {
    if (nw >= nw_cap) return -3;
    widths[nw] = widths[nw - 1] * 2;
    ++nw;
  }
  *nw_io = nw;

  auto bucket_of = [&](int64_t d) {
    int64_t b = 0;
    while (widths[b] < d) ++b;  // searchsorted(widths, d, 'left')
    return b;
  };
  auto is_spec = [&](int64_t k, int64_t r) {
    return spec_mode == 0 ? spec[k] != 0 : r >= spec_thresh;
  };

  // Per-(bucket, shard) row counts.
  std::vector<int64_t> cnt_bs(nw * p, 0), spec_bs(nw * p, 0);
  for (int64_t s = 0; s < p; ++s)
    for (int64_t r = 0; r < n_rows; ++r) {
      const int64_t k = s * n_rows + r;
      if (!deg[k]) continue;
      const int64_t b = bucket_of(deg[k]);
      ++cnt_bs[b * p + s];
      if (is_spec(k, r)) ++spec_bs[b * p + s];
    }
  int64_t total_rows = 0;
  for (int64_t b = 0; b < nw; ++b) {
    int64_t mx_non = 0, mx_sp = 0, any = 0;
    for (int64_t s = 0; s < p; ++s) {
      const int64_t c = cnt_bs[b * p + s], sp = spec_bs[b * p + s];
      any += c;
      if (c - sp > mx_non) mx_non = c - sp;
      if (sp > mx_sp) mx_sp = sp;
    }
    n_spec_b[b] = mx_sp;
    r_pad_b[b] =
        any ? ((mx_non + mx_sp + row_pad - 1) / row_pad) * row_pad : 0;
    total_rows += r_pad_b[b];
  }
  if (rows_flat == nullptr) return total_rows;  // count phase done

  std::vector<int64_t> bucket_base(nw + 1, 0), spec_base(nw + 1, 0);
  std::vector<int64_t> rows_off(nw + 1, 0), cols_off(nw + 1, 0);
  std::vector<int64_t> sflat_base(nw + 1, 0);
  for (int64_t b = 0; b < nw; ++b) {
    bucket_base[b + 1] = bucket_base[b] + r_pad_b[b];
    spec_base[b + 1] = spec_base[b] + n_spec_b[b];
    rows_off[b + 1] = rows_off[b] + p * r_pad_b[b];
    cols_off[b + 1] = cols_off[b] + p * r_pad_b[b] * widths[b];
    sflat_base[b + 1] = sflat_base[b] + r_pad_b[b] * widths[b];
  }
  const int64_t total_flat = sflat_base[nw];
  if (total_rows >= kI32Max || total_flat >= kI32Max ||
      cols_off[nw] >= kI32Max)
    return -3;

  for (int64_t i = 0; i < rows_off[nw]; ++i)
    rows_flat[i] = static_cast<int32_t>(pad_row);
  for (int64_t i = 0; i < cols_off[nw]; ++i) {
    cols_flat[i] = static_cast<int32_t>(pad_col);
    epos_flat[i] = static_cast<int32_t>(e_p);
  }
  for (int64_t i = 0; i < nk; ++i)
    row_pos[i] = static_cast<int32_t>(total_rows);
  if (section_pos != nullptr)
    for (int64_t i = 0; i < nk; ++i) section_pos[i] = -1;
  if (slot_pos != nullptr)
    for (int64_t i = 0; i < p * e_p; ++i)
      slot_pos[i] = static_cast<int32_t>(total_flat);

  // Row slot assignment in ascending key order (s-major, r-minor) —
  // exactly numpy's rank-within-(bucket, shard) over sorted row keys.
  std::vector<int32_t> slotv(nk);
  std::vector<int8_t> bktv(nk);
  std::vector<int64_t> rk_sp(nw * p, 0), rk_non(nw * p, 0);
  for (int64_t s = 0; s < p; ++s)
    for (int64_t r = 0; r < n_rows; ++r) {
      const int64_t k = s * n_rows + r;
      const int64_t d = deg[k];
      if (!d) continue;
      const int64_t b = bucket_of(d);
      const bool sp = is_spec(k, r);
      int64_t slot;
      if (special_side == 0) {  // tail
        slot = sp ? r_pad_b[b] - spec_bs[b * p + s] + rk_sp[b * p + s]++
                  : rk_non[b * p + s]++;
      } else {  // head
        slot = sp ? rk_sp[b * p + s]++
                  : n_spec_b[b] + rk_non[b * p + s]++;
      }
      slotv[k] = static_cast<int32_t>(slot);
      bktv[k] = static_cast<int8_t>(b);
      row_pos[k] = static_cast<int32_t>(bucket_base[b] + slot);
      rows_flat[rows_off[b] + s * r_pad_b[b] + slot] =
          static_cast<int32_t>(r);
      if (sp && section_pos != nullptr)
        section_pos[k] = static_cast<int32_t>(
            spec_base[b] + slot -
            (special_side == 0 ? r_pad_b[b] - n_spec_b[b] : 0));
      deg[k] = 0;  // becomes the edge-slot cursor below
    }

  // Edge fill: (s asc, j asc) IS pos-ascending within every (s, r)
  // group, so a per-key cursor reproduces the rank-by-pos slot index.
  for (int64_t s = 0; s < p; ++s) {
    const int32_t* rm = row_mat + s * e_p;
    const int32_t* cm = col_mat + s * e_p;
    const int32_t* vm = valid_mat + s * e_p;
    for (int64_t j = 0; j < e_p; ++j) {
      if (vm[j] >= valid_lt || vm[j] < 0) continue;
      const int64_t k = s * n_rows + rm[j];
      const int64_t b = bktv[k];
      const int64_t w = widths[b];
      const int64_t slot = slotv[k];
      const int64_t kk = deg[k]++;
      const int64_t off =
          cols_off[b] + (s * r_pad_b[b] + slot) * w + kk;
      cols_flat[off] = cm[j];
      epos_flat[off] = static_cast<int32_t>(j);
      if (slot_pos != nullptr)
        slot_pos[s * e_p + j] =
            static_cast<int32_t>(sflat_base[b] + slot * w + kk);
    }
  }
  return total_rows;
}

}  // extern "C"
