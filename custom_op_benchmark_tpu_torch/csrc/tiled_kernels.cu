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
// and, from scripts/exp_grid_bisect.py, the diagnostic
//   S4 spmm_dotonly     <- spmm_dotonly
//     K2 with every vals tile replaced by the constant 0.01: the same tile
//     products with no vals bytes read (a compile-time switch of K2).
//
// What bounds them on this card: each is a batch of 128x128xd tile
// products in f32. At the GraphTransformer slice's shapes (T = 344 tiles,
// 8 heads, d = 64) each kernel does 2*T*H*128*128*d = 5.8 GFLOP of whole
// tile products and moves about 180 MB of tile-dense scores (written by
// K1, read by K2/K3), about 25 FLOP per byte. All three run their products
// on the tensor cores in 3xTF32 (mma_async.cuh), as accurate as f32 FMAs:
// three TF32 passes at 495 TFLOP/s give 165 TFLOP/s of f32-accurate
// products (67 on the CUDA cores), a ratio of 49 FLOP per byte of HBM
// (3.35 TB/s), so the score stream bounds them. K2/K3 at d = 1024 (one
// head) do 11.5 GFLOP on 22.5 MB of scores and are bound by their
// products.
//
// K1 (sddmm_tiles_kernel): one block of 8 warps owns one (tile, head)
// score tile; warp w owns its rows 16w .. 16w + 15 and all 128 columns,
// 16 m16n8 fragments of accumulators, as K4's QK^T does. A and B rows are
// both K-major, so A's fragment (g, t) and B's (k = t, n = g) are read
// from row-major stages of 32 features (stride 36 floats, 4 mod 32: no
// bank conflicts); the contraction runs over d in such chunks, so any d
// works (features past d are zero-filled by the copy). Each B value is
// read by all 8 warps, so a landed B chunk is split into TF32 parts once,
// in shared memory; A's fragments are split in registers, each used for
// 16 fragments. The mask tile rides with the first chunk; from it each
// warp marks the fragments of its rows that hold no edge, and skips their
// products (a warp-uniform branch). The function selects (jnp.where in
// the TPU kernel), so a skipped fragment, stored as zeros, is what the
// select would give: no value changes. The tensor cores' f32 sums do not
// round to nearest: with all 384 mma additions of d = 1024 run into one
// accumulator, K1 missed the 1e-4 gate (an error of 1.1e-5 of a sum of
// 1024 squares, measured on the H100). So each 8-deep step's three
// products go into a zeroed fragment, which an f32 add (rounded to
// nearest) folds into the accumulator. With the skip (the slice's and the
// grid's tiles have 12-14 % of their fragments live) the products fall
// 7-8x, and the output stream alone bounds K1. Stores are float2 rows of
// the accumulator layout (each 32-byte sector written whole). 72 KB of
// shared memory and at most 128 registers a thread let two blocks share
// an SM, so one block's stores and copies overlap the other's products.
// Measured on the H100 against this design, and slower on the grid by
// 3-35 %: 64-feature chunks or a two-stage ring with B split in registers,
// a ring with one block an SM, half-tile blocks of 4 warps, and one
// persistent block per slot that loads the next tile while storing.
//
// K2 (spmm_row_sweep_kernel) and S4 follow K3's design: one block owns a
// row block, a head and up to 128 features (each vals tile read once for
// any d <= 128), and a three-stage cp.async ring carries chunks of (64
// columns of a vals tile, the matching 64 rows of x) across tile
// boundaries. vals is the A operand as it lies (m = row, k = column):
// stride 68 floats (4 mod 32) makes the a0 (g, t) reads conflict-free, and
// x's stride DN + 8 (8 mod 32) the b0 (k = t, n = g) reads. Warp w owns
// rows 32 * (w / 2) .. + 32 and features (w % 2) * DN / 2 .. + DN / 2. A
// fragments are split in registers (each used for DN / 16 fragments), and
// B's in registers as K3 does (each used for two): splitting x once per
// chunk in shared memory (two stages then fit) was 3 % slower at the
// slice and 1 % faster on the grid, measured on the H100. S4 replaces the
// A fragments by the constant 0.01 and reads no vals.
//
// K3 (spmm_col_sweep_kernel): the transposed sweep on the same ring, one
// block per column block, head and up to 128 features.
//
// All of them: no atomics, outputs repeat bit for bit. K2/K3 loop over
// each block's exact tile range (no padding to the longest row, as the TPU
// grid needed), and an empty row or column block writes zeros.
//
// bf16 (the *_bf16 entry points; mma_async.cuh): node and tile arrays of
// bf16 move as bf16, accumulate in f32 and are stored as bf16, rounded
// once. Every product is bf16 x bf16, exact in TF32, so it takes one TF32
// pass instead of three. K1 stages its A and B chunks as bf16 in the room
// of B's lo parts and widens them once into the f32 stages; K2 and K3
// keep their bf16 stages and widen each fragment value in registers where
// the f32 kernels split it. K1 still sums each 8-deep step apart.
//
// Layouts: node arrays are (n, H, d) contiguous, read in place per head
// (row stride H*d, head offset h*d); rows at or past n read as zero, so
// callers never pad. Tile arrays are (H, T, 128, 128) contiguous and
// 16-byte aligned; the mask is (T, 128, 128) bytes shared by every head,
// 16-byte aligned. Indices are int32. Node arrays move as 16-byte copies
// when a row is a whole number of 16-byte pieces (d % 4 == 0 for f32,
// d % 8 == 0 for bf16) and they are 16-byte aligned, else element by
// element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_async.cuh"

namespace {

constexpr int TILE = 128;     // tile_r == tile_c
constexpr int THREADS = 256;  // 8 warps
constexpr unsigned FULL = 0xffffffffu;

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// K1: SDDMM over tiles
// ---------------------------------------------------------------------------

constexpr int SD_KC = 32;          // features of A and B staged per chunk
constexpr int SD_LD = SD_KC + 4;   // stage row stride, floats
constexpr size_t SD_SMEM =
    sizeof(float) * 3 * TILE * SD_LD + (size_t)TILE * MASK_LD;

// Bit j set where rows ms .. ms + 15 of a staged mask hold an edge in
// columns 8j .. 8j + 7: one m16n8 fragment of the warp's scores. Lanes 2j
// and 2j + 1 read the fragment's upper and lower 8 rows.
__device__ __forceinline__ unsigned live_fragments(const uint8_t* ms,
                                                   int lane) {
  const uint8_t* m = ms + (lane % 2) * 8 * MASK_LD + (lane / 2) * 8;
  uint32_t any = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint2 v = *reinterpret_cast<const uint2*>(m + r * MASK_LD);
    any |= v.x | v.y;
  }
  const unsigned b = __ballot_sync(FULL, any != 0);
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
    if ((b >> (2 * j)) & 3u) live |= 1u << j;
  return live;
}

template <typename E>
__global__ void __launch_bounds__(THREADS, 2)
sddmm_tiles_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                   const uint8_t* __restrict__ mask,
                   const E* __restrict__ A, const E* __restrict__ B,
                   E* __restrict__ out, int T, int d, int nA, int nB,
                   int vec) {
  constexpr int NT = TILE / 8;  // fragments (8 columns each) of a warp
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                 // [TILE][SD_LD]
  float* Bhi = As + TILE * SD_LD;   // B's TF32 hi parts
  float* Blo = Bhi + TILE * SD_LD;  // and lo parts
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Blo + TILE * SD_LD);
  // bf16: A's and B's chunks land here ([TILE][SD_KC] each) and are
  // widened into As and Bhi; B has no lo part.
  bf16* Ast = reinterpret_cast<bf16*>(Blo);
  bf16* Bst = Ast + TILE * SD_KC;

  const int t = blockIdx.x, h = blockIdx.y;
  const long long ld = (long long)gridDim.y * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long r0 = (long long)rows[t] * TILE;
  const long long c0 = (long long)cols[t] * TILE;
  const E* Ah = A + (long long)h * d;
  const E* Bh = B + (long long)h * d;
  const int n_chunks = d > SD_KC ? (d + SD_KC - 1) / SD_KC : 1;
  const int kd = (d + 7) / 8;  // contraction steps; the rest is zero

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.f;

  load_mask<THREADS>(Ms, mask + (long long)t * TILE * TILE, tid);
  unsigned live = 0;  // bit j: the warp's fragment j holds an edge
  const float* aw = As + (warp * 16 + g) * SD_LD + t4;
  const int bw = g * SD_LD + t4;
  for (int c = 0; c < n_chunks; ++c) {
    if constexpr (is_f32<E>) {
      load_rows<TILE, SD_KC, SD_LD, THREADS>(As, Ah, r0, nA, c * SD_KC, d,
                                             ld, vec, tid);
      load_rows<TILE, SD_KC, SD_LD, THREADS>(Bhi, Bh, c0, nB, c * SD_KC, d,
                                             ld, vec, tid);
    } else {
      load_rows<TILE, SD_KC, SD_KC, THREADS>(Ast, Ah, r0, nA, c * SD_KC, d,
                                             ld, vec, tid);
      load_rows<TILE, SD_KC, SD_KC, THREADS>(Bst, Bh, c0, nB, c * SD_KC, d,
                                             ld, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (c == 0) live = live_fragments(Ms + warp * 16 * MASK_LD, lane);
    if constexpr (is_f32<E>) {
      split_rows<TILE, SD_KC, SD_LD, THREADS>(Bhi, Blo, tid);
    } else {
      widen_rows<TILE, SD_KC, SD_KC, SD_LD, THREADS>(As, Ast, tid);
      widen_rows<TILE, SD_KC, SD_KC, SD_LD, THREADS>(Bhi, Bst, tid);
    }
    __syncthreads();
    if (live) {
      const int kend = min(SD_KC / 8, kd - c * (SD_KC / 8));
#pragma unroll
      for (int kk = 0; kk < SD_KC / 8; ++kk) {
        if (kk >= kend) break;
        const float* a = aw + kk * 8;
        uint32_t ah[4], al[4];
        if constexpr (is_f32<E>) {
          split_a(a[0], a[8 * SD_LD], a[4], a[8 * SD_LD + 4], ah, al);
        } else {
          ah[0] = exact_tf32(a[0]);
          ah[1] = exact_tf32(a[8 * SD_LD]);
          ah[2] = exact_tf32(a[4]);
          ah[3] = exact_tf32(a[8 * SD_LD + 4]);
        }
        const int kb = bw + kk * 8;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if ((live >> j) & 1u) {
            float s[4] = {0.f, 0.f, 0.f, 0.f};
            const int o = kb + j * 8 * SD_LD;
            if constexpr (is_f32<E>)
              mma_split(s, ah, al, Bhi, Blo, o, o + 4);
            else
              mma_tf32(s, ah, exact_tf32(Bhi[o]), exact_tf32(Bhi[o + 4]));
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[j][u] += s[u];
          }
      }
    }
    __syncthreads();  // every warp is done with the stage
  }

  // Rows g and g + 8 of the warp's 16, columns 8j + 2t4, + 1: the mask
  // selects, two bytes per row; one pair of values per row and fragment.
  const uint8_t* mw = Ms + (warp * 16 + g) * MASK_LD + 2 * t4;
  E* o = out + (((long long)h * T + t) * TILE + warp * 16 + g) * TILE +
         2 * t4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint16_t m0 = *reinterpret_cast<const uint16_t*>(mw + 8 * j);
    const uint16_t m1 =
        *reinterpret_cast<const uint16_t*>(mw + 8 * MASK_LD + 8 * j);
    store2(o + 8 * j, (m0 & 0xff) ? acc[j][0] : 0.f,
           (m0 >> 8) ? acc[j][1] : 0.f);
    store2(o + 8 * TILE + 8 * j, (m1 & 0xff) ? acc[j][2] : 0.f,
           (m1 >> 8) ? acc[j][3] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// K2 and S4: SpMM row sweep
// ---------------------------------------------------------------------------

constexpr int RS_COLS = 64;  // tile columns (rows of x) per stage
constexpr int RS_STAGES = 3;

// Stage strides in elements: vals 4 mod 32 words for f32 (68), 72 for
// bf16 (a 16-byte multiple; the a0 reads still hit distinct words).
template <typename E, int DN>
struct RowCfg {
  static constexpr int VLD = is_f32<E> ? RS_COLS + 4 : RS_COLS + 8;
  static constexpr int XLD = DN + 8;
  static constexpr int STAGE = TILE * VLD + RS_COLS * XLD;  // elements
  static constexpr size_t SMEM = sizeof(E) * RS_STAGES * STAGE;
};

// A's fragment read from a stage of E: a0 at a, a1 (m + 8) at a[om], a2
// (k + 4) at a[ok], a3 at a[om + ok]; split for f32, exact for bf16 (al
// unused).
template <typename E>
__device__ __forceinline__ void frag_a(const E* a, int om, int ok,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  if constexpr (is_f32<E>) {
    split_a(a[0], a[om], a[ok], a[om + ok], ah, al);
  } else {
    ah[0] = exact_tf32(to_f32(a[0]));
    ah[1] = exact_tf32(to_f32(a[om]));
    ah[2] = exact_tf32(to_f32(a[ok]));
    ah[3] = exact_tf32(to_f32(a[om + ok]));
  }
}

// acc += a * b with B's fragment values (b0, b1) read from a stage: 3xTF32
// for f32, one pass for bf16.
template <typename E>
__device__ __forceinline__ void mma_ab(float (&acc)[4],
                                       const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], E b0, E b1) {
  if constexpr (is_f32<E>)
    mma_3xtf32(acc, ah, al, b0, b1);
  else
    mma_tf32(acc, ah, exact_tf32(to_f32(b0)), exact_tf32(to_f32(b1)));
}

// Row sweep, one block per (row block, feature slice of DN, head), over
// tiles ptr[i]..ptr[i+1] (row-sorted order):
//   out row r = sum_c vals[t][r][c] * x[blk[t]*128 + c].
// DOTONLY = true: every vals entry is 0.01; vals is not read (f32 only).
template <typename E, int DN, bool DOTONLY>
__global__ void __launch_bounds__(THREADS, 1)
spmm_row_sweep_kernel(const int* __restrict__ ptr,
                      const int* __restrict__ blk,
                      const E* __restrict__ vals,
                      const E* __restrict__ x, E* __restrict__ out,
                      int T, int d, int n_x, int n_out, int vec) {
  using C = RowCfg<E, DN>;
  constexpr int VLD = C::VLD, XLD = C::XLD, STAGE = C::STAGE;
  constexpr int NI = DN / 16, CHUNKS = TILE / RS_COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int i = blockIdx.x, d0 = blockIdx.y * DN, h = blockIdx.z;
  const long long ld = (long long)gridDim.z * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, wm = warp / 2, wn = warp % 2;
  const E* xh = x + (long long)h * d;
  const int lo = ptr[i], n_chunks = (ptr[i + 1] - lo) * CHUNKS;

  // Chunk q: columns (q % CHUNKS) * RS_COLS .. + RS_COLS of tile lo + q /
  // CHUNKS and the matching rows of x, into stage q % RS_STAGES.
  auto issue = [&](int q) {
    E* vs = smem + (q % RS_STAGES) * STAGE;
    const int t = lo + q / CHUNKS, c0 = (q % CHUNKS) * RS_COLS;
    if constexpr (!DOTONLY)
      load_rows<TILE, RS_COLS, VLD, THREADS>(
          vs, vals + ((long long)h * T + t) * TILE * TILE, 0, TILE, c0, TILE,
          TILE, 1, tid);
    load_rows<RS_COLS, DN, XLD, THREADS>(vs + TILE * VLD, xh,
                                         (long long)blk[t] * TILE + c0, n_x,
                                         d0, d, ld, vec, tid);
  };

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mi][ni][u] = 0.f;
  uint32_t ch, cl;  // S4's constant, split
  split_tf32(0.01f, ch, cl);

#pragma unroll
  for (int q = 0; q < RS_STAGES - 1; ++q) {
    if (q < n_chunks) issue(q);
    cp_async_commit();
  }
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<RS_STAGES - 2>();  // chunk q has landed
    __syncthreads();  // and every warp is done with chunk q - 1's stage
    if (q + RS_STAGES - 1 < n_chunks) issue(q + RS_STAGES - 1);
    cp_async_commit();
    const E* vs = smem + (q % RS_STAGES) * STAGE;
    const E* va = vs + (32 * wm + g) * VLD + t4;
    const E* xb = vs + TILE * VLD + t4 * XLD + wn * (DN / 2) + g;
#pragma unroll
    for (int ks = 0; ks < RS_COLS / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if constexpr (DOTONLY) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            ah[mi][u] = ch;
            al[mi][u] = cl;
          }
        } else {
          frag_a(va + 16 * mi * VLD + ks * 8, 8 * VLD, 4, ah[mi], al[mi]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const E* b = xb + ks * 8 * XLD + 8 * ni;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_ab(acc[mi][ni], ah[mi], al[mi], b[0], b[4 * XLD]);
      }
    }
  }

  E* oh = out + (long long)h * d;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long r =
            (long long)i * TILE + 32 * wm + 16 * mi + g + (u >= 2 ? 8 : 0);
        const int f = d0 + wn * (DN / 2) + 8 * ni + 2 * t4 + (u & 1);
        if (r < n_out && f < d) oh[r * ld + f] = from_f32<E>(acc[mi][ni][u]);
      }
}

template <typename E, int DN, bool DOTONLY>
int launch_row_sweep(const int* ptr, const int* blk, const E* vals,
                     const E* x, E* out, int nrb, int T, int H, int d,
                     int n_x, int n_out, cudaStream_t stream) {
  auto kernel = spmm_row_sweep_kernel<E, DN, DOTONLY>;
  const int smem = (int)RowCfg<E, DN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d % (16 / (int)sizeof(E)) == 0 && aligned16(x);
  dim3 grid(nrb, (d + DN - 1) / DN, H);
  kernel<<<grid, THREADS, smem, stream>>>(ptr, blk, vals, x, out, T, d, n_x,
                                         n_out, vec);
  return (int)cudaGetLastError();
}

template <typename E, bool DOTONLY>
int row_sweep(const int* ptr, const int* blk, const E* vals, const E* x,
              E* out, int nrb, int T, int H, int d, int n_x, int n_out,
              cudaStream_t stream) {
  if (d <= 64)
    return launch_row_sweep<E, 64, DOTONLY>(ptr, blk, vals, x, out, nrb, T,
                                            H, d, n_x, n_out, stream);
  return launch_row_sweep<E, 128, DOTONLY>(ptr, blk, vals, x, out, nrb, T, H,
                                           d, n_x, n_out, stream);
}

// ---------------------------------------------------------------------------
// K3: SpMM column sweep
// ---------------------------------------------------------------------------

// Column sweep, one block per (column block, feature
// slice of DN, head), over the tiles perm[ptr[j]..ptr[j+1]]:
//   out row c = sum_r vals[t][r][c] * y[blk[t]*128 + r],
// i.e. out[j] (128 x DN) = sum_t A_t B_t with A_t = vals[t]^T (c x r) and
// B_t = y rows (r x f). Warp w owns output rows 32 * (w / 2) .. + 32 and
// features (w % 2) * DN / 2 .. + DN / 2: two 16-row m-tiles by DN / 16
// 8-wide n-tiles of accumulators. Both operands are read from row-major
// stages (vals [r][c], y [r][f]) whose strides are 8 mod 32 floats, so the
// fragment reads a0 (k = t, m = g) and b0 (k = t, n = g) hit 32 distinct
// banks; no transpose.
constexpr int CS_ROWS = 64;   // contraction rows (of vals and y) per stage
constexpr int CS_STAGES = 3;
constexpr int CS_VLD = TILE + 8;

template <typename E, int DN>
struct ColCfg {
  static constexpr int YLD = DN + 8;
  static constexpr int STAGE = CS_ROWS * (CS_VLD + YLD);  // elements
  static constexpr size_t SMEM = sizeof(E) * CS_STAGES * STAGE;
};

template <typename E, int DN>
__global__ void __launch_bounds__(THREADS, 1)
spmm_col_sweep_kernel(const int* __restrict__ ptr,
                      const int* __restrict__ perm,
                      const int* __restrict__ blk,
                      const E* __restrict__ vals,
                      const E* __restrict__ y, E* __restrict__ out,
                      int T, int d, int n_y, int n_out, int vec) {
  constexpr int YLD = ColCfg<E, DN>::YLD, STAGE = ColCfg<E, DN>::STAGE;
  constexpr int NI = DN / 16, CHUNKS = TILE / CS_ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int j = blockIdx.x, d0 = blockIdx.y * DN, h = blockIdx.z;
  const long long ld = (long long)gridDim.z * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, wm = warp / 2, wn = warp % 2;
  const E* yh = y + (long long)h * d;
  const int lo = ptr[j], n_chunks = (ptr[j + 1] - lo) * CHUNKS;

  // Chunk q: rows (q % CHUNKS) * CS_ROWS .. + CS_ROWS of tile perm[lo + q /
  // CHUNKS] and the matching rows of y, into stage q % CS_STAGES. Rows of y
  // at or past n_y and features at or past d are filled with zeros.
  auto issue = [&](int q) {
    E* vs = smem + (q % CS_STAGES) * STAGE;
    const int t = perm[lo + q / CHUNKS], r0 = (q % CHUNKS) * CS_ROWS;
    load_rows<CS_ROWS, TILE, CS_VLD, THREADS>(
        vs, vals + ((long long)h * T + t) * TILE * TILE, r0, TILE, 0, TILE,
        TILE, 1, tid);
    load_rows<CS_ROWS, DN, YLD, THREADS>(vs + CS_ROWS * CS_VLD, yh,
                                         (long long)blk[t] * TILE + r0, n_y,
                                         d0, d, ld, vec, tid);
  };

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mi][ni][u] = 0.f;

#pragma unroll
  for (int q = 0; q < CS_STAGES - 1; ++q) {
    if (q < n_chunks) issue(q);
    cp_async_commit();
  }
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<CS_STAGES - 2>();  // chunk q has landed
    __syncthreads();  // and every warp is done with chunk q - 1's stage
    if (q + CS_STAGES - 1 < n_chunks) issue(q + CS_STAGES - 1);
    cp_async_commit();
    const E* vs = smem + (q % CS_STAGES) * STAGE;
    const E* va = vs + t4 * CS_VLD + 32 * wm + g;
    const E* yb = vs + CS_ROWS * CS_VLD + t4 * YLD + wn * (DN / 2) + g;
#pragma unroll
    for (int ks = 0; ks < CS_ROWS / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        frag_a(va + ks * 8 * CS_VLD + 16 * mi, 8, 4 * CS_VLD, ah[mi], al[mi]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const E* b = yb + ks * 8 * YLD + 8 * ni;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_ab(acc[mi][ni], ah[mi], al[mi], b[0], b[4 * YLD]);
      }
    }
  }

  E* oh = out + (long long)h * d;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long r =
            (long long)j * TILE + 32 * wm + 16 * mi + g + (u >= 2 ? 8 : 0);
        const int f = d0 + wn * (DN / 2) + 8 * ni + 2 * t4 + (u & 1);
        if (r < n_out && f < d) oh[r * ld + f] = from_f32<E>(acc[mi][ni][u]);
      }
}

template <typename E, int DN>
int launch_col_sweep(const int* ptr, const int* perm, const int* rows,
                     const E* vals, const E* y, E* out, int ncb, int T, int H,
                     int d, int n_y, int n_out, int vec, cudaStream_t stream) {
  auto kernel = spmm_col_sweep_kernel<E, DN>;
  const int smem = (int)ColCfg<E, DN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ncb, (d + DN - 1) / DN, H);
  kernel<<<grid, THREADS, smem, stream>>>(ptr, perm, rows, vals, y, out, T, d,
                                         n_y, n_out, vec);
  return (int)cudaGetLastError();
}

template <typename E>
int sddmm_tiles(const int* rows, const int* cols, const uint8_t* mask,
                const E* A, const E* B, E* out, int T, int H, int d, int nA,
                int nB, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  auto kernel = sddmm_tiles_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SD_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      d % (16 / (int)sizeof(E)) == 0 && aligned16(A) && aligned16(B);
  dim3 grid(T, H);
  kernel<<<grid, THREADS, SD_SMEM, stream>>>(rows, cols, mask, A, B, out, T,
                                             d, nA, nB, vec);
  return (int)cudaGetLastError();
}

template <typename E>
int col_sweep(const int* tile_ptr_c, const int* tile_perm_c,
              const int* tile_rows, const E* vals, const E* y, E* out,
              int ncb, int T, int H, int d, int n_y, int n_out, int vec,
              int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (d <= 64)
    return launch_col_sweep<E, 64>(tile_ptr_c, tile_perm_c, tile_rows, vals,
                                   y, out, ncb, T, H, d, n_y, n_out, vec,
                                   stream);
  return launch_col_sweep<E, 128>(tile_ptr_c, tile_perm_c, tile_rows, vals, y,
                                  out, ncb, T, H, d, n_y, n_out, vec, stream);
}

}  // namespace

extern "C" {

// A: (nA, H, d), B: (nB, H, d), mask: (T, 128, 128), 16-byte aligned ->
// out: (H, T, 128, 128).
int sddmm_tiles_f32(const int* rows, const int* cols, const uint8_t* mask,
                    const float* A, const float* B, float* out, int T, int H,
                    int d, int nA, int nB, int device, cudaStream_t stream) {
  return sddmm_tiles(rows, cols, mask, A, B, out, T, H, d, nA, nB, device,
                     stream);
}

int sddmm_tiles_bf16(const int* rows, const int* cols, const uint8_t* mask,
                     const bf16* A, const bf16* B, bf16* out, int T, int H,
                     int d, int nA, int nB, int device, cudaStream_t stream) {
  return sddmm_tiles(rows, cols, mask, A, B, out, T, H, d, nA, nB, device,
                     stream);
}

// vals: (H, T, 128, 128), 16-byte aligned, x: (n_x, H, d) -> out:
// (n_out, H, d), with n_out <= nrb * 128.
int spmm_row_sweep_f32(const int* tile_ptr, const int* tile_cols,
                       const float* vals, const float* x, float* out, int nrb,
                       int T, int H, int d, int n_x, int n_out, int device,
                       cudaStream_t stream) {
  cudaSetDevice(device);
  return row_sweep<float, false>(tile_ptr, tile_cols, vals, x, out, nrb, T, H,
                                 d, n_x, n_out, stream);
}

int spmm_row_sweep_bf16(const int* tile_ptr, const int* tile_cols,
                        const bf16* vals, const bf16* x, bf16* out, int nrb,
                        int T, int H, int d, int n_x, int n_out, int device,
                        cudaStream_t stream) {
  cudaSetDevice(device);
  return row_sweep<bf16, false>(tile_ptr, tile_cols, vals, x, out, nrb, T, H,
                                d, n_x, n_out, stream);
}

// vals: (H, T, 128, 128), 16-byte aligned, y: (n_y, H, d) -> out:
// (n_out, H, d), with n_out <= ncb * 128. vec: y is 16-byte aligned and its
// rows are whole 16-byte pieces.
int spmm_col_sweep_f32(const int* tile_ptr_c, const int* tile_perm_c,
                       const int* tile_rows, const float* vals, const float* y,
                       float* out, int ncb, int T, int H, int d, int n_y,
                       int n_out, int vec, int device, cudaStream_t stream) {
  return col_sweep(tile_ptr_c, tile_perm_c, tile_rows, vals, y, out, ncb, T,
                   H, d, n_y, n_out, vec, device, stream);
}

int spmm_col_sweep_bf16(const int* tile_ptr_c, const int* tile_perm_c,
                        const int* tile_rows, const bf16* vals, const bf16* y,
                        bf16* out, int ncb, int T, int H, int d, int n_y,
                        int n_out, int vec, int device, cudaStream_t stream) {
  return col_sweep(tile_ptr_c, tile_perm_c, tile_rows, vals, y, out, ncb, T,
                   H, d, n_y, n_out, vec, device, stream);
}

// S4: x: (n_x, H, d) -> out: (n_out, H, d), n_out <= nrb * 128; the row
// sweep with every tile's values the constant 0.01 (no vals argument).
int spmm_dotonly_f32(const int* tile_ptr, const int* tile_cols,
                     const float* x, float* out, int nrb, int H, int d,
                     int n_x, int n_out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  return row_sweep<float, true>(tile_ptr, tile_cols, nullptr, x, out, nrb, 0,
                                H, d, n_x, n_out, stream);
}

}  // extern "C"
