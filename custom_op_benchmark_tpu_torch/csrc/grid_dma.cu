// Row-block-owned SpMM sweeps with asynchronous prefetch, for Hopper
// (sm_90a), f32 and bf16.
//
// Replaces the two Pallas TPU kernels of scripts/exp_grid_dma.py:
//   S1 spmm_row_sweep_dma     <- spmm_row_sweep_dma
//     Y[i] = sum_{s < max_tpr} vals_pad[i, s] @ X[cols_pad[i, s]*128 : +128]
//     over a dense-padded layout whose zero padding contributes 0
//   S2 spmm_row_sweep_dma_v2  <- spmm_row_sweep_dma_v2
//     Y[i] = sum_{t in ptr[i]..ptr[i+1]} vals[t] @ X[cols[t]*128 : +128]
//     (K2's function on K2's (T, 128, 128) tile list)
// Both are single-head: x is (n_x, d), out (n_out, d). S1 is S2 on the
// padded layout: the same kernel, with PADDED = true reading slots
// i*max_tpr .. +max_tpr of (cols_pad, vals_pad).
//
// What the TPU experiment tested, and what is kept: one owner per output
// row block, and the next row block's operands in flight while the current
// one computes (there, manual DMAs one row block ahead, exp_grid_dma.py:64).
// What bounds it on this card: 2*128*128*d products per tile against 64 KB
// of vals (f32) and 128*d elements of x, which are mostly L2 hits (the
// grid's x blocks are shared by neighbouring row blocks). On the CUDA
// cores (67 TFLOP/s) the products alone take 2.4-2.6 ms on the grid at
// d = 128, twice the bytes' bound, so the products run on the tensor cores
// with K2's arithmetic and stores (mma_async.cuh: RowCfg, row_sweep_chunk,
// row_sweep_store): 3xTF32 mma.sync m16n8k8 for f32, native bf16
// m16n8k16 fed by ldmatrix for bf16, f32 accumulation, one rounding at the
// store. The stage layout (chunks of 64 columns of a vals tile and the
// matching 64 rows of x, strides 68 / 72 and DN + 8 elements), the warp
// tiling (8 warps, 32 rows x DN / 2 features each), the pass order and the
// width route (DN = 64 for d <= 64, else 128) are K2's, so S2 at one head
// gives K2's bits and the change against K2 is only in scheduling and
// copies.
//
// What the design does about K2's schedule (one short block per row block
// and feature slice; its ring starts empty and its 64 KB store is
// exposed): persistent blocks, about one per SM. Block b takes the work
// items (row block, feature slice) b, b + G, b + 2G, ... in that fixed
// order, so every row block is summed by one block in K2's order and the
// bits do not depend on timing. The three-stage ring of chunks is numbered
// across items: the producer fills the next item's first chunks while the
// consumers multiply the last chunks of the current one and store it.
//
// Warp roles: warps 0-7 consume (wait on a stage's full mbarrier, multiply,
// then lane 0 of each warp arrives on its empty mbarrier), warp 8 produces
// (waits on the empty mbarrier; its lane 0 arrives on the full one,
// expecting the stage's bytes, and issues the copies). The copies are 2-D
// TMA box copies (cp.async.bulk.tensor) through two tensor maps, vals as a
// (T*128, 128) array and x as (n_x, d), made on the host by
// cuTensorMapEncodeTiled (looked up at run time with
// cudaGetDriverEntryPoint, so nothing links against libcuda) and passed as __grid_constant__ parameters. A box
// is as wide as a staged row with its padding (68 or 72 columns of vals,
// DN + 8 features of x), so it lands in K2's padded stride as it is: a
// chunk is two copies, and the padding columns hold the neighbouring
// columns (never read as operands) or zeros. Rows past n_x and features
// past d read as zero in the copy, so callers never pad. Measured on the
// H100 against this design (PERF.md): one bulk copy per staged row (192 TMA
// operations a chunk; the TMA unit's rate for such small copies bounded
// it), 64-column boxes 128-byte swizzled (the swizzled fragment addressing
// spilled registers and slowed the consumers), and cp.async issued by the
// producer's lanes.
//
// When x's rows are not whole 16-byte pieces or x is not 16-byte aligned
// (d % 4 for f32, d % 8 for bf16), the producer's lanes move x element by
// element (cp.async of 4 bytes with zero fill for f32, loads and stores for
// bf16), wait for them, then arrive; vals always moves by TMA. The
// barriers' phases flip each time the ring wraps (parity = pass & 1), not
// at item boundaries. No atomics: outputs repeat bit for bit; an empty row
// block writes zeros, and where there is no tile at all the launch only
// clears the output.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_async.cuh"

namespace {

constexpr int TILE = RS_ROWS;
constexpr int CONSUMERS = 8;                     // warps that multiply
constexpr int THREADS = 32 * (CONSUMERS + 1);    // and one producer warp
// S2's entry point is not given T: its vals map spans every tile a 32-bit
// TMA row coordinate reaches, and only the listed tiles' rows are read.
constexpr long long MAX_TILES = 0x7fffffffLL / TILE;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_addr(bar)) : "memory");
}

// Arrive, and add `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wrong parity
// would wait forever: after about 2^26 tries (seconds) the kernel traps, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = shared_addr(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// A TMA copy of the box at (column c, row r) of a 2-D tensor map into
// shared memory (128-byte aligned), completing on `bar`; out-of-bounds
// elements read as 0 and count towards the box's bytes.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(shared_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
      "r"(shared_addr(bar)) : "memory");
}

// PADDED = true (S1): item rows i*max_tpr .. +max_tpr of (cols, vals).
// PADDED = false (S2): tiles ptr[i] .. ptr[i+1].
// vec: x's rows move by TMA (16-byte pieces, x 16-byte aligned).
template <typename E, int DN, bool PADDED>
__global__ void __launch_bounds__(THREADS, 1)
spmm_dma_kernel(const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap xmap,
                const int* __restrict__ ptr, const int* __restrict__ cols,
                const E* __restrict__ x, E* __restrict__ out, int nrb,
                int max_tpr, int d, int n_x, int n_out, int vec) {
  using C = RowCfg<E, DN>;
  constexpr int VLD = C::VLD, XLD = C::XLD, STAGE = C::STAGE;
  constexpr int NI = DN / 16, CHUNKS = TILE / RS_COLS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  E* stages = reinterpret_cast<E*>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + C::SMEM);
  uint64_t* empty = full + RS_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slices = (d + DN - 1) / DN, items = nrb * slices;

  if (tid == 0) {
    for (int s = 0; s < RS_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Item w: row block w / slices, features (w % slices) * DN .. + DN; its
  // tiles lo .. lo + count.
  auto tiles = [&](int rb, int& lo) {
    if constexpr (PADDED) {
      lo = rb * max_tpr;
      return max_tpr;
    } else {
      lo = ptr[rb];
      return ptr[rb + 1] - lo;
    }
  };
  // Chunk q of the block's sequence sits in stage q % RS_STAGES, in pass
  // q / RS_STAGES of the ring.
  int stage = 0;
  uint32_t pass = 0;
  auto advance = [&] {
    if (++stage == RS_STAGES) {
      stage = 0;
      pass ^= 1;
    }
  };

  if (warp == CONSUMERS) {  // the producer
    const uint32_t bytes =
        sizeof(E) * (TILE * VLD + (vec ? RS_COLS * XLD : 0));
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int rb = w / slices, d0 = (w % slices) * DN;
      int lo;
      const int n_chunks = tiles(rb, lo) * CHUNKS;
      for (int q = 0; q < n_chunks; ++q) {
        mbar_wait(&empty[stage], pass ^ 1);  // the consumers are done
        E* vs = stages + stage * STAGE;
        E* xs = vs + TILE * VLD;
        const int t = lo + q / CHUNKS, c0 = (q % CHUNKS) * RS_COLS;
        const int xr0 = cols[t] * TILE + c0;
        if (!vec) {
          load_rows<RS_COLS, DN, XLD, 32>(xs, x, xr0, n_x, d0, d, d, 0, lane);
          cp_async_commit();
          cp_async_wait<0>();
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_tx(&full[stage], bytes);
          tma_box(vs, &vmap, c0, t * TILE, &full[stage]);
          if (vec) tma_box(xs, &xmap, d0, xr0, &full[stage]);
        }
        advance();
      }
    }
    return;
  }

  const int wm = warp / 2, wn = warp % 2;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int rb = w / slices, d0 = (w % slices) * DN;
    int lo;
    const int n_chunks = tiles(rb, lo) * CHUNKS;
    float acc[2][NI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mi][ni][u] = 0.f;

    for (int q = 0; q < n_chunks; ++q) {
      mbar_wait(&full[stage], pass);  // chunk q has landed
      row_sweep_chunk<E, DN>(acc, stages + stage * STAGE, wm, wn, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // the warp is done
      advance();
    }
    row_sweep_store<E, DN>(out, acc, (long long)rb * TILE, d0, n_out, d, d,
                           wm, wn, lane);
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no link against
// libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A row-major (rows, cols) array of E (cols * sizeof(E) a multiple of 16,
// base 16-byte aligned) as a 2-D tensor map of (box_cols, box_rows) boxes,
// box_cols * sizeof(E) a multiple of 16, landing unswizzled.
template <typename E>
bool tensor_map(CUtensorMap* map, const E* base, long long rows, int cols,
                int box_cols, int box_rows) {
  auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(E)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map,
                is_f32<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<E*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int DN, bool PADDED>
int launch(const int* ptr, const int* cols, const E* vals, long long tiles,
           const E* x, E* out, int nrb, int max_tpr, int d, int n_x,
           int n_out, int vec, int device, cudaStream_t stream) {
  using C = RowCfg<E, DN>;
  auto kernel = spmm_dma_kernel<E, DN, PADDED>;
  const int smem = (int)(C::SMEM + 2 * RS_STAGES * sizeof(uint64_t));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int items = nrb * ((d + DN - 1) / DN);
  if (items == 0) return 0;  // no row block: n_out is 0
  // No tile at all (S1 with max_tpr = 0, or S2 given an empty vals, whose
  // pointer is null): every row block is empty and writes zeros. A tensor
  // map takes no empty or null array.
  if (tiles == 0 || vals == nullptr)
    return (int)cudaMemsetAsync(out, 0, sizeof(E) * n_out * d, stream);
  // x with no rows reads as zero through the element path. Without vec x's
  // map is not read and stays zero.
  vec = vec && n_x > 0;
  CUtensorMap vmap, xmap = {};
  if (!tensor_map(&vmap, vals, tiles * TILE, TILE, C::VLD, TILE) ||
      (vec && !tensor_map(&xmap, x, n_x, d, C::XLD, RS_COLS)))
    return (int)cudaErrorInvalidValue;
  kernel<<<min(items, sms), THREADS, smem, stream>>>(
      vmap, xmap, ptr, cols, x, out, nrb, max_tpr, d, n_x, n_out, vec);
  return (int)cudaGetLastError();
}

template <typename E, bool PADDED>
int row_sweep_dma(const int* ptr, const int* cols, const E* vals,
                  long long tiles, const E* x, E* out, int nrb, int max_tpr,
                  int d, int n_x, int n_out, int vec, int device,
                  cudaStream_t stream) {
  cudaSetDevice(device);
  if (d <= 64)
    return launch<E, 64, PADDED>(ptr, cols, vals, tiles, x, out, nrb,
                                 max_tpr, d, n_x, n_out, vec, device, stream);
  return launch<E, 128, PADDED>(ptr, cols, vals, tiles, x, out, nrb, max_tpr,
                                d, n_x, n_out, vec, device, stream);
}

}  // namespace

extern "C" {

// S1: cols_pad (nrb, max_tpr), vals_pad (nrb, max_tpr, 128, 128), 16-byte
// aligned, x (n_x, d) -> out (n_out, d), n_out <= nrb * 128. vec: x is
// 16-byte aligned and its rows are whole 16-byte pieces.
int spmm_row_sweep_dma_f32(const int* cols_pad, const float* vals_pad,
                           const float* x, float* out, int nrb, int max_tpr,
                           int d, int n_x, int n_out, int vec, int device,
                           cudaStream_t stream) {
  return row_sweep_dma<float, true>(nullptr, cols_pad, vals_pad,
                                    (long long)nrb * max_tpr, x, out, nrb,
                                    max_tpr, d, n_x, n_out, vec, device,
                                    stream);
}

int spmm_row_sweep_dma_bf16(const int* cols_pad, const bf16* vals_pad,
                            const bf16* x, bf16* out, int nrb, int max_tpr,
                            int d, int n_x, int n_out, int vec, int device,
                            cudaStream_t stream) {
  return row_sweep_dma<bf16, true>(nullptr, cols_pad, vals_pad,
                                   (long long)nrb * max_tpr, x, out, nrb,
                                   max_tpr, d, n_x, n_out, vec, device,
                                   stream);
}

// S2: tile_ptr (nrb + 1), tile_cols (T), vals (T, 128, 128), 16-byte
// aligned, x (n_x, d) -> out (n_out, d), n_out <= nrb * 128.
int spmm_row_sweep_dma_v2_f32(const int* tile_ptr, const int* tile_cols,
                              const float* vals, const float* x, float* out,
                              int nrb, int d, int n_x, int n_out, int vec,
                              int device, cudaStream_t stream) {
  return row_sweep_dma<float, false>(tile_ptr, tile_cols, vals, MAX_TILES, x,
                                     out, nrb, 0, d, n_x, n_out, vec, device,
                                     stream);
}

int spmm_row_sweep_dma_v2_bf16(const int* tile_ptr, const int* tile_cols,
                               const bf16* vals, const bf16* x, bf16* out,
                               int nrb, int d, int n_x, int n_out, int vec,
                               int device, cudaStream_t stream) {
  return row_sweep_dma<bf16, false>(tile_ptr, tile_cols, vals, MAX_TILES, x,
                                    out, nrb, 0, d, n_x, n_out, vec, device,
                                    stream);
}

}  // extern "C"
