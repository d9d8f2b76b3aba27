// L2 gather probe for Hopper (sm_90a): a measurement kernel, not the port
// of a TPU kernel. It gives the yardstick that S3's rows are held to (the
// "L2 gather bound"), so that bound does not move when S3 does.
//
// Each warp reads `reads` rows of 128 floats (512 bytes: one 16-byte load
// a lane, the row read of S3 at d = 128) from random rows of a table that
// fits the 50 MB L2, DEPTH rows in flight a warp (8 or 16) before it adds
// them, and writes one word: the sum of what it read (so nothing is
// optimised away).
// The rows come from a hash of (warp, read), so no index array is read.
// The loads bypass L1 (ld.global.cg): the probe measures the L2's rate
// for random 512-byte rows, with as many in flight as the SMs hold.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_VEC = 32;            // float4 a row: 128 floats
constexpr unsigned FULL = 0xffffffffu;

// A 32-bit integer hash (one round of xor-shift-multiply mixing).
__device__ __forceinline__ unsigned mix(unsigned h) {
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  h ^= h >> 16;
  return h;
}

template <int DEPTH>
__global__ void __launch_bounds__(THREADS)
l2_probe_kernel(const float4* __restrict__ table, int rows, int reads,
                float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned warp = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const unsigned seed = mix(warp * 0x9e3779b9u + 1u);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < reads; i += DEPTH) {
    float4 v[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const unsigned r = mix(seed + (unsigned)(i + u)) % (unsigned)rows;
      v[u] = __ldcg(table + (size_t)r * ROW_VEC + lane);
    }
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  float s = (acc.x + acc.y) + (acc.z + acc.w);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) out[warp] = s;
}

}  // namespace

extern "C" {

// table (rows, 128) f32, 16-byte aligned; each of `warps` warps reads
// `reads` random rows (a multiple of depth), depth (8 or 16) in flight,
// and writes out[warp] (warps floats). warps a multiple of 8.
int l2_probe_f32(const float* table, int rows, int reads, int warps,
                 int depth, float* out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (rows <= 0 || (depth != 8 && depth != 16) || reads % depth != 0 ||
      warps % (THREADS / 32) != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = warps / (THREADS / 32);
  if (blocks == 0) return 0;
  const float4* t = reinterpret_cast<const float4*>(table);
  if (depth == 8)
    l2_probe_kernel<8><<<blocks, THREADS, 0, stream>>>(t, rows, reads, out);
  else
    l2_probe_kernel<16><<<blocks, THREADS, 0, stream>>>(t, rows, reads, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
