// Bank-conflict probe for the swizzled weight layout of row_tiles.cuh.
//
// A block times its 128-bit shared-memory reads of an [HP][HP] matrix
// in the two patterns the row-tile products use: the X @ W pattern of
// tile_mm (NX = HP / 4 lanes across one row, lane tx on chunk tx; a
// warp holds 32 / NX row groups that read the same row) and the X @ W^T
// pattern of tile_mm_t (lane tx on chunk k / 4 of rows 4 tx .. 4 tx + 3),
// each on the swizzled layout (swz) and on the plain row-major one. A
// read free of bank conflicts takes as long as the plain row read; the
// plain layout under the W^T pattern puts every lane of a quarter-warp
// on one bank group and shows what a conflict costs. Built and run only
// by the card tests (tests/test_torch_cuda.py); no model path uses it.

#include "row_tiles.cuh"

namespace {

using namespace p4t::rt;

constexpr int PASSES = 64;
constexpr int WARPS = 32;  // enough that the reads, not the issue, set the pace

__device__ __forceinline__ float lds128_x(const float* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v.x;
}

template <int HP, bool TRANSPOSED, bool SWIZZLED>
__global__ void __launch_bounds__(WARPS * 32) read_cycles(long long* cycles, float* sink) {
  extern __shared__ __align__(16) float w[];  // [HP][HP]
  for (int i = threadIdx.x; i < HP * HP; i += blockDim.x) w[i] = static_cast<float>(i & 255);
  __syncthreads();
  constexpr int NX = HP / 4;
  const int tx = threadIdx.x % NX;
  // entry (r, c) of the matrix, swizzled as swz<HP> or row-major; for
  // k = k8 + 4 u + j (tile_mm: row k, chunk tx; tile_mm_t: row 4 tx + j,
  // chunk k / 4) the chunk a lane reads depends on u and tx alone
  const float* base[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (TRANSPOSED)
      base[u] = w + (SWIZZLED ? swz<HP>(4 * tx, 4 * u) : 4 * tx * HP + 4 * u);
    else
      base[u] = w + (SWIZZLED ? swz<HP>(4 * u, 4 * tx) : 4 * u * HP + 4 * tx);
  }
  float acc = 0.f;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
    for (int k8 = 0; k8 < HP; k8 += 32)
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc += lds128_x(base[u] + (TRANSPOSED ? j * HP + k8 : (k8 + j) * HP));
  }
  __syncthreads();
  const long long t1 = clock64();
  sink[threadIdx.x] = acc;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

template <int HP, bool TRANSPOSED, bool SWIZZLED>
cudaError_t launch(long long* cycles, float* sink) {
  constexpr int bytes = HP * HP * sizeof(float);
  auto kernel = read_cycles<HP, TRANSPOSED, SWIZZLED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, WARPS * 32, bytes>>>(cycles, sink);
  return cudaGetLastError();
}

template <int HP>
cudaError_t run(int transposed, int swizzled, long long* cycles, float* sink) {
  if (transposed) {
    return swizzled ? launch<HP, true, true>(cycles, sink) : launch<HP, true, false>(cycles, sink);
  }
  return swizzled ? launch<HP, false, true>(cycles, sink) : launch<HP, false, false>(cycles, sink);
}

}  // namespace

// C entry: *cycles = the clock cycles a block of 32 warps took for
// PASSES passes of HP 128-bit reads a lane over an [HP][HP] shared
// matrix (HP = 32, 64 or 128), in tile_mm_t's pattern when `transposed`
// else tile_mm's, on the swizzled layout when `swizzled` else row-major.
// `cycles` and `sink` (1024 floats) are device memory, on the default
// stream. Returns the cudaError_t of the launch.
extern "C" int p4t_row_tiles_read_cycles(int hp, int transposed, int swizzled, long long* cycles,
                                         float* sink) {
  switch (hp) {
    case 32: return run<32>(transposed, swizzled, cycles, sink);
    case 64: return run<64>(transposed, swizzled, cycles, sink);
    case 128: return run<128>(transposed, swizzled, cycles, sink);
    default: return (int)cudaErrorInvalidValue;
  }
}
