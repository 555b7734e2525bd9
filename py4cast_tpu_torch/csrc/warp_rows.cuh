// Warp-per-cell building blocks of the corner-hop forward (corner_hop.cu);
// the other kernels take their constants and `stage`.
//
// A warp owns P cells at once. For each cell it keeps one feature row
// in registers, spread over the lanes: lane l holds channels l, l+32,
// ..., l+32(J-1) of the row, so a row of up to 32*J channels lives in J
// registers a lane and every row load or store is coalesced. Dense
// weights sit in shared memory as [in][32*J] with zero columns past the
// real width, so no lane needs a bounds test inside a product.
//
// A row-times-matrix product broadcasts each input channel from the
// lane that holds it (warp shuffle) and accumulates into the lanes'
// output channels: every weight read from shared memory feeds P cells.
#pragma once

#include <cuda_runtime.h>

namespace p4t {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LN_EPS = 1e-6f;  // flax nn.LayerNorm default

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// acc[p][j] += sum_{m < n_in} x[p][m] * W[m][lane + 32 j]      (x @ W)
// W is a shared-memory [n_in][ld] matrix, ld = 32*J unless given.
template <int J, int P>
__device__ __forceinline__ void row_matmul(const float (&x)[P][J], float (&acc)[P][J],
                                           const float* __restrict__ W, int n_in,
                                           int lane, int ld = 32 * J) {
#pragma unroll
  for (int jm = 0; jm < J; ++jm) {
    const int m_end = min(32, n_in - 32 * jm);
#pragma unroll 4
    for (int mm = 0; mm < m_end; ++mm) {
      const float* wrow = W + (32 * jm + mm) * ld + lane;
      float w[J];
#pragma unroll
      for (int j = 0; j < J; ++j) w[j] = wrow[32 * j];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float xm = __shfl_sync(FULL, x[p][jm], mm);
#pragma unroll
        for (int j = 0; j < J; ++j) acc[p][j] = fmaf(xm, w[j], acc[p][j]);
      }
    }
  }
}

// In place: t <- LayerNorm(t) * scale + bias over the first h channels
// (two-pass mean/variance, as flax computes it). Channels past h stay 0.
template <int J>
__device__ __forceinline__ void layer_norm(float (&t)[J], const float* __restrict__ scale,
                                           const float* __restrict__ bias, int h, int lane) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) s += t[j];
  const float mu = warp_sum(s) / h;
  float d[J];
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    d[j] = (lane + 32 * j < h) ? t[j] - mu : 0.f;
    s2 += d[j] * d[j];
  }
  const float inv = rsqrtf(warp_sum(s2) / h + LN_EPS);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    t[j] = d[j] * inv * scale[c] + bias[c];
  }
}

// Copy a global [rows][cols] row-major matrix into shared [rows][32*J],
// zero-filling columns cols..32*J-1. A vector is a 1-row matrix.
template <int J>
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                                      int rows, int cols) {
  constexpr int HP = 32 * J;
  for (int i = threadIdx.x; i < rows * HP; i += blockDim.x) {
    const int r = i / HP, c = i % HP;
    dst[i] = c < cols ? src[r * cols + c] : 0.f;
  }
}

// Launch geometry for a kernel whose warps loop over `groups` work
// items: enough blocks to fill every SM at the occupancy the kernel's
// registers and shared memory allow, never more than the work needs.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t smem, long long groups,
                     int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long warps_per_block = threads / 32;
  const long long needed = (groups + warps_per_block - 1) / warps_per_block;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(needed < cap ? (needed > 0 ? needed : 1) : cap);
  return cudaSuccess;
}

}  // namespace p4t

// The message of a cudaError_t, for the Python wrapper's exception. Each
// kernel source is its own library, so each carries one definition.
extern "C" const char* p4t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
