// Lattice stencil edge message, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel py4cast_tpu/ops/stencil_kernel.py::_fwd_kernel
// (called through _fwd_call; its lane-packed twin _fwd_kernel_packed is
// a TPU layout device with the same math). Per lattice cell and each of
// its 8 directions k:
//
//   e_new_k = LN(silu(e_k @ We + be + vs_k + pd) @ Wo + bo)
//   out_k   = e_new_k (+ e_k when residual)
//   agg     = sum_k e_new_k * mask_k          (always the raw e_new)
//
// What bounds it on the H100: at the GraphLAM level-0 lattice (125x125,
// h=64, fp32) the function must move ~105 MB (e, vs, out at 32 MB each)
// and do ~2 GFLOP, so the bytes (~31 us at 3.35 TB/s) and the fp32
// CUDA-core operations (~30 us at 67 TFLOP/s) weigh about the same.
//
// What the design does about it: every intermediate (the pre-activation,
// silu, the LayerNorm input and statistics) stays in registers, so
// device memory sees only the true inputs and outputs, each touched
// once; agg is summed in registers over the 8 directions, so there are
// no atomics. One warp owns P cells; both weight matrices sit in shared
// memory, and each weight read there feeds P cells. The products run on
// CUDA cores in fp32 through warp shuffles, which caps the kernel well
// below the fp32 peak: tensor-core (wgmma) and TMA versions are later
// work.

#include "warp_rows.cuh"

namespace {

using namespace p4t;

constexpr int WARPS = 8;

template <int J, int P>
__global__ void __launch_bounds__(WARPS * 32)
stencil_message_fwd(const float* __restrict__ e, const float* __restrict__ vs,
                    const float* __restrict__ pd, const float* __restrict__ mask,
                    const float* __restrict__ we, const float* __restrict__ be,
                    const float* __restrict__ wo, const float* __restrict__ bo,
                    const float* __restrict__ lns, const float* __restrict__ lnb,
                    float* __restrict__ out, float* __restrict__ agg_out,
                    int B, int HW, int F, int h, int residual) {
  constexpr int HP = 32 * J;
  extern __shared__ float smem[];
  float* s_we = smem;              // [F][HP]
  float* s_wo = s_we + F * HP;     // [h][HP]
  float* s_be = s_wo + h * HP;     // [HP] each below
  float* s_bo = s_be + HP;
  float* s_lns = s_bo + HP;
  float* s_lnb = s_lns + HP;
  stage<J>(s_we, we, F, h);
  stage<J>(s_wo, wo, h, h);
  stage<J>(s_be, be, 1, h);
  stage<J>(s_bo, bo, 1, h);
  stage<J>(s_lns, lns, 1, h);
  stage<J>(s_lnb, lnb, 1, h);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long n_cells = (long long)B * HW;
  const long long groups = (n_cells + P - 1) / P;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;

  for (long long g = warp0; g < groups; g += n_warps) {
    long long cell[P];
    bool valid[P];
    float pdr[P][J], agg[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cell[p] = g * P + p;
      valid[p] = cell[p] < n_cells;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        pdr[p][j] = (valid[p] && c < h) ? pd[cell[p] * h + c] : 0.f;
        agg[p][j] = 0.f;
      }
    }
    for (int k = 0; k < 8; ++k) {
      float ek[P][J], acc[P][J];
      long long row[P];  // (b, k, q) row index into the (B, 8, H, W, .) arrays
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long b = cell[p] / HW, q = cell[p] - b * HW;
        row[p] = (b * 8 + k) * HW + q;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          ek[p][j] = (valid[p] && c < F) ? e[row[p] * F + c] : 0.f;
          const float v = (valid[p] && c < h) ? vs[row[p] * h + c] : 0.f;
          acc[p][j] = s_be[c] + v + pdr[p][j];
        }
      }
      row_matmul<J, P>(ek, acc, s_we, F, lane);
      float z[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          z[p][j] = silu(acc[p][j]);
          acc[p][j] = s_bo[lane + 32 * j];
        }
      row_matmul<J, P>(z, acc, s_wo, h, lane);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        layer_norm<J>(acc[p], s_lns, s_lnb, h, lane);
        if (!valid[p]) continue;
        const long long b = cell[p] / HW, q = cell[p] - b * HW;
        const float m = mask[(long long)k * HW + q];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          if (c < h) {
            out[row[p] * h + c] = residual ? acc[p][j] + ek[p][j] : acc[p][j];
            agg[p][j] = fmaf(acc[p][j], m, agg[p][j]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (!valid[p]) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < h) agg_out[cell[p] * h + c] = agg[p][j];
      }
    }
  }
}

template <int J, int P>
cudaError_t launch(const float* e, const float* vs, const float* pd, const float* mask,
                   const float* we, const float* be, const float* wo, const float* bo,
                   const float* lns, const float* lnb, float* out, float* agg, int B,
                   int HW, int F, int h, int residual, cudaStream_t stream) {
  constexpr int HP = 32 * J;
  const size_t smem = (size_t)(F + h + 4) * HP * sizeof(float);
  auto kernel = stencil_message_fwd<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_for(kernel, WARPS * 32, smem, ((long long)B * HW + P - 1) / P, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, WARPS * 32, smem, stream>>>(e, vs, pd, mask, we, be, wo, bo, lns, lnb,
                                                out, agg, B, HW, F, h, residual);
  return cudaGetLastError();
}

}  // namespace

// C entry: (out, agg) = stencil message of (e, vs, pd, mask) on `stream`.
// e: (B, 8, H, W, F); vs, out: (B, 8, H, W, h); pd, agg: (B, H, W, h);
// mask: (8, H, W, 1); we: (F, h); wo: (h, h); be, bo, lns, lnb: (h,).
// All fp32, contiguous, on the current device; F, h <= 128 (the caller
// checks). Returns the cudaError_t of the launch.
extern "C" int p4t_stencil_message_fwd(const float* e, const float* vs, const float* pd,
                                       const float* mask, const float* we, const float* be,
                                       const float* wo, const float* bo, const float* lns,
                                       const float* lnb, float* out, float* agg, int B,
                                       int H, int W, int F, int h, int residual,
                                       void* stream) {
  const int J = ((F > h ? F : h) + 31) / 32;
  const int HW = H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (J) {
    case 1: return launch<1, 4>(e, vs, pd, mask, we, be, wo, bo, lns, lnb, out, agg, B, HW, F, h, residual, s);
    case 2: return launch<2, 4>(e, vs, pd, mask, we, be, wo, bo, lns, lnb, out, agg, B, HW, F, h, residual, s);
    case 3: return launch<3, 2>(e, vs, pd, mask, we, be, wo, bo, lns, lnb, out, agg, B, HW, F, h, residual, s);
    case 4: return launch<4, 2>(e, vs, pd, mask, we, be, wo, bo, lns, lnb, out, agg, B, HW, F, h, residual, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
