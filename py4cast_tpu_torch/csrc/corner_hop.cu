// Lattice mesh->grid corner hop (m2g), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel py4cast_tpu/ops/hop_kernel.py::_fwd_kernel
// (called through _fwd_call; its lane-packed twin _fwd_kernel_packed is
// a TPU layout device with the same math). Per grid cell:
//
//   pd    = vd @ Wd
//   t_k   = LN(silu(feats_k @ Wf + bf + psg_k + pd) @ Wo + bo)   k = 4 corners
//   agg   = sum_k t_k                    (/4 for mean aggregation)
//   u     = silu(vd @ Nd0a + agg @ Nd0b + nb0)
//   v_out = vd + LN(u @ Nd1 + nb1)
//
// The corner order is r0c0, r0c1, r1c0, r1c1, as build_graph_artifacts
// enumerates the surrounding-4 edges; the corner upsamples psg_k are
// built outside (separable selection matmuls) and arrive at width W.
//
// What bounds it on the H100: at the GraphLAM 500x500 grid (h=64, fp32)
// the function must move ~396 MB (four psg_k, vd and v_out, 64 MB each;
// ~118 us at 3.35 TB/s) and do ~16.5 GFLOP of fp32 products (~0.25 ms at
// the 67 TFLOP/s CUDA-core peak): it is compute-bound.
//
// What the design does about it: nothing grid-sized besides the true
// inputs and the output touches device memory (the silu and LayerNorm
// intermediates of all four corners, agg and the node-MLP hidden row
// live in registers), and the five h x h weight matrices (80 KB at
// h=64) sit in dynamic shared memory, where each weight read feeds P
// cells of the warp. The products run on CUDA cores in fp32 through warp
// shuffles, below the fp32 peak; tensor-core (wgmma) and TMA versions
// are later work.

#include "warp_rows.cuh"

namespace {

using namespace p4t;

constexpr int WARPS = 8;

struct HopParams {
  const float* psg[4];
  const float* vd;
  const float* feats;
  const float *wf, *bf, *wd, *wo, *bo, *lns, *lnb;
  const float *nd0a, *nd0b, *nb0, *nd1, *nb1, *nlns, *nlnb;
  float* out;
  int B, HW, h, ff, mean;
};

template <int J, int P>
__global__ void __launch_bounds__(WARPS * 32) corner_hop_fwd(HopParams a) {
  constexpr int HP = 32 * J;
  const int h = a.h, ff = a.ff, HW = a.HW;
  extern __shared__ float smem[];
  float* s_wd = smem;  // five [h][HP] matrices, then [ff][HP], then vectors
  float* s_wo = s_wd + h * HP;
  float* s_n0a = s_wo + h * HP;
  float* s_n0b = s_n0a + h * HP;
  float* s_n1 = s_n0b + h * HP;
  float* s_wf = s_n1 + h * HP;
  float* s_bf = s_wf + ff * HP;
  float* s_bo = s_bf + HP;
  float* s_lns = s_bo + HP;
  float* s_lnb = s_lns + HP;
  float* s_nb0 = s_lnb + HP;
  float* s_nb1 = s_nb0 + HP;
  float* s_nlns = s_nb1 + HP;
  float* s_nlnb = s_nlns + HP;
  stage<J>(s_wd, a.wd, h, h);
  stage<J>(s_wo, a.wo, h, h);
  stage<J>(s_n0a, a.nd0a, h, h);
  stage<J>(s_n0b, a.nd0b, h, h);
  stage<J>(s_n1, a.nd1, h, h);
  stage<J>(s_wf, a.wf, ff, h);
  stage<J>(s_bf, a.bf, 1, h);
  stage<J>(s_bo, a.bo, 1, h);
  stage<J>(s_lns, a.lns, 1, h);
  stage<J>(s_lnb, a.lnb, 1, h);
  stage<J>(s_nb0, a.nb0, 1, h);
  stage<J>(s_nb1, a.nb1, 1, h);
  stage<J>(s_nlns, a.nlns, 1, h);
  stage<J>(s_nlnb, a.nlnb, 1, h);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long n_cells = (long long)a.B * HW;
  const long long groups = (n_cells + P - 1) / P;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;

  for (long long g = warp0; g < groups; g += n_warps) {
    long long cell[P], q[P];
    bool valid[P];
    float vd[P][J], pd[P][J], agg[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cell[p] = g * P + p;
      valid[p] = cell[p] < n_cells;
      q[p] = valid[p] ? cell[p] % HW : 0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        vd[p][j] = (valid[p] && c < h) ? a.vd[cell[p] * h + c] : 0.f;
        pd[p][j] = 0.f;
        agg[p][j] = 0.f;
      }
    }
    row_matmul<J, P>(vd, pd, s_wd, h, lane);

    for (int k = 0; k < 4; ++k) {
      // a select, not a[k]: a runtime index into the parameter struct
      // would copy it to local memory
      const float* psg = k == 0 ? a.psg[0] : k == 1 ? a.psg[1] : k == 2 ? a.psg[2] : a.psg[3];
      float z[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* fe = a.feats + ((long long)k * HW + q[p]) * ff;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          float pf = 0.f;
          for (int i = 0; i < ff; ++i) pf = fmaf(fe[i], s_wf[i * HP + c], pf);
          const float s = (valid[p] && c < h) ? psg[cell[p] * h + c] : 0.f;
          z[p][j] = silu(pf + s_bf[c] + s + pd[p][j]);
        }
      }
      float t[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < J; ++j) t[p][j] = s_bo[lane + 32 * j];
      row_matmul<J, P>(z, t, s_wo, h, lane);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        layer_norm<J>(t[p], s_lns, s_lnb, h, lane);
#pragma unroll
        for (int j = 0; j < J; ++j) agg[p][j] += t[p][j];
      }
    }
    float u[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (a.mean) agg[p][j] *= 0.25f;
        u[p][j] = 0.f;
      }
    row_matmul<J, P>(vd, u, s_n0a, h, lane);
    row_matmul<J, P>(agg, u, s_n0b, h, lane);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        u[p][j] = silu(u[p][j] + s_nb0[lane + 32 * j]);
        agg[p][j] = s_nb1[lane + 32 * j];  // agg is spent: reuse it for y
      }
    row_matmul<J, P>(u, agg, s_n1, h, lane);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      layer_norm<J>(agg[p], s_nlns, s_nlnb, h, lane);
      if (!valid[p]) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < h) a.out[cell[p] * h + c] = vd[p][j] + agg[p][j];
      }
    }
  }
}

template <int J, int P>
cudaError_t launch(const HopParams& a, cudaStream_t stream) {
  constexpr int HP = 32 * J;
  const size_t smem = (size_t)(5 * a.h + a.ff + 8) * HP * sizeof(float);
  auto kernel = corner_hop_fwd<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_for(kernel, WARPS * 32, smem, ((long long)a.B * a.HW + P - 1) / P, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry: out = corner hop of (psg0..3, vd, feats) on `stream`.
// psg_k, vd, out: (B, H, W, h); feats: (4, H, W, ff); wf: (ff, h);
// wd, wo, nd0a, nd0b, nd1: (h, h); bf, bo, lns, lnb, nb0, nb1, nlns,
// nlnb: (h,). All fp32, contiguous, on the current device; h <= 96 (the
// weights must fit in shared memory) and ff <= 32 (the caller checks).
// Returns the cudaError_t of the launch.
extern "C" int p4t_corner_hop_fwd(const float* psg0, const float* psg1, const float* psg2,
                                  const float* psg3, const float* vd, const float* feats,
                                  const float* wf, const float* bf, const float* wd,
                                  const float* wo, const float* bo, const float* lns,
                                  const float* lnb, const float* nd0a, const float* nd0b,
                                  const float* nb0, const float* nd1, const float* nb1,
                                  const float* nlns, const float* nlnb, float* out, int B,
                                  int H, int W, int h, int ff, int mean, void* stream) {
  HopParams a{{psg0, psg1, psg2, psg3}, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
              nd0a, nd0b, nb0, nd1, nb1, nlns, nlnb, out, B, H * W, h, ff, mean};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((h + 31) / 32) {
    case 1: return launch<1, 4>(a, s);
    case 2: return launch<2, 4>(a, s);
    case 3: return launch<3, 2>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
