// The corner-hop steps that the forward (corner_hop.cu) and the backward's
// node pass (corner_hop_bwd.cu) share, on row_tiles.cuh's register
// micro-tiles: a thread's TM rows (grid cells) x 4 channels c0 .. c0+3.
//
//   pre_k = feats_k @ Wf + bf + psg_k + pd;  z_k = silu(pre_k)   (corner_pre)
//   agg  += LN(z_k @ Wo + bo) * lns + lnb                         (corner_into_agg)
//
// Both kernels stage Wf as [MAX_FF][HP] and the vectors as [8][HP] in
// the order bf, bo, lns, lnb, nb0, nb1, nlns, nlnb (stage_common).
#pragma once

#include "row_tiles.cuh"

namespace p4t {
namespace hop {

using namespace rt;

constexpr int MAX_FF = 32;  // corner features a kernel takes

__device__ __forceinline__ float sigmoid(float p) { return __frcp_rn(1.f + __expf(-p)); }

// Wf into s_wf [MAX_FF][HP] and the vectors (v0, ..., v7) into s_vec
// [8][HP], zero past ff and h and for a null vector.
template <int HP>
__device__ __forceinline__ void stage_common(float* s_wf, float* s_vec, const float* wf, int ff,
                                             int h, const float* v0, const float* v1,
                                             const float* v2, const float* v3, const float* v4,
                                             const float* v5, const float* v6, const float* v7) {
  for (int i = threadIdx.x; i < MAX_FF * HP; i += blockDim.x) {
    const int f = i / HP, c = i % HP;
    s_wf[i] = (f < ff && c < h) ? wf[f * h + c] : 0.f;
  }
  for (int i = threadIdx.x; i < 8 * HP; i += blockDim.x) {
    const int v = i / HP, c = i % HP;
    const float* src = v == 0 ? v0 : v == 1 ? v1 : v == 2 ? v2 : v == 3 ? v3 : v == 4 ? v4
                       : v == 5 ? v5 : v == 6 ? v6 : v7;
    s_vec[i] = (src != nullptr && c < h) ? src[c] : 0.f;
  }
}

// acc = silu(pre) and dsil = silu'(pre) for pre = feats_k @ Wf + bf +
// psg_k + pd; fe(i, f) is feature f of the thread's row i. (The forward
// leaves dsil unread, and the compiler drops it.)
template <int HP, int TM, typename Fe>
__device__ __forceinline__ void corner_pre(float (&acc)[TM][4], float (&dsil)[TM][4],
                                           const float (&ps)[TM][4], const float (&pd)[TM][4],
                                           Fe fe, const float* s_wf, const float* s_bf, int ff,
                                           int c0) {
  zero_tile<TM>(acc);
  for (int f = 0; f < ff; ++f) {
    float w[4];
    lds4(w, s_wf + f * HP + c0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float x = fe(i, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
    }
  }
  float bf[4];
  lds4(bf, s_bf + c0);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ((acc[i][j] + bf[j]) + ps[i][j]) + pd[i][j];
      const float sg = sigmoid(p);
      dsil[i][j] = sg * (1.f + p * (1.f - sg));
      acc[i][j] = p * sg;
    }
}

// agg += LN(z @ Wo + bo) * lns + lnb for the thread's rows of the shared
// [.][LD] z tile; s_vec as stage_common leaves it.
template <int HP, int TM, int LD = HP>
__device__ __forceinline__ void corner_into_agg(float (&agg)[TM][4], const float* s_z, int r0,
                                                const float* s_wo, const float* s_vec, int c0,
                                                int h) {
  float acc[TM][4];
  zero_tile<TM>(acc);
  tile_mm<HP, TM, LD>(acc, s_z, r0, s_wo, c0);
  float bo[4], lns[4], lnb[4];
  lds4(bo, s_vec + HP + c0);
  lds4(lns, s_vec + 2 * HP + c0);
  lds4(lnb, s_vec + 3 * HP + c0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += bo[j];
    ln_normalize4<HP / 4>(acc[i], c0, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) agg[i][j] += fmaf(acc[i][j], lns[j], lnb[j]);
  }
}

// Store the thread's rows of a (B*H*W, h) array, valid rows only.
template <int TM>
__device__ __forceinline__ void store_rows(float* base, const int (&cell)[TM],
                                           const bool (&valid)[TM], int c0, int h, bool vec,
                                           const float (&v)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
    if (valid[i]) store4(base + (long long)cell[i] * h, c0, h, vec, v[i]);
}

}  // namespace hop
}  // namespace p4t
