// Building blocks of the short-KV attention backward kernel
// (short_kv_attention_bwd.cu; the forward has its own layout).
//
// A block owns BQ = 64 query rows of one head and runs THREADS = 256
// threads: every row has T = ceil(D/32) channel slices of C = 32
// channels and S = 4 / T key splits. Thread (split s, slice t, row r) is
// threadIdx.x = (s * T + t) * BQ + r, so a warp holds 32 rows of one
// slice and one split: all its lanes read the same K/V words from shared
// memory (float4 broadcasts, free of bank conflicts). K/V stream through
// shared memory S * BK keys at a time; split s takes the s-th BK-key
// tile of each such group. The splits give Segformer's head dim 32
// (T = 1) four times the warps a row-per-thread design would have; the
// slices let D reach 128 with 32 channels a thread. The kernel picks its
// own BK (the tile's keys): at 16 it spilled its per-key values.
#pragma once

#include "warp_rows.cuh"

#include <math.h>

namespace p4t {
namespace attn {

constexpr int BQ = 64;        // query rows a block
constexpr int C = 32;         // channels a thread holds
constexpr int THREADS = 256;  // BQ * T * S

// Copy keys [j0, j0 + S * BK) of a (Lk, D) matrix into shared
// [S][BK][32T] (split s's tile is keys j0 + s*BK ...), zero past Lk and
// past D. Coalesced: consecutive threads, consecutive channels.
template <int T, int S, int BK>
__device__ __forceinline__ void stage_tiles(float* __restrict__ dst,
                                            const float* __restrict__ src, int j0, int lk,
                                            int d) {
  constexpr int DP = C * T;
  for (int e = threadIdx.x; e < S * BK * DP; e += THREADS) {
    const int j = e / DP, c = e % DP;
    dst[e] = (j0 + j < lk && c < d) ? src[(long long)(j0 + j) * d + c] : 0.f;
  }
}

// s[j] = x . tile[j][t*C .. t*C + C) for the BK keys of a tile, with x
// read from shared memory four channels at a time, so that x needs no
// registers across the tile: the same products in the same order
// (channel 0 first) for every s[j].
template <int T, int BK>
__device__ __forceinline__ void tile_dots_shared(const float* __restrict__ x,
                                                 const float* __restrict__ tile, int t,
                                                 float (&s)[BK]) {
  constexpr int DP = C * T;
#pragma unroll
  for (int j = 0; j < BK; ++j) s[j] = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < C / 4; ++c4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + t * C + 4 * c4);
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(tile + j * DP + t * C + 4 * c4);
      s[j] = fmaf(xv.x, w.x, s[j]);
      s[j] = fmaf(xv.y, w.y, s[j]);
      s[j] = fmaf(xv.z, w.z, s[j]);
      s[j] = fmaf(xv.w, w.w, s[j]);
    }
  }
}

// acc[c] += sum_j p[j] * tile[j][t*C + c].
template <int T, int BK>
__device__ __forceinline__ void tile_axpy(const float (&p)[BK], const float* __restrict__ tile,
                                          int t, float (&acc)[C]) {
  constexpr int DP = C * T;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const float4* row = reinterpret_cast<const float4*>(tile + j * DP + t * C);
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 w = row[c4];
      acc[4 * c4] = fmaf(p[j], w.x, acc[4 * c4]);
      acc[4 * c4 + 1] = fmaf(p[j], w.y, acc[4 * c4 + 1]);
      acc[4 * c4 + 2] = fmaf(p[j], w.z, acc[4 * c4 + 2]);
      acc[4 * c4 + 3] = fmaf(p[j], w.w, acc[4 * c4 + 3]);
    }
  }
}

// With T > 1: every slice of a row replaces its partial s[j] by the sum
// over the row's T slices, added in slice order, so the T threads of a
// row hold bit-identical values. red: shared [T][BK][BQ] of the thread's
// split. Every thread of the block must call it (it syncs); the caller
// syncs again before the next write to red.
template <int T, int BK>
__device__ __forceinline__ void slice_sum(float (&s)[BK], float* __restrict__ red, int t,
                                          int rl) {
  if (T == 1) return;
#pragma unroll
  for (int j = 0; j < BK; ++j) red[(t * BK + j) * BQ + rl] = s[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < T; ++u) a += red[(u * BK + j) * BQ + rl];
    s[j] = a;
  }
}

}  // namespace attn
}  // namespace p4t
