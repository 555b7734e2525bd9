// Building blocks of the short-KV attention kernels: the forward
// (short_kv_attention.cu) and the backward's query-major dq pass
// (short_kv_attention_bwd.cu) hold query rows in registers and stream K
// and V through a ring of shared-memory stages filled by cp.async; the
// backward's key-major dK/dV pass streams query rows the same way.
//
// Lanes. A row's D channels are cut into T slices of C = 16 (T = 1, 2, 4
// or 8 for D up to 16, 32, 64, 128); lane = t * (32/T) + rr holds slice
// t of its warp's rows rr, rr + 32/T, ... The T slices of a row sit in
// one warp, so their partial dots meet by butterfly shuffles, which
// leave every slice the same sum. A key's row sits in shared memory with
// its slices CS = 20 floats apart, so the T words a warp reads at once
// fall in different banks.
#pragma once

#include "warp_rows.cuh"

#include <math.h>
#include <stdint.h>

namespace p4t {
namespace attn {

constexpr int C = 16;    // channels of a slice (a lane holds one slice of a row)
constexpr int CS = 20;   // a slice's stride in a shared K/V row (bank spread)
constexpr int BK = 8;    // keys a split takes from one stage
constexpr int NST = 3;   // stages in the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, or a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Queue stage i of every split of a block of `threads` threads: split
// s's keys s*chunk + i*BK + [0, BK) of K and V into buf as
// [K|V][S][BK][CS * T] (slice t at t*CS, its last four floats unused).
// Keys past Lk and channels past D are zero.
template <int T, int S>
__device__ __forceinline__ void load_kv_stage(float* __restrict__ buf,
                                              const float* __restrict__ kb,
                                              const float* __restrict__ vb, int i, int chunk,
                                              int lk, int d, int threads) {
  constexpr int KROW = CS * T;
  if ((d & 3) == 0) {  // rows of 16-byte words: one cp.async a word
    constexpr int WORDS = C / 4 * T;  // a key's words, padding past D included
    for (int e = threadIdx.x; e < 2 * S * BK * WORDS; e += threads) {
      const int kv = e / (S * BK * WORDS), rest = e % (S * BK * WORDS);
      const int s = rest / (BK * WORDS), j = (rest / WORDS) % BK, w = rest % WORDS;
      const int key = s * chunk + i * BK + j, ch = 4 * w;
      const bool valid = key < lk && ch < d;
      const float* src = (kv ? vb : kb) + (valid ? (long long)key * d + ch : 0);
      cp_async16(buf + kv * (S * BK * KROW) + (s * BK + j) * KROW + (ch / C) * CS + ch % C, src,
                 valid);
    }
  } else {  // any D: one cp.async a float
    constexpr int CH = C * T;
    for (int e = threadIdx.x; e < 2 * S * BK * CH; e += threads) {
      const int kv = e / (S * BK * CH), rest = e % (S * BK * CH);
      const int s = rest / (BK * CH), j = (rest / CH) % BK, ch = rest % CH;
      const int key = s * chunk + i * BK + j;
      const bool valid = key < lk && ch < d;
      const float* src = (kv ? vb : kb) + (valid ? (long long)key * d + ch : 0);
      cp_async4(buf + kv * (S * BK * KROW) + (s * BK + j) * KROW + (ch / C) * CS + ch % C, src,
                valid);
    }
  }
}

// x[r][0..C) = slice t of row `row` of a (rows, d) matrix times mul;
// zero past D and for a row past `rows`.
template <int T>
__device__ __forceinline__ void load_row_slice(float (&x)[C], const float* __restrict__ m,
                                               int row, int rows, int d, int t, float mul) {
  const float* p = m + (long long)min(row, rows - 1) * d + t * C;
  if ((d & 3) == 0) {  // 16-byte loads
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 w = (row < rows && t * C + 4 * c4 < d) ? reinterpret_cast<const float4*>(p)[c4]
                                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * c4] = w.x * mul;
      x[4 * c4 + 1] = w.y * mul;
      x[4 * c4 + 2] = w.z * mul;
      x[4 * c4 + 3] = w.w * mul;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = (row < rows && t * C + c < d) ? p[c] * mul : 0.f;
  }
}

// Every lane's s[...] replaced by the sum over the T slices of its row
// (a butterfly across the warp's slices: the same bits in every slice).
template <int T, int N>
__device__ __forceinline__ void slice_sum(float (&s)[N]) {
  if (T == 1) return;
#pragma unroll
  for (int off = 32 / T; off < 32; off *= 2)
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] += __shfl_xor_sync(FULL, s[j], off);
}

// s[j] += x . tile row j (a slice of C channels, 16-byte aligned), for N
// rows of a shared tile `ld` floats apart; the same order (channel 0
// first) for every j.
template <int R, int N>
__device__ __forceinline__ void slice_dots(float (&s)[R][N], const float (&x)[R][C],
                                           const float* __restrict__ tile, int ld) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 w = *reinterpret_cast<const float4*>(tile + j * ld + 4 * c4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][j] = fmaf(x[r][4 * c4], w.x, s[r][j]);
        s[r][j] = fmaf(x[r][4 * c4 + 1], w.y, s[r][j]);
        s[r][j] = fmaf(x[r][4 * c4 + 2], w.z, s[r][j]);
        s[r][j] = fmaf(x[r][4 * c4 + 3], w.w, s[r][j]);
      }
    }
  }
}

// acc[r][c] += sum_j p[r][j] * tile row j [c], rows `ld` floats apart.
template <int R, int N>
__device__ __forceinline__ void slice_axpy(float (&acc)[R][C], const float (&p)[R][N],
                                           const float* __restrict__ tile, int ld) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float4 w = *reinterpret_cast<const float4*>(tile + j * ld + 4 * c4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][4 * c4] = fmaf(p[r][j], w.x, acc[r][4 * c4]);
        acc[r][4 * c4 + 1] = fmaf(p[r][j], w.y, acc[r][4 * c4 + 1]);
        acc[r][4 * c4 + 2] = fmaf(p[r][j], w.z, acc[r][4 * c4 + 2]);
        acc[r][4 * c4 + 3] = fmaf(p[r][j], w.w, acc[r][4 * c4 + 3]);
      }
    }
  }
}

}  // namespace attn
}  // namespace p4t
