// Long-query / short-KV attention, forward (fp32):
//
//   o[r]   = softmax(q[r] . k^T * scale) . v        q (BH, Lq, D), k, v (BH, Lk, D)
//   lse[r] = logsumexp(q[r] . k^T * scale)          the backward's residual
//
// Replaces the TPU kernel py4cast_tpu/ops/attention.py::_fwd_kernel
// (reached from _forward, pl.pallas_call at :105). The TPU kernel keeps
// the whole K/V of a head in VMEM and takes the exact softmax over all Lk
// logits of a Q block at once. Here a block owns 64 query rows of one
// head and streams K/V through shared memory in tiles with an online
// softmax (running max and sum, the accumulator rescaled per tile), so
// shared memory does not cap Lk and the (Lq, Lk) logits never reach
// device memory.
//
// What bounds it on the H100: operations. Per query row and key it does
// 2D FMAs (the q.k dot and the p.v update) and one exp; the bytes are
// q, o (Lq x D), lse and k, v (Lk x D), read or written once. At
// Segformer's stage 1 (Lq 20,480, Lk 320, D 32) that is 0.84 GFLOP
// against 5.4 MB: ~12.5 us of fp32 FMA peak against ~1.6 us of memory.
//
// Design (attention_tiles.cuh): a thread owns one query row's slice of
// 32 channels, q and the output accumulator in registers, for one of S
// key splits. Each split keeps its own running max, sum and accumulator
// over its tiles; at the end the S splits of a row meet in shared memory
// and split 0 merges them in split order (each rescaled by exp(m_s - m)),
// so a call repeats bit for bit. Keys past Lk get a logit of -inf; a
// split with no key left skips the update.
#include "attention_tiles.cuh"

namespace p4t {
namespace attn {

constexpr int BK = 16;  // keys a split's shared-memory tile

template <int T>
constexpr size_t fwd_smem_bytes() {
  constexpr int S = THREADS / (BQ * T), DP = C * T;
  constexpr size_t loop = 2 * S * BK * DP + (T > 1 ? S * T * BK * BQ : 0);
  constexpr size_t merge = S > 1 ? S * T * C * BQ + 2 * S * BQ : 0;
  return sizeof(float) * (loop > merge ? loop : merge);
}

template <int T>
__global__ void __launch_bounds__(THREADS, 2)
    short_kv_attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int lq, int lk, int d, float scale) {
  constexpr int S = THREADS / (BQ * T), DP = C * T;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [S][BK][DP]
  float* vs = ks + S * BK * DP;                 // [S][BK][DP]
  float* red = vs + S * BK * DP;                // [S][T][BK][BQ], only T > 1

  const int bh = blockIdx.y;
  const int rl = threadIdx.x % BQ, t = (threadIdx.x / BQ) % T, sp = threadIdx.x / (BQ * T);
  const int row = blockIdx.x * BQ + rl;
  const bool live = row < lq;
  const long long qoff = ((long long)bh * lq + (live ? row : 0)) * d;
  const float* kb = k + (long long)bh * lk * d;
  const float* vb = v + (long long)bh * lk * d;

  float x[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ch = t * C + c;
    x[c] = (live && ch < d) ? q[qoff + ch] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < lk; j0 += S * BK) {
    __syncthreads();  // the previous tiles' readers are done
    stage_tiles<T, S, BK>(ks, kb, j0, lk, d);
    stage_tiles<T, S, BK>(vs, vb, j0, lk, d);
    __syncthreads();

    float s[BK];
    tile_dots<T, BK>(x, ks + sp * BK * DP, t, s);
    slice_sum<T, BK>(s, red + sp * T * BK * BQ, t, rl);

    const int n = min(BK, lk - j0 - sp * BK);  // this split's keys in the tile
    if (n > 0) {
      float mt = m;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] = j < n ? s[j] * scale : -INFINITY;
        mt = fmaxf(mt, s[j]);
      }
      const float alpha = expf(m - mt);  // 0 on the split's first tile (m = -inf)
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] = expf(s[j] - mt);
        ps += s[j];
      }
      l = l * alpha + ps;
      m = mt;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] *= alpha;
      tile_axpy<T, BK>(s, vs + sp * BK * DP, t, acc);
    }
  }

  if (S > 1) {
    // merge the row's splits in split order; a split that saw no key
    // has m = -inf, l = 0 and a zero accumulator, and weighs 0
    __syncthreads();  // done with the tiles: shared memory is reused
    float* accs = reinterpret_cast<float*>(smem4);  // [S][T][C][BQ]
    float* ms = accs + S * T * C * BQ;              // [S][BQ]
    float* ls = ms + S * BQ;                        // [S][BQ]
#pragma unroll
    for (int c = 0; c < C; ++c) accs[((sp * T + t) * C + c) * BQ + rl] = acc[c];
    if (t == 0) {
      ms[sp * BQ + rl] = m;
      ls[sp * BQ + rl] = l;
    }
    __syncthreads();
    if (sp != 0) return;
    m = ms[rl];
#pragma unroll
    for (int u = 1; u < S; ++u) m = fmaxf(m, ms[u * BQ + rl]);
    float w[S];
    l = 0.f;
#pragma unroll
    for (int u = 0; u < S; ++u) {
      w[u] = expf(ms[u * BQ + rl] - m);
      l += ls[u * BQ + rl] * w[u];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float a = 0.f;
#pragma unroll
      for (int u = 0; u < S; ++u) a += accs[((u * T + t) * C + c) * BQ + rl] * w[u];
      acc[c] = a;
    }
  }

  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ch = t * C + c;
      if (ch < d) o[qoff + ch] = acc[c] * inv;
    }
    if (t == 0) lse[(long long)bh * lq + row] = m + logf(l);
  }
}

template <int T>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                       int bh, int lq, int lk, int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(short_kv_attention_fwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + BQ - 1) / BQ, bh);
  short_kv_attention_fwd<T><<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, lq, lk, d, scale);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace p4t

extern "C" int p4t_short_kv_attention_fwd(const float* q, const float* k, const float* v,
                                          float* o, float* lse, int bh, int lq, int lk, int d,
                                          float scale, void* stream) {
  using namespace p4t::attn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || lq < 1 || lk < 1 || d < 1 || d > 4 * C) return (int)cudaErrorInvalidValue;
  if (d <= C) return (int)launch_fwd<1>(q, k, v, o, lse, bh, lq, lk, d, scale, s);
  if (d <= 2 * C) return (int)launch_fwd<2>(q, k, v, o, lse, bh, lq, lk, d, scale, s);
  return (int)launch_fwd<4>(q, k, v, o, lse, bh, lq, lk, d, scale, s);
}
