// Long-query / short-KV attention, forward (fp32):
//
//   o[r]   = softmax(q[r] . k^T * scale) . v        q (BH, Lq, D), k, v (BH, Lk, D)
//   lse[r] = logsumexp(q[r] . k^T * scale)          natural log, the backward's residual
//
// Replaces the TPU kernel py4cast_tpu/ops/attention.py::_fwd_kernel
// (reached from _forward, pl.pallas_call at :105). The TPU kernel keeps
// the whole K/V of a head in VMEM and takes the exact softmax over all Lk
// logits of a Q block at once. Here K/V stream through shared memory in
// tiles with an online softmax (running max and sum, the accumulator
// rescaled per tile), so shared memory does not cap Lk and the (Lq, Lk)
// logits never reach device memory.
//
// What bounds it on the H100: operations. Per query row and key it does
// 2D FMAs (the q.k dot and the p.v update) and one exp; the bytes are
// q, o (Lq x D), lse and k, v (Lk x D), read or written once. At
// Segformer's stage 1 (Lq 20,480, Lk 320, D 32) that is 0.84 GFLOP
// against 5.4 MB: ~12.5 us of fp32 FMA peak against ~1.6 us of memory.
//
// Design, for 132 SMs and the fp32 FMA units (the lanes' loads, dots,
// shuffles and the K/V ring are attention_tiles.cuh's, which the
// backward's dq pass shares). Shared memory delivers
// 128 bytes a cycle to an SM's registers, broadcast or not: a float of K
// or V that a lane reads there should feed several FMAs.
// - Lanes. A row's D channels are cut into T slices of C = 16 (T = 1, 2,
//   4 or 8 for D up to 16, 32, 64, 128); lane = t * (32/T) + rr holds
//   slice t of the R rows rr, rr + 32/T, ... of its warp, q and the
//   output accumulator in registers (2 * 16 * R floats). The T slices of
//   a row sit in one warp: their partial dots meet by butterfly
//   shuffles, which leave every slice the same sum.
// - Register tiles. Every float of K or V a lane reads feeds R FMAs (R
//   rows at once): at Segformer's D = 32 and R = 2 a key costs a lane 32
//   floats and 2 shuffles for 64 FMAs (one row a lane: 64 floats for 64).
//   R = 4 would need more than the 128 registers that keep 16 warps on
//   an SM. A warp's lanes of one slice read the same word (a broadcast);
//   slices are 20 floats apart in a key's row, so the T words of a read
//   fall in different banks. The logits are taken 8 / R keys at a time.
// - Key splits. A block is S warps over the same 32R/T rows; warp s
//   takes the s-th contiguous run of Lk's keys, keeps its own (max, sum,
//   accumulator), and the S splits meet in shared memory at the end,
//   merged by every thread of the block in split order, so a call
//   repeats bit for bit. The host picks R and S from (BH, Lq, Lk, D)
//   (ops/attention.py::fwd_launch_shape): R = 2 unless half the SMs
//   would get no block, S = 8 where the blocks are fewer than the SMs,
//   else 4 (R, S = 2, 4 at Segformer's stages 1-3, 2, 8 at stage 4).
// - Asynchronous tiles. K/V tiles land by cp.async in a ring of NST
//   stages, so stage i + 2 is in flight while stage i is consumed; one
//   __syncthreads a stage. Keys past Lk (and channels past D) are zero
//   filled, and a logit past Lk is -inf.
// - Base 2. q is scaled by scale * log2(e) once, so a logit's exp is one
//   exp2f; lse goes back to the natural log on the way out.
#include "attention_tiles.cuh"

namespace p4t {
namespace attn {

template <int T, int R, int S>
struct Shape {
  static constexpr int kT = T, kR = R, kS = S;
  static constexpr int LANE_ROWS = 32 / T;      // rows of one slice a warp holds
  static constexpr int BM = R * LANE_ROWS;      // rows a block
  static constexpr int THREADS = 32 * S;        // one warp a split
  static constexpr int KROW = CS * T;           // floats a key's row in shared memory
  static constexpr int STAGE = 2 * S * BK * KROW;  // K then V of one stage
  static constexpr int KS = BK / R;             // keys of one softmax update
  static constexpr int MROW = C * T + 4;        // a row of the merge's accumulators
  // blocks an SM the registers must allow. R = 2 fits 128 registers (16
  // warps an SM) without spills at T = 2 and 4; at T = 1 and 8 it spilled
  // there, so those get 3 blocks of 4 warps (up to 168 registers) or 1
  // of 8.
  // R = 1 runs only on grids of fewer blocks than SMs (fwd_launch_shape):
  // one block an SM is all it needs.
  static constexpr int MIN_BLOCKS = R == 1 ? 1 : (T == 1 || T == 8) ? (S == 4 ? 3 : 1) : 16 / S;
  static constexpr size_t ring = (size_t)NST * STAGE;
  static constexpr size_t merge = (size_t)S * BM * MROW + 2 * S * BM;
  static constexpr size_t smem_bytes = sizeof(float) * (ring > merge ? ring : merge);
};

// registers as Shape::MIN_BLOCKS allows (R = 4 did not fit 168)
template <int T, int R, int S>
__global__ void __launch_bounds__(32 * S, (Shape<T, R, S>::MIN_BLOCKS))
    short_kv_attention_fwd(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int lq, int lk, int d, float scale) {
  using Sh = Shape<T, R, S>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int bh = blockIdx.y, row0 = blockIdx.x * Sh::BM;
  const int lane = threadIdx.x % 32, sp = threadIdx.x / 32;
  const int t = lane / Sh::LANE_ROWS, rr = lane % Sh::LANE_ROWS;
  const float* kb = k + (long long)bh * lk * d;
  const float* vb = v + (long long)bh * lk * d;
  // split sp's keys: [sp * chunk, (sp + 1) * chunk), chunk a multiple of BK
  const int chunk = BK * ((((lk + BK - 1) / BK) + S - 1) / S);
  const int tiles = chunk / BK;

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < tiles) load_kv_stage<T, S>(smem + i * Sh::STAGE, kb, vb, i, chunk, lk, d, Sh::THREADS);
    cp_async_commit();
  }

  // q, in base-2 logit units; channels past D and rows past Lq are 0
  const float qs = scale * LOG2E;
  float x[R][C], acc[R][C], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    load_row_slice<T>(x[r], q + (long long)bh * lq * d, row0 + r * Sh::LANE_ROWS + rr, lq, d, t,
                      qs);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  const int key_base = sp * chunk;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage i landed for all; stage i - 1 is free
    if (i + NST - 1 < tiles)
      load_kv_stage<T, S>(smem + ((i + NST - 1) % NST) * Sh::STAGE, kb, vb, i + NST - 1, chunk,
                          lk, d, Sh::THREADS);
    cp_async_commit();

    const int n = min(BK, lk - (key_base + i * BK));  // this split's keys in the stage
    const float* ks = smem + (i % NST) * Sh::STAGE + sp * BK * Sh::KROW + t * CS;
    const float* vs = ks + S * BK * Sh::KROW;
    // KS keys at a time, so that the logits of R rows stay few registers;
    // n is the same in the whole warp (one warp a split)
#pragma unroll
    for (int h = 0; h < BK; h += Sh::KS) {
      if (h >= n) break;
      float s[R][Sh::KS] = {};
      slice_dots(s, x, ks + h * Sh::KROW, Sh::KROW);
#pragma unroll
      for (int r = 0; r < R; ++r) slice_sum<T>(s[r]);  // the same sum in every slice

#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mt = m[r];
#pragma unroll
        for (int j = 0; j < Sh::KS; ++j) {
          s[r][j] = h + j < n ? s[r][j] : -INFINITY;
          mt = fmaxf(mt, s[r][j]);
        }
        const float alpha = exp2f(m[r] - mt);  // 0 on the split's first keys (m = -inf)
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
        m[r] = mt;
#pragma unroll
        for (int j = 0; j < Sh::KS; ++j) {
          s[r][j] = exp2f(s[r][j] - m[r]);
          l[r] += s[r][j];
        }
      }

      slice_axpy(acc, s, vs + h * Sh::KROW, Sh::KROW);
    }
  }

  // the merge: every split's (max, sum, accumulator) into shared memory;
  // a split that saw no key has m = -inf, l = 0, acc = 0 and weighs 0
  cp_async_wait<0>();
  __syncthreads();  // every split is done with the ring: it is reused
  float* accs = smem;                           // [S][BM][MROW]
  float* ms = accs + S * Sh::BM * Sh::MROW;     // [S][BM]
  float* ws = ms + S * Sh::BM;                  // [S][BM]: the rows' weights
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int br = r * Sh::LANE_ROWS + rr;
    float* dst = accs + (sp * Sh::BM + br) * Sh::MROW + t * C;
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4)
      reinterpret_cast<float4*>(dst)[c4] =
          make_float4(acc[r][4 * c4], acc[r][4 * c4 + 1], acc[r][4 * c4 + 2], acc[r][4 * c4 + 3]);
    if (t == 0) {
      ms[sp * Sh::BM + br] = m[r];
      ws[sp * Sh::BM + br] = l[r];
    }
  }
  __syncthreads();

  // per row: the max over splits, each split's weight exp2(m_s - m) / l,
  // and lse; all in split order
  const int rows = min(Sh::BM, lq - row0);
  for (int br = threadIdx.x; br < rows; br += Sh::THREADS) {
    float mx = ms[br];
#pragma unroll
    for (int u = 1; u < S; ++u) mx = fmaxf(mx, ms[u * Sh::BM + br]);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < S; ++u) {  // ms[u] becomes split u's weight exp2(m_u - m)
      ms[u * Sh::BM + br] = exp2f(ms[u * Sh::BM + br] - mx);
      sum += ws[u * Sh::BM + br] * ms[u * Sh::BM + br];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int u = 0; u < S; ++u) ws[u * Sh::BM + br] = ms[u * Sh::BM + br] * inv;
    lse[(long long)bh * lq + row0 + br] = (mx + log2f(sum)) * LN2;
  }
  __syncthreads();

  // o: the block's rows are contiguous in o, so consecutive threads write
  // consecutive channels
  float* ob = o + ((long long)bh * lq + row0) * d;
  for (int e = threadIdx.x; e < rows * d; e += Sh::THREADS) {
    const int br = e / d, ch = e % d;
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < S; ++u) a += accs[(u * Sh::BM + br) * Sh::MROW + ch] * ws[u * Sh::BM + br];
    ob[e] = a;
  }
}

template <int T, int R, int S>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
                   int lq, int lk, int d, float scale, cudaStream_t stream) {
  using Sh = Shape<T, R, S>;
  const cudaError_t err = cudaFuncSetAttribute(
      short_kv_attention_fwd<T, R, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Sh::smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + Sh::BM - 1) / Sh::BM, bh);
  short_kv_attention_fwd<T, R, S>
      <<<grid, Sh::THREADS, Sh::smem_bytes, stream>>>(q, k, v, o, lse, lq, lk, d, scale);
  return cudaGetLastError();
}

// The kernel's registers, local (spill) bytes, dynamic shared memory and
// resident blocks an SM.
template <int T, int R, int S>
cudaError_t attributes(int* out) {
  using Sh = Shape<T, R, S>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncSetAttribute(short_kv_attention_fwd<T, R, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Sh::smem_bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, short_kv_attention_fwd<T, R, S>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, short_kv_attention_fwd<T, R, S>,
                                                        Sh::THREADS, Sh::smem_bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)Sh::smem_bytes;
  out[3] = blocks;
  return cudaSuccess;
}

// The launch shapes the host may ask for: (R, S) in {(2, 4), (2, 8),
// (1, 4), (1, 8)}, with S * T <= 32 (the ring's shared memory).
template <int T, typename F>
cudaError_t dispatch_slices(int rows, int splits, F&& f) {
  if (rows == 2 && splits == 4) return f(Shape<T, 2, 4>{});
  if (rows == 1 && splits == 4) return f(Shape<T, 1, 4>{});
  if constexpr (T <= 4) {
    if (rows == 2 && splits == 8) return f(Shape<T, 2, 8>{});
    if (rows == 1 && splits == 8) return f(Shape<T, 1, 8>{});
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t dispatch(int d, int rows, int splits, F&& f) {
  if (d < 1 || d > 8 * C) return cudaErrorInvalidValue;
  if (d <= C) return dispatch_slices<1>(rows, splits, f);
  if (d <= 2 * C) return dispatch_slices<2>(rows, splits, f);
  if (d <= 4 * C) return dispatch_slices<4>(rows, splits, f);
  return dispatch_slices<8>(rows, splits, f);
}

}  // namespace attn
}  // namespace p4t

// rows: R, the query rows a thread; splits: S, the key splits (warps) a
// block; both from ops/attention.py::fwd_launch_shape
extern "C" int p4t_short_kv_attention_fwd(const float* q, const float* k, const float* v,
                                          float* o, float* lse, int bh, int lq, int lk, int d,
                                          float scale, int rows, int splits, void* stream) {
  using namespace p4t::attn;
  if (bh < 1 || lq < 1 || lk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(d, rows, splits, [&](auto sh) {
    using Sh = decltype(sh);
    return launch<Sh::kT, Sh::kR, Sh::kS>(q, k, v, o, lse, bh, lq, lk, d, scale, st);
  });
}

// out[4]: registers a thread, local bytes a thread (spills), dynamic
// shared memory bytes, resident blocks an SM, of the kernel that
// p4t_short_kv_attention_fwd launches for (d, rows, splits)
extern "C" int p4t_short_kv_attention_fwd_attributes(int d, int rows, int splits, int* out) {
  using namespace p4t::attn;
  return (int)dispatch(d, rows, splits, [&](auto sh) {
    using Sh = decltype(sh);
    return attributes<Sh::kT, Sh::kR, Sh::kS>(out);
  });
}
