// Long-query / short-KV attention, backward (fp32): for the cotangent dO
// of o = softmax(q . k^T * scale) . v,
//
//   P  = exp(q . k^T * scale - lse)             (recomputed, lse from the forward)
//   dP = dO . v^T
//   dS = P o (dP - delta),  delta = rowsum(dO o o) = rowsum(dP o P)
//   dq = scale * dS . k;   dk = scale * dS^T . q;   dv = P^T . dO
//
// Replaces the TPU kernel py4cast_tpu/ops/attention.py::_bwd_kernel
// (reached from _bwd_rule, pl.pallas_call at :136), which writes dQ per
// Q block and adds dK, dV into one output block across the TPU's
// sequential grid. Hopper's blocks run in no order, so here each block
// owns a chunk of query rows of one head (64 rows, or a multiple when
// the partials would pass 64 MB) and writes one fp32 partial of dK and
// dV for it; a second kernel (warp_rows.cuh::sum_partials) adds the
// partials in chunk order. No atomics: a call repeats bit for bit.
//
// What bounds it on the H100: operations, ~10 D + 10 a query row and
// key (the q.k and dO.v dots, the dq, dk and dv updates, exp and the dS
// formula), against the bytes of q, o, dO, dq (Lq x D), lse and k, v,
// dk, dv (Lk x D) plus the partials' write and read. At Segformer's
// stage 1 that is 2.1 GFLOP: ~31 us of fp32 peak.
//
// Design (attention_tiles.cuh, as the forward): a thread owns a query
// row's slice of 32 channels for one of S key splits; q and dO rows sit
// in shared memory (read four channels at a time, so the two dots keep
// only their BK sums in registers), the split's dq partial in registers.
// Per group of tiles each split writes P and scale * dS of its 64 rows
// for its 8 keys into shared memory; then its 64T threads each own one
// channel of dk and dv and 4 of the tile's keys, and sum dS^T q and
// P^T dO over the 64 rows. Every shared-memory read in that product is
// a broadcast or consecutive in the lanes. At the end the S dq partials
// of a row are added in split order. Rows past Lq get zero q and dO and
// an lse of +inf, so P and dS vanish there.
#include "attention_tiles.cuh"

namespace p4t {
namespace attn {

constexpr int BK = 8;        // keys a split's shared-memory tile
constexpr int PLD = BK + 4;  // row stride of the P and dS tiles
constexpr int KH = BK * C / BQ;  // keys of a tile a thread sums dk and dv for

template <int T>
constexpr size_t bwd_smem_bytes() {
  constexpr int S = THREADS / (BQ * T), DP = C * T;
  return sizeof(float) *
         (2 * S * BK * DP + 2 * BQ * (DP + 4) + 2 * S * BQ * PLD + (T > 1 ? 2 * S * T * BK * BQ : 0));
}

// At most 255 registers a thread (one block of 256 an SM by registers):
// capped at 128 for two blocks, the kernel spills.
template <int T>
__global__ void __launch_bounds__(THREADS, 1)
    short_kv_attention_bwd(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ o,
                           const float* __restrict__ lse, const float* __restrict__ dout,
                           float* __restrict__ dq, float* __restrict__ partial, int n_bh, int lq,
                           int lk, int d, int chunk_rows, float scale) {
  constexpr int S = THREADS / (BQ * T), DP = C * T;
  constexpr int QLD = DP + 4;  // row stride of the q and dO tiles
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [S][BK][DP]
  float* vs = ks + S * BK * DP;                 // [S][BK][DP]
  float* qs = vs + S * BK * DP;                 // [BQ][QLD]
  float* gs = qs + BQ * QLD;                    // [BQ][QLD]
  float* ps = gs + BQ * QLD;                    // [S][BQ][PLD]
  float* dss = ps + S * BQ * PLD;               // [S][BQ][PLD]
  float* red = dss + S * BQ * PLD;              // [S][2][T][BK][BQ], only T > 1

  const int chunk = blockIdx.x, bh = blockIdx.y;
  const int rl = threadIdx.x % BQ, t = (threadIdx.x / BQ) % T, sp = threadIdx.x / (BQ * T);
  // the dk/dv product: one channel and KH keys of the split's tile
  const int li = threadIdx.x % (BQ * T);
  const int cc = li % DP, jh = li / DP;
  const float* kb = k + (long long)bh * lk * d;
  const float* vb = v + (long long)bh * lk * d;
  const long long head = (long long)bh * lq;
  const long long kv_size = (long long)n_bh * lk * d;
  float* pk = partial + (2LL * chunk * n_bh + bh) * lk * d;  // this chunk's dk partial
  float* pv = pk + kv_size;                                   // and its dv partial
  float* sred = red + sp * 2 * T * BK * BQ;
  float* sps = ps + sp * BQ * PLD;
  float* sdss = dss + sp * BQ * PLD;

  for (int sub = 0; sub * BQ < chunk_rows; ++sub) {
    const int r0 = chunk * chunk_rows + sub * BQ;
    if (r0 >= lq) break;
    __syncthreads();  // the previous sub-tile's readers are done
    for (int e = threadIdx.x; e < BQ * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      const bool in = r0 + r < lq && c < d;
      const long long off = (head + r0 + r) * d + c;
      qs[r * QLD + c] = in ? q[off] : 0.f;
      gs[r * QLD + c] = in ? dout[off] : 0.f;
    }
    __syncthreads();

    const int row = r0 + rl;
    const bool live = row < lq;
    const int rows = min(BQ, lq - r0);
    // delta over the whole row, in one order for every thread of the row
    float delta = 0.f;
    if (live)
      for (int ch = 0; ch < d; ++ch)
        delta = fmaf(gs[rl * QLD + ch], o[(head + row) * d + ch], delta);
    const float row_lse = live ? lse[head + row] : INFINITY;
    float acc[C];  // this split's dq / scale
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;

    for (int j0 = 0; j0 < lk; j0 += S * BK) {
      __syncthreads();  // the previous tiles' readers are done
      stage_tiles<T, S, BK>(ks, kb, j0, lk, d);
      stage_tiles<T, S, BK>(vs, vb, j0, lk, d);
      __syncthreads();

      const float* sks = ks + sp * BK * DP;
      float s[BK], dp[BK];
      tile_dots_shared<T, BK>(qs + rl * QLD, sks, t, s);
      tile_dots_shared<T, BK>(gs + rl * QLD, vs + sp * BK * DP, t, dp);
      slice_sum<T, BK>(s, sred, t, rl);
      slice_sum<T, BK>(dp, sred + T * BK * BQ, t, rl);

      const int jt = j0 + sp * BK;  // the split's first key
      const int n = min(BK, lk - jt);
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = j < n ? expf(s[j] * scale - row_lse) : 0.f;
        s[j] = p;
        dp[j] = p * (dp[j] - delta);  // dS
      }
      tile_axpy<T, BK>(dp, sks, t, acc);  // dq += dS . k
      if (t == 0) {
#pragma unroll
        for (int j4 = 0; j4 < BK / 4; ++j4) {
          *reinterpret_cast<float4*>(sps + rl * PLD + 4 * j4) =
              make_float4(s[4 * j4], s[4 * j4 + 1], s[4 * j4 + 2], s[4 * j4 + 3]);
          *reinterpret_cast<float4*>(sdss + rl * PLD + 4 * j4) =
              make_float4(scale * dp[4 * j4], scale * dp[4 * j4 + 1], scale * dp[4 * j4 + 2],
                          scale * dp[4 * j4 + 3]);
        }
      }
      __syncthreads();

      // dk[j][cc] += sum_r scale dS[r][j] q[r][cc];  dv[j][cc] += sum_r P[r][j] dO[r][cc]
      if (n > jh * KH) {
        float ak[KH], av[KH];
#pragma unroll
        for (int jj = 0; jj < KH; ++jj) ak[jj] = av[jj] = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float qv = qs[r * QLD + cc], gv = gs[r * QLD + cc];
          const float4* prow = reinterpret_cast<const float4*>(sps + r * PLD + jh * KH);
          const float4* drow = reinterpret_cast<const float4*>(sdss + r * PLD + jh * KH);
#pragma unroll
          for (int j4 = 0; j4 < KH / 4; ++j4) {
            const float4 pw = prow[j4], dw = drow[j4];
            av[4 * j4] = fmaf(pw.x, gv, av[4 * j4]);
            av[4 * j4 + 1] = fmaf(pw.y, gv, av[4 * j4 + 1]);
            av[4 * j4 + 2] = fmaf(pw.z, gv, av[4 * j4 + 2]);
            av[4 * j4 + 3] = fmaf(pw.w, gv, av[4 * j4 + 3]);
            ak[4 * j4] = fmaf(dw.x, qv, ak[4 * j4]);
            ak[4 * j4 + 1] = fmaf(dw.y, qv, ak[4 * j4 + 1]);
            ak[4 * j4 + 2] = fmaf(dw.z, qv, ak[4 * j4 + 2]);
            ak[4 * j4 + 3] = fmaf(dw.w, qv, ak[4 * j4 + 3]);
          }
        }
        if (cc < d) {
#pragma unroll
          for (int jj = 0; jj < KH; ++jj) {
            const int j = jt + jh * KH + jj;
            if (j < lk) {
              const long long off = (long long)j * d + cc;
              // the chunk's first sub-tile writes, the later ones add
              pk[off] = sub == 0 ? ak[jj] : pk[off] + ak[jj];
              pv[off] = sub == 0 ? av[jj] : pv[off] + av[jj];
            }
          }
        }
      }
    }

    if (S > 1) {
      // add the row's dq partials in split order
      __syncthreads();  // done with the tiles and the q/dO rows: reuse them
      float* accs = reinterpret_cast<float*>(smem4);  // [S][T][C][BQ]
#pragma unroll
      for (int c = 0; c < C; ++c) accs[((sp * T + t) * C + c) * BQ + rl] = acc[c];
      __syncthreads();
      if (sp == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float a = 0.f;
#pragma unroll
          for (int u = 0; u < S; ++u) a += accs[((u * T + t) * C + c) * BQ + rl];
          acc[c] = a;
        }
      }
    }
    if (live && sp == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = t * C + c;
        if (ch < d) dq[(head + row) * d + ch] = scale * acc[c];
      }
    }
  }
}

template <int T>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o,
                       const float* lse, const float* dout, float* dq, float* partial,
                       float* dkv, int bh, int lq, int lk, int d, int chunk_rows, int chunks,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(short_kv_attention_bwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(chunks, bh);
  short_kv_attention_bwd<T><<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, dout, dq, partial,
                                                             bh, lq, lk, d, chunk_rows, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, dkv, 2 * bh * lk * d, chunks, stream);
}

}  // namespace attn
}  // namespace p4t

// dq (BH, Lq, D); dkv (2, BH, Lk, D) = (dk, dv); partial: scratch of
// chunks * 2 * BH * Lk * D floats. chunk_rows: a multiple of 64, the
// query rows of one partial; chunks = ceil(Lq / chunk_rows).
extern "C" int p4t_short_kv_attention_bwd(const float* q, const float* k, const float* v,
                                          const float* o, const float* lse, const float* dout,
                                          float* dq, float* partial, float* dkv, int bh, int lq,
                                          int lk, int d, int chunk_rows, int chunks, float scale,
                                          void* stream) {
  using namespace p4t::attn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || lq < 1 || lk < 1 || d < 1 || d > 4 * C || chunk_rows < BQ ||
      chunk_rows % BQ != 0 || chunks != (lq + chunk_rows - 1) / chunk_rows)
    return (int)cudaErrorInvalidValue;
  if (d <= C)
    return (int)launch_bwd<1>(q, k, v, o, lse, dout, dq, partial, dkv, bh, lq, lk, d,
                              chunk_rows, chunks, scale, s);
  if (d <= 2 * C)
    return (int)launch_bwd<2>(q, k, v, o, lse, dout, dq, partial, dkv, bh, lq, lk, d,
                              chunk_rows, chunks, scale, s);
  return (int)launch_bwd<4>(q, k, v, o, lse, dout, dq, partial, dkv, bh, lq, lk, d, chunk_rows,
                            chunks, scale, s);
}
