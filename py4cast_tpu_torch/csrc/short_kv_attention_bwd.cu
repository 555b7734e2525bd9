// Long-query / short-KV attention, backward (fp32): for the cotangent dO
// of o = softmax(q . k^T * scale) . v,
//
//   P  = exp(q . k^T * scale - lse)             (recomputed, lse from the forward)
//   dP = dO . v^T
//   dS = P o (dP - delta),  delta = rowsum(dO o o)
//   dq = scale * dS . k;   dk = scale * dS^T . q;   dv = P^T . dO
//
// Replaces the TPU kernel py4cast_tpu/ops/attention.py::_bwd_kernel
// (reached from _bwd_rule, pl.pallas_call at :136), which writes dQ per
// Q block and adds dK, dV into one output block across the TPU's
// sequential grid. Hopper's blocks run in no order, so the work is cut
// in two passes that each own their outputs, a query-major one for dq
// and a key-major one for dk and dv.
//
// What bounds it on the H100: operations, ~10 D + 10 a query row and
// key (the q.k and dO.v dots, the dq, dk and dv updates, exp and the dS
// formula), against the bytes of q, o, dO, dq (Lq x D), lse and k, v,
// dk, dv (Lk x D). At Segformer's stage 1 that is 2.1 GFLOP: ~31 us of
// fp32 peak. Each pass recomputes P and dP (14 D a pair in all), which
// buys grids that fill the card without a partial per query block.
//
// Pass 1, short_kv_attention_bwd_dq: query-major, on the forward's lanes
// (attention_tiles.cuh). A lane holds R rows' slices of q (in base-2
// logit units), dO and the dq accumulator in registers; it first takes
// delta from its dO and o slices (loaded coalesced, joined by shuffles)
// and writes it for pass 2. S warps of a block split the keys; K and V
// arrive by cp.async in a ring. Per key: the two dots, one exp2 against
// the stored lse (no rescaling), and dq += dS k. The splits' dq meet in
// shared memory, added in split order, and dq is written once a row.
// The host picks (R, S) as the forward's (fwd_launch_shape).
//
// Pass 2, short_kv_attention_bwd_dkdv: key-major. A block of 256
// threads keeps BN keys' k and v in shared memory and walks its run of
// query tiles (BM = 64 rows): q, dO, lse and delta of the next tile land
// by cp.async while this one is used. Per tile each thread recomputes a
// KN x 4 micro-tile of the logits and of dP (keys kn + 16 i, rows
// tq + 16 j: every float read feeds 4 FMAs or more, and both reads are
// free of bank conflicts), writes P and scale * dS into shared memory,
// and after one barrier adds dV += P^T dO and dK += dS^T q into its 4 x 4
// key-by-channel patches, which stay in registers for the whole walk
// (with fewer patches than threads, G groups of threads take a share of
// the tile's rows each and add their patches in group order at the end).
// The grid is key tiles x query splits x BH (ops/attention.py::
// bwd_launch_shape): one split writes dk and dv straight out; more write
// one partial each, which short_kv_attention_bwd_sum adds in split
// order. No atomics: a call repeats bit for bit.
//
// Rows past Lq and keys past Lk are zero filled (lse and delta too), so
// they add exact zeros; a logit past Lk gets P = 0.
#include "attention_tiles.cuh"

namespace p4t {
namespace attn {

// ------------------------------------------------------------ pass 1: dq
template <int T, int R, int S>
struct DqShape {
  static constexpr int kT = T, kR = R, kS = S;
  static constexpr int LANE_ROWS = 32 / T;         // rows of one slice a warp holds
  static constexpr int BM = R * LANE_ROWS;         // rows a block
  static constexpr int THREADS = 32 * S;           // one warp a split
  static constexpr int KROW = CS * T;              // floats a key's row in shared memory
  static constexpr int STAGE = 2 * S * BK * KROW;  // K then V of one stage
  // keys of one update: their k words, read for the dots, stay in
  // registers for the dq update (16 R floats a key); fewer at T <= 2,
  // where the block count is what registers cap
  static constexpr int KS = (T <= 2 ? 4 : 8) / R;
  static constexpr int MROW = C * T + 4;           // a row of the merge's accumulators
  // q, dO and dq: 48 R floats a lane. 4-warp blocks of R = 2 get up to
  // 168 registers at T = 2 (3 blocks an SM; T = 1 spilled there), else
  // 255 (2 blocks); 8-warp blocks and R = 1 run only on grids of fewer
  // blocks than SMs (fwd_launch_shape): one block an SM.
  static constexpr int MIN_BLOCKS = (R == 2 && S == 4) ? (T == 2 ? 3 : 2) : 1;
  static constexpr size_t ring = (size_t)NST * STAGE;
  static constexpr size_t merge = (size_t)S * BM * MROW;
  static constexpr size_t rows_at = ring > merge ? ring : merge;  // then [2][BM]: lse, delta
  static constexpr size_t smem_bytes = sizeof(float) * (rows_at + 2 * BM);
};

template <int T, int R, int S>
__global__ void __launch_bounds__(32 * S, (DqShape<T, R, S>::MIN_BLOCKS))
    short_kv_attention_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ o,
                              const float* __restrict__ lse, const float* __restrict__ dout,
                              float* __restrict__ dq, float* __restrict__ delta, int lq, int lk,
                              int d, float scale) {
  using Sh = DqShape<T, R, S>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int bh = blockIdx.y, row0 = blockIdx.x * Sh::BM;
  const int lane = threadIdx.x % 32, sp = threadIdx.x / 32;
  const int t = lane / Sh::LANE_ROWS, rr = lane % Sh::LANE_ROWS;
  const float* kb = k + (long long)bh * lk * d;
  const float* vb = v + (long long)bh * lk * d;
  const long long head = (long long)bh * lq;
  // split sp's keys: [sp * chunk, (sp + 1) * chunk), chunk a multiple of BK
  const int chunk = BK * ((((lk + BK - 1) / BK) + S - 1) / S);
  const int tiles = chunk / BK;

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < tiles) load_kv_stage<T, S>(smem + i * Sh::STAGE, kb, vb, i, chunk, lk, d, Sh::THREADS);
    cp_async_commit();
  }

  // q in base-2 logit units, dO; the rows' lse (base 2) and delta in
  // shared memory, read where used (registers are what caps the blocks
  // an SM); rows past Lq have zero q and dO and an lse of +inf, so P = 0
  // there
  float x[R][C], g[R][C], acc[R][C];
  float* lse2 = smem + Sh::rows_at;  // [BM]
  float* dls = lse2 + Sh::BM;        // [BM]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * Sh::LANE_ROWS + rr;
    load_row_slice<T>(x[r], q + head * d, row, lq, d, t, scale * LOG2E);
    load_row_slice<T>(g[r], dout + head * d, row, lq, d, t, 1.f);
    float ov[C];
    load_row_slice<T>(ov, o + head * d, row, lq, d, t, 1.f);
    float part[1] = {0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) part[0] = fmaf(g[r][c], ov[c], part[0]);
    slice_sum<T>(part);
    if (sp == 0 && t == 0) {
      const int br = r * Sh::LANE_ROWS + rr;
      lse2[br] = row < lq ? lse[head + row] * LOG2E : INFINITY;
      dls[br] = part[0];
      if (row < lq) delta[head + row] = part[0];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int key_base = sp * chunk;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage i landed for all; stage i - 1 is free (and lse, delta are in)
    if (i + NST - 1 < tiles)
      load_kv_stage<T, S>(smem + ((i + NST - 1) % NST) * Sh::STAGE, kb, vb, i + NST - 1, chunk,
                          lk, d, Sh::THREADS);
    cp_async_commit();

    const int n = min(BK, lk - (key_base + i * BK));  // this split's keys in the stage
    const float* ks = smem + (i % NST) * Sh::STAGE + sp * BK * Sh::KROW + t * CS;
    const float* vs = ks + S * BK * Sh::KROW;
    // KS keys at a time; n is the same in the whole warp (one warp a
    // split). Not unrolled: overlapping the steps spilled at 168 registers.
#pragma unroll 1
    for (int h = 0; h < BK; h += Sh::KS) {
      if (h >= n) break;
      float s[R][Sh::KS] = {}, dp[R][Sh::KS] = {};
      slice_dots(s, x, ks + h * Sh::KROW, Sh::KROW);
      slice_dots(dp, g, vs + h * Sh::KROW, Sh::KROW);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        slice_sum<T>(s[r]);
        slice_sum<T>(dp[r]);
        const int br = r * Sh::LANE_ROWS + rr;
        const float l2 = lse2[br], dl = dls[br];
#pragma unroll
        for (int j = 0; j < Sh::KS; ++j) {
          const float p = h + j < n ? exp2f(s[r][j] - l2) : 0.f;
          s[r][j] = p * (dp[r][j] - dl);  // dS
        }
      }
      slice_axpy(acc, s, ks + h * Sh::KROW, Sh::KROW);  // dq += dS . k
    }
  }

  // the splits' dq, added in split order
  cp_async_wait<0>();
  __syncthreads();  // every split is done with the ring: it is reused
  float* accs = smem;  // [S][BM][MROW]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* dst = accs + (sp * Sh::BM + r * Sh::LANE_ROWS + rr) * Sh::MROW + t * C;
#pragma unroll
    for (int c4 = 0; c4 < C / 4; ++c4)
      reinterpret_cast<float4*>(dst)[c4] =
          make_float4(acc[r][4 * c4], acc[r][4 * c4 + 1], acc[r][4 * c4 + 2], acc[r][4 * c4 + 3]);
  }
  __syncthreads();
  // the block's rows are contiguous in dq: consecutive threads write
  // consecutive channels
  const int rows = min(Sh::BM, lq - row0);
  float* dqb = dq + (head + row0) * d;
  for (int e = threadIdx.x; e < rows * d; e += Sh::THREADS) {
    const int br = e / d, ch = e % d;
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < S; ++u) a += accs[(u * Sh::BM + br) * Sh::MROW + ch];
    dqb[e] = scale * a;
  }
}

// ------------------------------------------------------- pass 2: dK, dV
template <int DP>
struct DkvShape {
  static constexpr int kDP = DP;
  static constexpr int THREADS = 256;
  static constexpr int BN = DP == 128 ? 32 : 64;    // keys a block (fewer at D > 64: registers)
  static constexpr int BM = 64;                     // query rows a tile of the walk
  static constexpr int KN = BN / 16, KQ = BM / 16;  // a thread's keys and rows of the logits
  static constexpr int LD = DP + 4;                 // row stride of the k, v, q and dO tiles
  static constexpr int PLD = BN + 16;               // row stride of the P and dS tiles
  static constexpr int NB = DP / 4;                 // channel groups of a patch row
  static constexpr int PATCHES = BN / 4 * NB;       // 4 x 4 patches of dK (and of dV)
  static constexpr int G = THREADS / PATCHES;       // thread groups over a tile's rows
  static constexpr int QSTAGE = 2 * BM * LD + 2 * BM;  // q, dO, lse, delta of a tile
  static constexpr size_t walk = (size_t)2 * BN * LD + 2 * QSTAGE + 2 * BM * PLD;
  static constexpr size_t reduce = (size_t)THREADS * 32;
  static constexpr size_t smem_bytes = sizeof(float) * (walk > reduce ? walk : reduce);
  // two blocks an SM where shared memory allows it (D <= 32: 97 KB each)
  static constexpr int MIN_BLOCKS = DP <= 32 ? 2 : 1;
  static_assert(G >= 1 && THREADS % PATCHES == 0 && BM % G == 0, "patches must tile the block");
};

// Queue rows [row0, row0 + ROWS) of a (rows, d) matrix into a shared
// [ROWS][LD] tile, zero past `limit` rows and past d channels.
template <int DP, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_rows_async(float* __restrict__ dst,
                                                const float* __restrict__ src, int row0,
                                                int limit, int d) {
  if ((d & 3) == 0) {
    for (int e = threadIdx.x; e < ROWS * DP / 4; e += THREADS) {
      const int r = e / (DP / 4), c = 4 * (e % (DP / 4));
      const bool valid = row0 + r < limit && c < d;
      cp_async16(dst + r * LD + c, src + (valid ? (long long)(row0 + r) * d + c : 0), valid);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      const bool valid = row0 + r < limit && c < d;
      cp_async4(dst + r * LD + c, src + (valid ? (long long)(row0 + r) * d + c : 0), valid);
    }
  }
}

// q, dO, lse and delta of the query tile at row0 into a ring slot
template <int DP>
__device__ __forceinline__ void load_query_tile(float* __restrict__ slot,
                                                const float* __restrict__ qh,
                                                const float* __restrict__ gh,
                                                const float* __restrict__ lh,
                                                const float* __restrict__ dh, int row0, int lq,
                                                int d) {
  using Sh = DkvShape<DP>;
  load_rows_async<DP, Sh::BM, Sh::LD, Sh::THREADS>(slot, qh, row0, lq, d);
  load_rows_async<DP, Sh::BM, Sh::LD, Sh::THREADS>(slot + Sh::BM * Sh::LD, gh, row0, lq, d);
  float* ls = slot + 2 * Sh::BM * Sh::LD;
  for (int e = threadIdx.x; e < 2 * Sh::BM; e += Sh::THREADS) {
    const int r = e % Sh::BM;
    const bool valid = row0 + r < lq;
    cp_async4(ls + e, (e < Sh::BM ? lh : dh) + (valid ? row0 + r : 0), valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(256, (DkvShape<DP>::MIN_BLOCKS))
    short_kv_attention_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ lse,
                                const float* __restrict__ dout, const float* __restrict__ delta,
                                float* __restrict__ out, int n_bh, int lq, int lk, int d,
                                float scale) {
  using Sh = DkvShape<DP>;
  constexpr int BN = Sh::BN, BM = Sh::BM, LD = Sh::LD, PLD = Sh::PLD;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BN][LD]
  float* vs = ks + BN * LD;                     // [BN][LD]
  float* ring = vs + BN * LD;                   // [2][QSTAGE]: q [BM][LD], dO, lse [BM], delta
  float* ps = ring + 2 * Sh::QSTAGE;            // [BM][PLD]: P
  float* dss = ps + BM * PLD;                   // [BM][PLD]: scale * dS

  const int n0 = blockIdx.x * BN, sp = blockIdx.y, bh = blockIdx.z, splits = gridDim.y;
  const long long head = (long long)bh * lq;
  const float* qh = q + head * d;
  const float* gh = dout + head * d;
  // this split's query tiles [t0, t1): the tiles of Lq cut as evenly as
  // possible, split order along the rows
  const long long n_tiles = (lq + BM - 1) / BM;
  const int t0 = (int)(sp * n_tiles / splits), t1 = (int)((sp + 1) * n_tiles / splits);

  load_rows_async<DP, BN, LD, 256>(ks, k + (long long)bh * lk * d, n0, lk, d);
  load_rows_async<DP, BN, LD, 256>(vs, v + (long long)bh * lk * d, n0, lk, d);
  if (t0 < t1) load_query_tile<DP>(ring, qh, gh, lse + head, delta + head, t0 * BM, lq, d);
  cp_async_commit();

  // the logits: keys kn + 16 i, rows tq + 16 j
  const int kn = threadIdx.x % 16, tq = threadIdx.x / 16;
  // the patches: keys 4 a .. 4 a + 3, channels 4 b .. 4 b + 3, rows of
  // group grp
  const int pi = threadIdx.x % Sh::PATCHES, grp = threadIdx.x / Sh::PATCHES;
  const int b = pi % Sh::NB, a = pi / Sh::NB;
  constexpr int GROWS = BM / Sh::G;
  const float sl2 = scale * LOG2E;

  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int it = t0; it < t1; ++it) {
    float* slot = ring + ((it - t0) & 1) * Sh::QSTAGE;
    cp_async_wait<0>();
    __syncthreads();  // this tile landed for all; the last tile's readers are done
    if (it + 1 < t1)
      load_query_tile<DP>(ring + ((it + 1 - t0) & 1) * Sh::QSTAGE, qh, gh, lse + head,
                          delta + head, (it + 1) * BM, lq, d);
    cp_async_commit();

    const float* qt = slot;
    const float* gt = slot + BM * LD;
    const float* lt = slot + 2 * BM * LD;
    const float* dt = lt + BM;
    float s[Sh::KN][Sh::KQ] = {}, dp[Sh::KN][Sh::KQ] = {};
#pragma unroll 1  // unrolled, the loads hoisted ahead spilled at 128 registers
    for (int c = 0; c < DP; c += 4) {
      float4 kr[Sh::KN], qr[Sh::KQ];
#pragma unroll
      for (int i = 0; i < Sh::KN; ++i)
        kr[i] = *reinterpret_cast<const float4*>(ks + (kn + 16 * i) * LD + c);
#pragma unroll
      for (int j = 0; j < Sh::KQ; ++j)
        qr[j] = *reinterpret_cast<const float4*>(qt + (tq + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < Sh::KN; ++i)
#pragma unroll
        for (int j = 0; j < Sh::KQ; ++j) {
          float t = fmaf(kr[i].x, qr[j].x, s[i][j]);
          t = fmaf(kr[i].y, qr[j].y, t);
          t = fmaf(kr[i].z, qr[j].z, t);
          s[i][j] = fmaf(kr[i].w, qr[j].w, t);
        }
    }
#pragma unroll 1  // unrolled, the loads hoisted ahead spilled at 128 registers
    for (int c = 0; c < DP; c += 4) {
      float4 vr[Sh::KN], gr[Sh::KQ];
#pragma unroll
      for (int i = 0; i < Sh::KN; ++i)
        vr[i] = *reinterpret_cast<const float4*>(vs + (kn + 16 * i) * LD + c);
#pragma unroll
      for (int j = 0; j < Sh::KQ; ++j)
        gr[j] = *reinterpret_cast<const float4*>(gt + (tq + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < Sh::KN; ++i)
#pragma unroll
        for (int j = 0; j < Sh::KQ; ++j) {
          float t = fmaf(vr[i].x, gr[j].x, dp[i][j]);
          t = fmaf(vr[i].y, gr[j].y, t);
          t = fmaf(vr[i].z, gr[j].z, t);
          dp[i][j] = fmaf(vr[i].w, gr[j].w, t);
        }
    }
#pragma unroll
    for (int j = 0; j < Sh::KQ; ++j) {
      const int m = tq + 16 * j;
      const float l2 = lt[m] * LOG2E, dl = dt[m];
#pragma unroll
      for (int i = 0; i < Sh::KN; ++i) {
        const int key = kn + 16 * i;
        const float p = n0 + key < lk ? exp2f(fmaf(s[i][j], sl2, -l2)) : 0.f;
        ps[m * PLD + key] = p;
        dss[m * PLD + key] = scale * (p * (dp[i][j] - dl));
      }
    }
    __syncthreads();  // P and dS of the tile are whole

    // dV += P^T dO, dK += dS^T q over the group's rows of the tile
#pragma unroll 2
    for (int m = grp * GROWS; m < (grp + 1) * GROWS; ++m) {
      const float4 pw = *reinterpret_cast<const float4*>(ps + m * PLD + 4 * a);
      const float4 dw = *reinterpret_cast<const float4*>(dss + m * PLD + 4 * a);
      const float4 gv = *reinterpret_cast<const float4*>(gt + m * LD + 4 * b);
      const float4 qv = *reinterpret_cast<const float4*>(qt + m * LD + 4 * b);
      const float pk[4] = {pw.x, pw.y, pw.z, pw.w}, dk4[4] = {dw.x, dw.y, dw.z, dw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i][0] = fmaf(pk[i], gv.x, dv[i][0]);
        dv[i][1] = fmaf(pk[i], gv.y, dv[i][1]);
        dv[i][2] = fmaf(pk[i], gv.z, dv[i][2]);
        dv[i][3] = fmaf(pk[i], gv.w, dv[i][3]);
        dk[i][0] = fmaf(dk4[i], qv.x, dk[i][0]);
        dk[i][1] = fmaf(dk4[i], qv.y, dk[i][1]);
        dk[i][2] = fmaf(dk4[i], qv.z, dk[i][2]);
        dk[i][3] = fmaf(dk4[i], qv.w, dk[i][3]);
      }
    }
  }

  if (Sh::G > 1) {  // the groups' patches, added in group order
    cp_async_wait<0>();
    __syncthreads();  // done with every tile: shared memory is reused
    float* red = reinterpret_cast<float*>(smem4);  // [32][THREADS]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(4 * i + j) * Sh::THREADS + threadIdx.x] = dk[i][j];
        red[(16 + 4 * i + j) * Sh::THREADS + threadIdx.x] = dv[i][j];
      }
    __syncthreads();
    if (grp != 0) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int u = 1; u < Sh::G; ++u) {
          dk[i][j] += red[(4 * i + j) * Sh::THREADS + u * Sh::PATCHES + pi];
          dv[i][j] += red[(16 + 4 * i + j) * Sh::THREADS + u * Sh::PATCHES + pi];
        }
      }
  }

  // this split's dk and dv: out [split][2][BH][Lk][D]
  const long long kv_size = (long long)n_bh * lk * d;
  float* ok = out + 2 * sp * kv_size + (long long)bh * lk * d;
  float* ov = ok + kv_size;
  const bool vec = (d & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + 4 * a + i;
    if (key >= lk) break;
    const long long off = (long long)key * d + 4 * b;
    if (vec) {
      if (4 * b < d) {
        *reinterpret_cast<float4*>(ok + off) = make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]);
        *reinterpret_cast<float4*>(ov + off) = make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * b + j < d) {
          ok[off + j] = dk[i][j];
          ov[off + j] = dv[i][j];
        }
    }
  }
}

// out[i] = sum_s partial[s][i], s ascending. A block of 8 warps takes
// 32 * 8 / ways outputs: `ways` warps share 32 of them, warp w of the
// ways adding the splits w, w + ways, ... in order, and the first adding
// the ways' sums in order, so a call repeats bit for bit.
__global__ void __launch_bounds__(256)
    short_kv_attention_bwd_sum(const float* __restrict__ partial, float* __restrict__ out,
                               long long n, int splits, int ways) {
  __shared__ float s[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, wi = w % ways;
  const long long i = ((long long)blockIdx.x * (8 / ways) + w / ways) * 32 + lane;
  float acc = 0.f;
  if (i < n)
    for (int b = wi; b < splits; b += ways) acc += partial[b * n + i];
  s[w][lane] = acc;
  __syncthreads();
  if (wi == 0 && i < n) {
    float t = 0.f;
    for (int u = 0; u < ways; ++u) t += s[w + u][lane];
    out[i] = t;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The pass-1 shapes the host may ask for: (R, S) in {(2, 4), (2, 8),
// (1, 4), (1, 8)}, with S * T <= 32 (the ring's shared memory), as the
// forward's.
template <int T, typename F>
cudaError_t dispatch_dq_slices(int rows, int splits, F&& f) {
  if (rows == 2 && splits == 4) return f(DqShape<T, 2, 4>{});
  if (rows == 1 && splits == 4) return f(DqShape<T, 1, 4>{});
  if constexpr (T <= 4) {
    if (rows == 2 && splits == 8) return f(DqShape<T, 2, 8>{});
    if (rows == 1 && splits == 8) return f(DqShape<T, 1, 8>{});
  }
  return cudaErrorInvalidValue;
}

// f(DqShape<T, R, S>{}, DkvShape<DP>{}) for the instances of (d, rows,
// splits): T = DP / 16 slices a row, DP the channels padded to 16, 32, 64
// or 128.
template <typename F>
cudaError_t dispatch(int d, int rows, int splits, F&& f) {
  if (d < 1 || d > 8 * C) return cudaErrorInvalidValue;
  if (d <= C) return dispatch_dq_slices<1>(rows, splits, [&](auto s) { return f(s, DkvShape<16>{}); });
  if (d <= 2 * C)
    return dispatch_dq_slices<2>(rows, splits, [&](auto s) { return f(s, DkvShape<32>{}); });
  if (d <= 4 * C)
    return dispatch_dq_slices<4>(rows, splits, [&](auto s) { return f(s, DkvShape<64>{}); });
  return dispatch_dq_slices<8>(rows, splits, [&](auto s) { return f(s, DkvShape<128>{}); });
}

template <typename Kernel>
cudaError_t kernel_attributes(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace attn
}  // namespace p4t

// dq (BH, Lq, D); delta: scratch of BH * Lq floats; dkv (2, BH, Lk, D) =
// (dk, dv); partial: scratch of query_splits * 2 * BH * Lk * D floats
// when query_splits > 1 (unused otherwise). rows, splits: pass 1's (R, S);
// key_tile: pass 2's BN, which the instance fixes (32 at D > 64, else
// 64) and the host states; query_splits: pass 2's runs of query tiles,
// 1 to ceil(Lq / 64). All from ops/attention.py::bwd_launch_shape.
extern "C" int p4t_short_kv_attention_bwd(const float* q, const float* k, const float* v,
                                          const float* o, const float* lse, const float* dout,
                                          float* dq, float* delta, float* partial, float* dkv,
                                          int bh, int lq, int lk, int d, float scale, int rows,
                                          int splits, int key_tile, int query_splits,
                                          void* stream) {
  using namespace p4t::attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long q_tiles = (lq + 63) / 64;
  if (bh < 1 || bh > 65535 || lq < 1 || lk < 1 || query_splits < 1 ||
      query_splits > q_tiles || query_splits > 65535 || (query_splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(d, rows, splits, [&](auto sq, auto sk) {
    using Sq = decltype(sq);
    using Sk = decltype(sk);
    if (key_tile != Sk::BN) return cudaErrorInvalidValue;
    auto dq_kernel = short_kv_attention_bwd_dq<Sq::kT, Sq::kR, Sq::kS>;
    auto dkv_kernel = short_kv_attention_bwd_dkdv<Sk::kDP>;
    cudaError_t err = set_smem(dq_kernel, Sq::smem_bytes);
    if (err == cudaSuccess) err = set_smem(dkv_kernel, Sk::smem_bytes);
    if (err != cudaSuccess) return err;
    dq_kernel<<<dim3((lq + Sq::BM - 1) / Sq::BM, bh), Sq::THREADS, Sq::smem_bytes, st>>>(
        q, k, v, o, lse, dout, dq, delta, lq, lk, d, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    float* out = query_splits == 1 ? dkv : partial;
    dkv_kernel<<<dim3((lk + Sk::BN - 1) / Sk::BN, query_splits, bh), Sk::THREADS,
                 Sk::smem_bytes, st>>>(q, k, v, lse, dout, delta, out, bh, lq, lk, d, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || query_splits == 1) return err;
    // ways: warps a column, so that a thread adds at most 8 splits
    const long long n = 2LL * bh * lk * d;
    const int ways = query_splits <= 8 ? 1 : query_splits <= 16 ? 2 : query_splits <= 32 ? 4 : 8;
    const long long cols = 32 * (8 / ways);
    short_kv_attention_bwd_sum<<<(unsigned)((n + cols - 1) / cols), 256, 0, st>>>(
        partial, dkv, n, query_splits, ways);
    return cudaGetLastError();
  });
}

// out[8]: for pass 1's kernel, then pass 2's, of (d, rows, splits):
// registers a thread, local bytes a thread (spills), dynamic shared
// memory bytes, resident blocks an SM
extern "C" int p4t_short_kv_attention_bwd_attributes(int d, int rows, int splits, int* out) {
  using namespace p4t::attn;
  return (int)dispatch(d, rows, splits, [&](auto sq, auto sk) {
    using Sq = decltype(sq);
    using Sk = decltype(sk);
    cudaError_t err = kernel_attributes(short_kv_attention_bwd_dq<Sq::kT, Sq::kR, Sq::kS>,
                                        Sq::THREADS, Sq::smem_bytes, out);
    if (err != cudaSuccess) return err;
    return kernel_attributes(short_kv_attention_bwd_dkdv<Sk::kDP>, Sk::THREADS, Sk::smem_bytes,
                             out + 4);
  });
}
