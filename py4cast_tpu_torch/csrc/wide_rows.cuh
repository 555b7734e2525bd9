// Wide-row building blocks: the one design behind the instances of the
// lattice kernels (stencil message a, corner hop b, forward and backward)
// for hidden widths above their row-tile instances' caps (a-fwd 128,
// a-bwd 64, b-fwd 96, b-bwd 64), up to 512.
//
// What bounds those widths on the H100: the row-tile instances keep
// every h x h weight matrix in shared memory, swizzled, beside their row
// tiles; one 256 x 256 fp32 matrix alone is 256 KB, above the 227 KB a
// block may use, and a-bwd at h = 64 already holds 112 KB. Their weight
// gradients are 4 x 4 patches a thread over the whole walk, h^2 / 256
// floats a thread for each matrix: 256 a thread at h = 256.
//
// What the design does about it:
// - A block of 256 threads walks row tiles of BM rows x HP columns (HP =
//   128, 256 or 512, the width rounded up). A row is spread over NX
//   lanes (16; 32 at HP = 512), thread (ty, tx) = (tid / NX, tid % NX)
//   owning TM rows and CJ chunks of 4 columns, 4 NX apart (columns 4 tx +
//   4 NX j): BM = 64, 32, 8 rows, TM x CJ x 4 = 32, 32, 16 floats a
//   thread (at 512 the 16 keep b-bwd's passes off the 255-register cap).
// - A product X @ W (or X @ W^T) never holds W: `mm` streams it through
//   shared memory in chunks of KC rows (KC = 32, 16, 8: each chunk ~16
//   KB), double-buffered by cp.async, while the block multiplies the
//   chunk before; X is a shared row tile. Products run in fp32 on the
//   FMA units (TF32 would miss the 1e-4 bar), no shuffle: a W chunk's
//   row is read by the NX lanes of a row group as 128-bit loads.
// - A row's LayerNorm sums run over the NX lanes that share it
//   (rt::group_sum), a butterfly: every lane gets the same bits.
// - A weight gradient X^T Y is not summed in the walk: the fused kernel
//   writes the rows of X and Y that are not already outputs to a scratch
//   array, and `xty_partials` then sums them, each block over one slice
//   of the rows in order, into one fp32 partial a block; vector
//   gradients (column sums) are per-tile column sums, in row order, into
//   a per-block sum in shared memory. rt::sum_partials_by_warps adds the
//   partials in a fixed order. No atomics: a call repeats bit for bit.
//
// Rows and columns past the real sizes are 0 in shared memory and in the
// weight chunks, so no product needs a bounds test. Widths that are not
// multiples of 4 take 4-byte copies and plain loads in place of 128-bit
// ones.
#pragma once

#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace p4t {
namespace wide {

using rt::THREADS;

constexpr int MAX_HP = 512;  // the widest instance

// The instance for padded width HP.
template <int HP_>
struct Cfg {
  static constexpr int HP = HP_;
  static constexpr int NX = HP == 512 ? 32 : 16;  // lanes a row
  static constexpr int NY = THREADS / NX;         // row groups
  static constexpr int CJ = HP / (4 * NX);        // 4-column chunks a thread
  static constexpr int TM = HP == 512 ? 1 : 8 / CJ;  // rows a thread
  static constexpr int BM = NY * TM;              // rows a tile: 64, 32, 8
  static constexpr int LD = HP + 4;        // row stride of a tile
  static constexpr int KC = 4096 / HP;     // weight rows a chunk
  static constexpr int LDW = HP + 4;       // row stride of a chunk
  static constexpr int TILE = BM * LD;     // floats a row tile
  static constexpr int CHUNKS = 2 * KC * LDW;  // floats of the two chunk buffers
  static_assert(HP == 128 || HP == 256 || HP == 512, "wide instances: HP 128, 256, 512");
  static_assert(HP % KC == 0 && KC % 4 == 0, "chunks tile the width");
  static_assert(BM % 8 == 0, "a tile holds whole lattice cells (8 rows)");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_one_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A thread's place in the block: rows TM ty .. TM ty + TM - 1 of a tile,
// columns 4 tx + 4 NX j + (0..3).
template <class C>
struct Lane {
  int tid, tx, ty;
  __device__ Lane() : tid(threadIdx.x), tx(threadIdx.x % C::NX), ty(threadIdx.x / C::NX) {}
  __device__ int col(int j) const { return 4 * tx + 4 * C::NX * j; }
};

template <class C>
using Frag = float[C::TM][C::CJ][4];

template <class C>
__device__ __forceinline__ void zero(Frag<C>& v) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::CJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[i][j][q] = 0.f;
}

// One row's CJ x 4 values from global memory at p (0 past n).
template <class C>
__device__ __forceinline__ void load_row(float (&v)[C::CJ][4], const float* p, const Lane<C>& t,
                                         int n, bool vec) {
#pragma unroll
  for (int j = 0; j < C::CJ; ++j) rt::load4(v[j], p, t.col(j), n, vec);
}

// One row's values to global memory at p (columns below n only).
template <class C>
__device__ __forceinline__ void store_row(float* p, const Lane<C>& t, int n, bool vec,
                                          const float (&v)[C::CJ][4]) {
#pragma unroll
  for (int j = 0; j < C::CJ; ++j) rt::store4(p, t.col(j), n, vec, v[j]);
}

// A vector's CJ x 4 values (plain loads: a vector's alignment is not
// checked).
template <class C>
__device__ __forceinline__ void load_vec(float (&v)[C::CJ][4], const float* p, const Lane<C>& t,
                                         int n) {
  load_row<C>(v, p, t, n, false);
}

// The thread's fragment to / from a shared [BM][LD] row tile.
template <class C>
__device__ __forceinline__ void put(float* tile, const Lane<C>& t, const Frag<C>& v) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::CJ; ++j)
      *reinterpret_cast<float4*>(tile + (t.ty * C::TM + i) * C::LD + t.col(j)) =
          make_float4(v[i][j][0], v[i][j][1], v[i][j][2], v[i][j][3]);
}

// tile = a * b, elementwise, for the thread's fragment.
template <class C>
__device__ __forceinline__ void put_product(float* tile, const Lane<C>& t, const Frag<C>& a,
                                            const Frag<C>& b) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::CJ; ++j)
      *reinterpret_cast<float4*>(tile + (t.ty * C::TM + i) * C::LD + t.col(j)) =
          make_float4(a[i][j][0] * b[i][j][0], a[i][j][1] * b[i][j][1],
                      a[i][j][2] * b[i][j][2], a[i][j][3] * b[i][j][3]);
}

template <class C>
__device__ __forceinline__ void get(Frag<C>& v, const float* tile, const Lane<C>& t) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::CJ; ++j)
      rt::lds4(v[i][j], tile + (t.ty * C::TM + i) * C::LD + t.col(j));
}

// Load BM rows into a shared [BM][LD] row tile (rt::load_rows: row(r)
// null past the end, zero past n columns). The next `mm` waits for the
// copies (its wait covers every older group) and its first barrier
// publishes the tile.
template <class C, typename RowFn>
__device__ __forceinline__ void fill_tile(float* tile, RowFn row, int n, bool vec,
                                          const float* base) {
  rt::load_rows<C::BM, C::HP, C::LD>(tile, row, n, vec, base);
}

// Rows k0 .. k0 + KC - 1 of B into a chunk buffer [KC][LDW], zero past K
// rows and N columns: B = W (K x N, row-major) or, with TRANS, W^T (W: N x
// K, row-major). One cp.async group.
template <class C, bool TRANS>
__device__ __forceinline__ void stage_chunk(float* dst, const float* W, int K, int N, int k0,
                                            bool wvec) {
  constexpr int HP = C::HP, KC = C::KC, LDW = C::LDW;
  if (!TRANS && wvec) {
    constexpr int CH = HP / 4;
    for (int i = threadIdx.x; i < KC * CH; i += THREADS) {
      const int kk = i / CH, c = 4 * (i % CH);
      const bool ok = k0 + kk < K && c < N;
      cp_async16(dst + kk * LDW + c, ok ? W + (long long)(k0 + kk) * N + c : W, ok);
    }
  } else if (!TRANS) {
    for (int i = threadIdx.x; i < KC * HP; i += THREADS) {
      const int kk = i / HP, c = i % HP;
      const bool ok = k0 + kk < K && c < N;
      cp_async4(dst + kk * LDW + c, ok ? W + (long long)(k0 + kk) * N + c : W, ok);
    }
  } else {
    // KC consecutive floats of one row of W a run of threads: coalesced
    // reads; the row stride HP + 4 spreads the stores over the banks
    for (int i = threadIdx.x; i < KC * HP; i += THREADS) {
      const int kk = i % KC, n = i / KC;
      const bool ok = k0 + kk < K && n < N;
      cp_async4(dst + kk * LDW + n, ok ? W + (long long)n * K + k0 + kk : W, ok);
    }
  }
  commit();
}

// acc[i][j][q] += sum_{k < K} X[r0 + i][k] * B[k][4 tx + 64 j + q], B as
// stage_chunk's (N <= HP, K <= HP). X: a shared [BM][LD] row tile, 0 past
// its width; s_w: the two chunk buffers. Every thread of the block calls
// it; it begins and ends with a barrier, so a tile stored before the call
// is read whole, and a tile read by it may be overwritten after it.
template <class C, bool TRANS>
__device__ __forceinline__ void mm(Frag<C>& acc, const float* X, const Lane<C>& t, const float* W,
                                   int K, int N, bool wvec, float* s_w) {
  constexpr int TM = C::TM, CJ = C::CJ, KC = C::KC, LD = C::LD, LDW = C::LDW, NX = C::NX;
  const int nch = (K + KC - 1) / KC;
  stage_chunk<C, TRANS>(s_w, W, K, N, 0, wvec);
  const float* x0 = X + t.ty * TM * LD;
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch)
      stage_chunk<C, TRANS>(s_w + ((c + 1) & 1) * KC * LDW, W, K, N, (c + 1) * KC, wvec);
    else
      commit();  // an empty group: wait_one_pending still means chunk c
    wait_one_pending();
    __syncthreads();
    const float* w = s_w + (c & 1) * KC * LDW + 4 * t.tx;
    const float* x = x0 + c * KC;
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 xv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = *reinterpret_cast<const float4*>(x + i * LD + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(w + (k4 + q) * LDW + 4 * NX * j);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float xi = rt::lane4(xv[i], q);
            acc[i][j][0] = fmaf(xi, wv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(xi, wv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(xi, wv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(xi, wv.w, acc[i][j][3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// acc[i] += b, a vector, for every row of the fragment.
template <class C>
__device__ __forceinline__ void add_vec(Frag<C>& acc, const float (&b)[C::CJ][4]) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::CJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] += b[j][q];
}

template <class C>
__device__ __forceinline__ float row_sum(const float (&r)[C::CJ][4]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < C::CJ; ++j) s += (r[j][0] + r[j][1]) + (r[j][2] + r[j][3]);
  return rt::group_sum<C::NX>(s);
}

// In place on one row: t <- (t - mean) * inv over its first h channels (0
// past h), two-pass as flax computes it. Returns inv = 1/sqrt(var + eps).
template <class C>
__device__ __forceinline__ float ln_normalize(float (&t)[C::CJ][4], const Lane<C>& l, int h) {
  constexpr int CJ = C::CJ;
  const float rh = __frcp_rn(static_cast<float>(h));
  const float mu = row_sum<C>(t) * rh;
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < CJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      t[j][q] = l.col(j) + q < h ? t[j][q] - mu : 0.f;
      s2 = fmaf(t[j][q], t[j][q], s2);
    }
  const float inv = rsqrtf(rt::group_sum<C::NX>(s2) * rh + LN_EPS);
#pragma unroll
  for (int j = 0; j < CJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) t[j][q] *= inv;
  return inv;
}

// In place on one row: g <- d/dt of LayerNorm(t) * scale + bias for the
// cotangent g, given the row's xhat and inv (ln_normalize).
template <class C>
__device__ __forceinline__ void ln_backward(float (&g)[C::CJ][4], const float (&xhat)[C::CJ][4],
                                            float inv, const float (&scale)[C::CJ][4],
                                            const Lane<C>& l, int h) {
  constexpr int CJ = C::CJ;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < CJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      g[j][q] *= scale[j][q];
      s1 += g[j][q];
      s2 = fmaf(g[j][q], xhat[j][q], s2);
    }
  const float rh = __frcp_rn(static_cast<float>(h));
  s1 = rt::group_sum<C::NX>(s1) * rh;
  s2 = rt::group_sum<C::NX>(s2) * rh;
#pragma unroll
  for (int j = 0; j < CJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[j][q] = l.col(j) + q < h ? (g[j][q] - s1 - xhat[j][q] * s2) * inv : 0.f;
}

__device__ __forceinline__ float sigmoid(float p) { return __frcp_rn(1.f + __expf(-p)); }

// s_sum[c] += sum over the tile's rows, in row order, of tile[r][c]: a
// tile's share of a vector gradient. Each column is one thread's, so the
// per-block sums need no barrier of their own; the tile must be complete
// (behind a barrier) and stay unchanged until the next barrier.
template <class C>
__device__ __forceinline__ void add_colsums(float* s_sum, const float* tile) {
  for (int c = threadIdx.x; c < C::HP; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < C::BM; ++r) s += tile[r * C::LD + c];
    s_sum[c] += s;
  }
}

// out[k] = sum over the tile's groups of 8 rows (a lattice cell's 8
// directions), in direction order: a's agg and dpd. Cells past n_cells
// are skipped. The tile must be complete.
template <class C>
__device__ __forceinline__ void sum_directions(float* out, const float* tile, int first_cell,
                                               int n_cells, int h) {
  for (int i = threadIdx.x; i < (C::BM / 8) * C::HP; i += THREADS) {
    const int cl = i / C::HP, c = i % C::HP;
    const int cell = first_cell + cl;
    if (cell >= n_cells || c >= h) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += tile[(cl * 8 + k) * C::LD + c];
    out[(long long)cell * h + c] = s;
  }
}

// ------------------------------------------------------ weight gradients
// Up to 4 (X, Y) pairs summed: sum_seg X_seg^T Y_seg over R rows; row r
// of X_seg is its row r % xmod (the corner features, shared by the batch).
struct XtyArgs {
  const float *x0, *x1, *x2, *x3, *y0, *y1, *y2, *y3;
  long long R, xmod;
  int nseg, K, N;
  float* partial;     // [splits][total]
  long long total, off;  // this gradient's offset in one partial
};

constexpr int XT = 64;  // the output tile: XT x XT
constexpr int XR = 32;  // rows a chunk
constexpr int XLD = XT + 4;

// Block (tile, s) writes partial[s][off + k * N + n] = its slice of rows'
// share of the sum, for the XT x XT output tile `tile` (blockIdx.x; the N
// tiles of a row of tiles run fastest), over rows R * s / S .. R * (s+1)
// / S (s = blockIdx.y, S = gridDim.y) in order, segment by segment.
// Thread (ty, tx) owns the 4 x 4 patch k = 4 ty.., n = 4 tx.. .
__global__ void __launch_bounds__(THREADS) xty_partials(XtyArgs a) {
  __shared__ __align__(16) float sx[2][XR][XLD];
  __shared__ __align__(16) float sy[2][XR][XLD];
  const int n_tiles = (a.N + XT - 1) / XT;
  const int k0 = (blockIdx.x / n_tiles) * XT, n0 = (blockIdx.x % n_tiles) * XT;
  const long long r_begin = a.R * blockIdx.y / gridDim.y;
  const long long r_end = a.R * (blockIdx.y + 1) / gridDim.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const long long n_chunks = (r_end - r_begin + XR - 1) / XR;
  for (int seg = 0; seg < a.nseg; ++seg) {
    // a select, not an index into the parameters: that would copy them
    // to local memory
    const float* X = seg == 0 ? a.x0 : seg == 1 ? a.x1 : seg == 2 ? a.x2 : a.x3;
    const float* Y = seg == 0 ? a.y0 : seg == 1 ? a.y1 : seg == 2 ? a.y2 : a.y3;
    auto stage = [&](int buf, long long rb) {
      for (int i = threadIdx.x; i < XR * XT; i += THREADS) {
        const int rr = i / XT, cc = i % XT;
        const long long r = rb + rr;
        const bool okx = r < r_end && k0 + cc < a.K;
        const bool oky = r < r_end && n0 + cc < a.N;
        cp_async4(&sx[buf][rr][cc], okx ? X + (r % a.xmod) * a.K + k0 + cc : X, okx);
        cp_async4(&sy[buf][rr][cc], oky ? Y + r * a.N + n0 + cc : Y, oky);
      }
      commit();
    };
    if (n_chunks > 0) stage(0, r_begin);
    for (long long c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks)
        stage((c + 1) & 1, r_begin + (c + 1) * XR);
      else
        commit();
      wait_one_pending();
      __syncthreads();
      const int buf = c & 1;
#pragma unroll 8
      for (int rr = 0; rr < XR; ++rr) {
        const float4 xv = *reinterpret_cast<const float4*>(&sx[buf][rr][4 * ty]);
        const float4 yv = *reinterpret_cast<const float4*>(&sy[buf][rr][4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xi = rt::lane4(xv, i);
          acc[i][0] = fmaf(xi, yv.x, acc[i][0]);
          acc[i][1] = fmaf(xi, yv.y, acc[i][1]);
          acc[i][2] = fmaf(xi, yv.z, acc[i][2]);
          acc[i][3] = fmaf(xi, yv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }
  float* out = a.partial + (long long)blockIdx.y * a.total + a.off;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * ty + i, n = n0 + 4 * tx + j;
      if (k < a.K && n < a.N) out[(long long)k * a.N + n] = acc[i][j];
    }
}

// Launch xty_partials for one gradient over `splits` row slices.
inline cudaError_t launch_xty(const XtyArgs& a, int splits, cudaStream_t stream) {
  const int tiles = ((a.K + XT - 1) / XT) * ((a.N + XT - 1) / XT);
  xty_partials<<<dim3(tiles, splits), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// As many blocks of `kernel` (THREADS threads, `smem` bytes) as the SMs
// hold, or fewer: `tiles` spread evenly, so that no block takes more than
// the largest share must.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long long tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  const long long per_block = (tiles + cap - 1) / cap;
  const long long n = per_block > 0 ? (tiles + per_block - 1) / per_block : 1;
  *blocks = (int)(n > 0 ? n : 1);
  return cudaSuccess;
}

// out[5] = registers a thread, local (spill) bytes a thread, dynamic
// shared memory, resident blocks an SM and rows a tile of `kernel`.
template <typename Kernel>
cudaError_t kernel_attributes(Kernel kernel, size_t smem, int rows, int* out) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = rows;
  return cudaSuccess;
}

}  // namespace wide
}  // namespace p4t
