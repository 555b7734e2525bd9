// Row-tile building blocks for the lattice GNN kernels on Hopper.
//
// A block of 256 threads takes a tile of BM rows (a row is one feature
// vector of up to HP = 32, 64 or 128 channels) into shared memory, and every
// product over the tile is a block product in which each thread owns a
// register micro-tile of TM rows x 4 columns: thread (ty, tx), with
// tx = tid % NX and NX = HP / 4, owns rows TM*ty .. TM*ty + TM-1 and
// columns 4*tx .. 4*tx + 3. Both operands reach the registers in 128-bit
// shared loads: a row tile is stored row-major [BM][HP], a weight matrix
// once, row-major [HP][HP] with its 16-byte chunks swizzled (`swz`), so
// that the product with W (a row of W across the lanes) and the product
// with W^T (four rows of W, one chunk each) are both free of bank
// conflicts. Each k-step of four channels costs TM + 4 loads of 128 bits
// for 16 TM FMAs, and no shuffle feeds a product.
//
// The row-wise work (biases, activations, LayerNorm forward and
// backward) runs on the same micro-tiles; a row's sums are reduced over
// the NX lanes that share it (`group_sum`).
//
// A weight gradient X^T Y over the rows a block walks is a set of 4 x 4
// patches of the HP x HP result, one a thread (`xty_acc` adds a tile's
// rows into a patch held in registers), kept in registers or in the
// thread's own slot of shared memory for the whole walk and written
// once, at its end. With HP = 32 the 64 patches are taken by 4 groups of
// 64 threads, each over a quarter of the tile's rows; the groups' sums
// are added in group order.
//
// Rows, columns and matrix entries past the real sizes are 0 in shared
// memory, so no product needs a bounds test. A row tile's row stride LD
// is HP unless given: HP + 4 puts the rows that two row groups of a warp
// read at once on other banks (at a stride of HP = 32 or 64 floats every
// row starts on bank 0).
#pragma once

#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace p4t {
namespace rt {

constexpr int THREADS = 256;

// Index of entry (r, c) of a shared [HP][HP] matrix whose 16-byte chunks
// are swizzled: chunk c/4 of row r sits at chunk (c/4) ^ ((r/4) % 8). A
// warp's quarter reading chunk tx of one row, or chunk k/4 of rows 4 tx
// + j, touches 8 distinct bank groups either way: the XOR permutes the
// chunks inside each aligned group of 8, whatever the row's length.
template <int HP>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(HP == 32 || HP == 64 || HP == 128, "swizzle needs 8, 16 or 32 chunks a row");
  return r * HP + ((((c >> 2) ^ ((r >> 2) & 7)) << 2) | (c & 3));
}

// Copy a global [rows][cols] matrix into a swizzled shared [HP][HP] one,
// zero-filled past rows and cols.
template <int HP>
__device__ __forceinline__ void stage_swizzled(float* __restrict__ dst,
                                               const float* __restrict__ src, int rows,
                                               int cols) {
  for (int i = threadIdx.x; i < HP * HP; i += blockDim.x) {
    const int r = i / HP, c = i % HP;
    dst[swz<HP>(r, c)] = (r < rows && c < cols) ? src[r * cols + c] : 0.f;
  }
}

// stage_swizzled by 16-byte asynchronous copies (cp.async, zero-filled
// past the data) when `vec` (cols a multiple of 4, src 16-byte aligned):
// every chunk is in flight at once, where the plain loop waits for each
// load in turn. The caller waits with `wait_copies` and a barrier.
template <int HP>
__device__ __forceinline__ void stage_swizzled_async(float* __restrict__ dst,
                                                     const float* __restrict__ src, int rows,
                                                     int cols, bool vec) {
  if (!vec) return stage_swizzled<HP>(dst, src, rows, cols);
  constexpr int CH = HP / 4;
  for (int i = threadIdx.x; i < HP * CH; i += blockDim.x) {
    const int r = i / CH, c = 4 * (i % CH);
    const int bytes = (r < rows && c < cols) ? 16 : 0;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + swz<HP>(r, c)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(bytes ? src + r * cols + c : src), "r"(bytes));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// v[0..3] = p[c0 .. c0+3], 0 past n; one 128-bit load when `vec` (n a
// multiple of 4 and p 16-byte aligned, so c0 < n covers all four).
__device__ __forceinline__ void load4(float (&v)[4], const float* __restrict__ p, int c0,
                                      int n, bool vec) {
  if (vec) {
    const float4 t = c0 < n ? __ldg(reinterpret_cast<const float4*>(p + c0))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c0 + j < n ? p[c0 + j] : 0.f;
  }
}

// p[c0 .. c0+3] = v[0..3] where c0 + j < n (see load4 for `vec`).
__device__ __forceinline__ void store4(float* __restrict__ p, int c0, int n, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    if (c0 < n) *reinterpret_cast<float4*>(p + c0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < n) p[c0 + j] = v[j];
  }
}

// v[0..3] = p[0..3] of shared memory, 16-byte aligned.
__device__ __forceinline__ void lds4(float (&v)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

template <int TM>
__device__ __forceinline__ void zero_tile(float (&v)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
}

// Load a thread's micro-tile from a shared [.][LD] row tile.
template <int HP, int TM, int LD = HP>
__device__ __forceinline__ void load_tile(float (&v)[TM][4], const float* __restrict__ tile,
                                          int r0, int c0) {
#pragma unroll
  for (int i = 0; i < TM; ++i) lds4(v[i], tile + (r0 + i) * LD + c0);
}

// Store a thread's micro-tile into a shared [.][LD] row tile.
template <int HP, int TM, int LD = HP>
__device__ __forceinline__ void store_tile(float* __restrict__ tile, int r0, int c0,
                                           const float (&v)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(tile + (r0 + i) * LD + c0) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// Load BM rows into a shared [BM][LD] row tile, zero past n columns and
// for rows where row(r) is null. With `vec`, each 16-byte chunk is an
// asynchronous copy (cp.async, zero-filled past the data; `base`, any
// valid global address, stands in for a chunk that reads nothing): the
// caller waits with `wait_copies` and a barrier. Otherwise plain loads.
template <int BM, int HP, int LD = HP, typename RowFn>
__device__ __forceinline__ void load_rows(float* __restrict__ tile, RowFn row, int n, bool vec,
                                          const float* base) {
  constexpr int CH = HP / 4;
  for (int i = threadIdx.x; i < BM * CH; i += blockDim.x) {
    const int r = i / CH, c = 4 * (i % CH);
    const float* src = row(r);
    float* dst = tile + r * LD + c;
    if (vec) {
      const int bytes = (src != nullptr && c < n) ? 16 : 0;
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(bytes ? src + c : base), "r"(bytes));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = (src != nullptr && c + j < n) ? src[c + j] : 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's asynchronous copies (a barrier makes them the
// block's).
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// acc[i][j] += sum_{k < HP} X[r0 + i][k] * W[k][c0 + j]        (X @ W)
// X: a shared [.][LD] row tile; W: a swizzled shared [HP][HP] matrix;
// c0 a multiple of 4. The k-loop runs in steps of 8 chunks (32 channels),
// so each chunk's swizzle is known at compile time: one XOR a chunk.
template <int HP, int TM, int LD = HP>
__device__ __forceinline__ void tile_mm(float (&acc)[TM][4], const float* __restrict__ X, int r0,
                                        const float* __restrict__ W, int c0) {
  const float* x = X + r0 * LD;
#pragma unroll 1
  for (int k8 = 0; k8 < HP; k8 += 32) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k4 = k8 + 4 * u;  // row k of W holds chunk c0/4 at (c0/4) ^ (k/4 % 8)
      float4 xv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = *reinterpret_cast<const float4*>(x + i * LD + k4);
      const float* w = W + k4 * HP + (c0 ^ (4 * u));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv = *reinterpret_cast<const float4*>(w + kk * HP);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float xi = lane4(xv[i], kk);
          acc[i][0] = fmaf(xi, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xi, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xi, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xi, wv.w, acc[i][3]);
        }
      }
    }
  }
}

// acc[i][j] += sum_{k < HP} X[r0 + i][k] * W[c0 + j][k]        (X @ W^T)
template <int HP, int TM>
__device__ __forceinline__ void tile_mm_t(float (&acc)[TM][4], const float* __restrict__ X,
                                          int r0, const float* __restrict__ W, int c0) {
  const float* x = X + r0 * HP;
  const int t7 = (c0 >> 2) & 7;  // rows c0 .. c0+3 of W swizzle by (c0/4) % 8
#pragma unroll 1
  for (int k8 = 0; k8 < HP; k8 += 32) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k4 = k8 + 4 * u;
      float4 xv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = *reinterpret_cast<const float4*>(x + i * HP + k4);
      const float* w = W + c0 * HP + k8 + 4 * (u ^ t7);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(w + j * HP);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float s = acc[i][j];
          s = fmaf(xv[i].x, wv.x, s);
          s = fmaf(xv[i].y, wv.y, s);
          s = fmaf(xv[i].z, wv.z, s);
          acc[i][j] = fmaf(xv[i].w, wv.w, s);
        }
      }
    }
  }
}

// acc[a][b] += sum_{r0 <= r < r1} X[r][f0 + a] * Y[r][c0 + b]: a thread's
// 4 x 4 patch of X^T Y over rows of two shared [.][HP] row tiles.
template <int HP>
__device__ __forceinline__ void xty_acc(float (&acc)[4][4], const float* __restrict__ X,
                                        const float* __restrict__ Y, int f0, int c0, int r0,
                                        int r1) {
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(X + r * HP + f0);
    const float4 y = *reinterpret_cast<const float4*>(Y + r * HP + c0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float xv = lane4(x, a);
      acc[a][0] = fmaf(xv, y.x, acc[a][0]);
      acc[a][1] = fmaf(xv, y.y, acc[a][1]);
      acc[a][2] = fmaf(xv, y.z, acc[a][2]);
      acc[a][3] = fmaf(xv, y.w, acc[a][3]);
    }
  }
}

// Sum over the NX consecutive lanes that share a row (a butterfly: every
// lane of the group gets the same bits).
template <int NX>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = NX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// In place on a thread's 4 channels c0.. of one row spread over NX lanes:
// t <- (t - mean) * inv over the row's first h channels (0 past h), the
// LayerNorm's normalised input (two-pass mean and variance, as flax
// computes them). Returns inv = 1/sqrt(var + eps).
template <int NX>
__device__ __forceinline__ float ln_normalize4(float (&t)[4], int c0, int h) {
  const float rh = __frcp_rn(static_cast<float>(h));
  const float mu = group_sum<NX>((t[0] + t[1]) + (t[2] + t[3])) * rh;
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j] = c0 + j < h ? t[j] - mu : 0.f;
    s2 = fmaf(t[j], t[j], s2);
  }
  const float inv = rsqrtf(group_sum<NX>(s2) * rh + LN_EPS);
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] *= inv;
  return inv;
}

// In place: g <- d/dt of LayerNorm(t) * scale + bias for the cotangent g,
// given the row's xhat and inv (ln_normalize4) and the thread's 4 scales.
template <int NX>
__device__ __forceinline__ void ln_backward4(float (&g)[4], const float (&xhat)[4], float inv,
                                             const float (&scale)[4], int c0, int h) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    g[j] *= scale[j];
    s1 += g[j];
    s2 = fmaf(g[j], xhat[j], s2);
  }
  const float rh = __frcp_rn(static_cast<float>(h));
  s1 = group_sum<NX>(s1) * rh;
  s2 = group_sum<NX>(s2) * rh;
#pragma unroll
  for (int j = 0; j < 4; ++j) g[j] = c0 + j < h ? (g[j] - s1 - xhat[j] * s2) * inv : 0.f;
}

// out[i] = sum_b partial[b][i], the second pass of the weight gradients.
// A block of 8 warps takes 32 columns: warp w adds the partials b = w,
// w + 8, ... in order, and warp 0 adds the 8 warps' sums in order, so a
// call repeats bit for bit, and each thread reads only blocks / 8
// partials.
__global__ void __launch_bounds__(256) sum_partials_by_warps(const float* __restrict__ partial,
                                                             float* __restrict__ out, int n,
                                                             int blocks) {
  __shared__ float s[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < n)
    for (int b = w; b < blocks; b += 8) acc += partial[(long long)b * n + i];
  s[w][lane] = acc;
  __syncthreads();
  if (w == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += s[k][lane];
    out[i] = t;
  }
}

inline cudaError_t launch_sum_partials_by_warps(const float* partial, float* out, int n,
                                                int blocks, cudaStream_t stream) {
  sum_partials_by_warps<<<(n + 31) / 32, 256, 0, stream>>>(partial, out, n, blocks);
  return cudaGetLastError();
}

}  // namespace rt
}  // namespace p4t
