// Lattice mesh->grid corner hop (m2g), backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel py4cast_tpu/ops/hop_kernel.py::_bwd_kernel
// (called through _bwd_call; its lane-packed twin _bwd_kernel_packed is
// a TPU layout device with the same math). Per grid cell, for the
// cotangent g of v_out = vd + LN(u @ Nd1 + nb1):
//
//   recompute pd = vd @ Wd, the four corners, agg, u_pre, u, y
//   node:    dy = LN backward of g;  dNd1 += u^T dy
//            dupre = (dy @ Nd1^T) * silu'(u_pre)
//            dNd0a += vd^T dupre, dNd0b += agg^T dupre
//            dvd = g + dupre @ Nd0a^T;  dagg = dupre @ Nd0b^T (/4 if mean)
//   corner k: dt_k = LN backward of dagg;  dWo += z_k^T dt_k
//            dpsg_k = dpre_k = (dt_k @ Wo^T) * silu'(pre_k)
//            dWf += feats_k^T dpre_k;  dpd += dpre_k
//   dvd += dpd @ Wd^T;  dWd += vd^T dpd
//
// What bounds it on the H100: at the GraphLAM 500x500 grid (h=64, fp32)
// the function must move ~716 MB (psg_k, vd, g, dpsg_k, dvd at 64 MB
// each, feats 12 MB; ~0.21 ms at 3.35 TB/s) and do ~50 GFLOP (24 h x h
// products per cell: 8 recomputed, 8 transposed, 8 weight-gradient
// updates; ~0.75 ms at the 67 TFLOP/s CUDA-core peak): it is bound by
// operations.
//
// What the design does about it: the forward's layout (one warp, P
// cells, rows in registers, nothing grid-sized but the true inputs and
// outputs in device memory). The corner internals are not cached: the
// per-corner pass recomputes pre_k, z_k and the LayerNorm statistics
// from psg_k (one more h x h product per corner, and psg_k read twice),
// which keeps ~24 floats a lane per cell out of the registers. Each
// weight matrix sits once in shared memory with an odd row stride, so
// the products with W and with W^T are free of bank conflicts.
//
// The weight gradients are sums over B*H*W cells (x4 corners for dWo
// and dWf). As in the stencil backward, the grid is persistent and each
// block adds the tiles of its 8 warps' rows into accumulators in its
// shared memory, writes one fp32 partial of every gradient, and a second
// kernel sums the partials in block order: no atomics, the result
// repeats bit for bit.
//
// Widths: h up to 64, ff up to 32. At h=64 one block holds the five
// weight matrices (83 KB), five h x h accumulators and dWf's (82 KB) and
// the row tiles (20 KB): one block an SM. At 96, the forward's cap, the
// matrices and accumulators alone would take ~370 KB, above the 227 KB a
// block may have. The wrapper raises above 64
// (ops/hop_kernel.py::MAX_BWD_WIDTH).

#include "warp_rows.cuh"

namespace {

using namespace p4t;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;  // tile_xty's 16 x 16 thread grid
static_assert(THREADS == 256, "tile_xty needs 256 threads");
constexpr int MAX_FF = 32;

struct Args {
  const float* psg[4];
  const float *vd, *feats;
  const float *wf, *bf, *wd, *wo, *bo, *lns, *lnb;
  const float *nd0a, *nd0b, *nb0, *nd1, *nb1, *nlns;
  const float* g;
  float* dpsg[4];
  float *dvd, *partial;
  int B, HW, h, ff, mean;
};

template <int J, int P>
constexpr size_t smem_floats() {
  constexpr int HP = 32 * J, LD = HP + 1, R = WARPS * P;
  // Wd, Wo, Nd0a, Nd0b, Nd1; Wf; 7 vectors; 5 h x h accumulators + dWf;
  // 5 row tiles
  return 5 * HP * LD + MAX_FF * HP + 7 * HP + 5 * HP * HP + MAX_FF * HP + 5 * R * HP;
}

// Corner k of P cells: its pre-activation, silu' factor, silu and the
// normalised LayerNorm input xh (with inv), recomputed in both passes.
// psg: corner k's upsampled projections; fe_k: feats + k*HW*ff.
template <int J, int P>
__device__ __forceinline__ void corner(const float* __restrict__ psg,
                                       const float* __restrict__ fe_k,
                                       const long long (&cell)[P], const long long (&q)[P],
                                       const bool (&valid)[P], const float (&pd)[P][J],
                                       const float* __restrict__ s_wf,
                                       const float* __restrict__ s_bf,
                                       const float* __restrict__ s_bo,
                                       const float* __restrict__ s_wo, int h, int ff, int lane,
                                       float (&pre)[P][J], float (&sg)[P][J], float (&z)[P][J],
                                       float (&xh)[P][J], float (&inv)[P]) {
  constexpr int HP = 32 * J, LD = HP + 1;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float* fe = fe_k + q[p] * ff;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      float pf = 0.f;
      for (int i = 0; i < ff; ++i) pf = fmaf(fe[i], s_wf[i * HP + c], pf);
      const float s = (valid[p] && c < h) ? psg[cell[p] * h + c] : 0.f;
      pre[p][j] = pf + s_bf[c] + s + pd[p][j];
      sg[p][j] = 1.f / (1.f + expf(-pre[p][j]));
      z[p][j] = pre[p][j] * sg[p][j];
      xh[p][j] = s_bo[c];
    }
  }
  row_matmul<J, P>(z, xh, s_wo, h, lane, LD);
#pragma unroll
  for (int p = 0; p < P; ++p) inv[p] = ln_normalize<J>(xh[p], h, lane);
}

template <int J, int P>
__global__ void __launch_bounds__(THREADS) corner_hop_bwd(Args a) {
  constexpr int HP = 32 * J, LD = HP + 1, R = WARPS * P;
  const int h = a.h, ff = a.ff, HW = a.HW;
  extern __shared__ float smem[];
  float* s_wd = smem;  // five [HP][LD] matrices
  float* s_wo = s_wd + HP * LD;
  float* s_n0a = s_wo + HP * LD;
  float* s_n0b = s_n0a + HP * LD;
  float* s_n1 = s_n0b + HP * LD;
  float* s_wf = s_n1 + HP * LD;       // [MAX_FF][HP]
  float* s_bf = s_wf + MAX_FF * HP;   // [HP] each
  float* s_bo = s_bf + HP;
  float* s_lns = s_bo + HP;
  float* s_lnb = s_lns + HP;
  float* s_nb0 = s_lnb + HP;
  float* s_nb1 = s_nb0 + HP;
  float* s_nlns = s_nb1 + HP;
  float* s_dwd = s_nlns + HP;         // [HP][HP] accumulators
  float* s_dwo = s_dwd + HP * HP;
  float* s_dn0a = s_dwo + HP * HP;
  float* s_dn0b = s_dn0a + HP * HP;
  float* s_dn1 = s_dn0b + HP * HP;
  float* s_dwf = s_dn1 + HP * HP;     // [MAX_FF][HP]
  float* t0 = s_dwf + MAX_FF * HP;    // five [R][HP] row tiles
  float* t1 = t0 + R * HP;
  float* t2 = t1 + R * HP;
  float* t3 = t2 + R * HP;
  float* t4 = t3 + R * HP;
  stage_ld<J>(s_wd, a.wd, h, h, LD);
  stage_ld<J>(s_wo, a.wo, h, h, LD);
  stage_ld<J>(s_n0a, a.nd0a, h, h, LD);
  stage_ld<J>(s_n0b, a.nd0b, h, h, LD);
  stage_ld<J>(s_n1, a.nd1, h, h, LD);
  stage<J>(s_wf, a.wf, ff, h);
  stage<J>(s_bf, a.bf, 1, h);
  stage<J>(s_bo, a.bo, 1, h);
  stage<J>(s_lns, a.lns, 1, h);
  stage<J>(s_lnb, a.lnb, 1, h);
  stage<J>(s_nb0, a.nb0, 1, h);
  stage<J>(s_nb1, a.nb1, 1, h);
  stage<J>(s_nlns, a.nlns, 1, h);
  for (int i = threadIdx.x; i < 5 * HP * HP + MAX_FF * HP; i += THREADS) s_dwd[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_cells = (long long)a.B * HW;
  const long long n_groups = (n_cells + R - 1) / R;
  // per-lane sums of the vector gradients over this block's cells
  float v_bf[J], v_bo[J], v_lns[J], v_lnb[J], v_nb0[J], v_nb1[J], v_nlns[J], v_nlnb[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    v_bf[j] = v_bo[j] = v_lns[j] = v_lnb[j] = v_nb0[j] = v_nb1[j] = v_nlns[j] = v_nlnb[j] = 0.f;

  for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    long long cell[P], q[P];
    bool valid[P];
    float vd[P][J], pd[P][J], agg[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cell[p] = grp * R + warp * P + p;
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
    row_matmul<J, P>(vd, pd, s_wd, h, lane, LD);

    // ---- pass 1: recompute agg and the node MLP
    for (int k = 0; k < 4; ++k) {
      // a select, not a.psg[k]: a runtime index into the parameter
      // struct would copy it to local memory
      const float* psg = k == 0 ? a.psg[0] : k == 1 ? a.psg[1] : k == 2 ? a.psg[2] : a.psg[3];
      float pre[P][J], sg[P][J], z[P][J], xh[P][J], inv[P];
      corner<J, P>(psg, a.feats + (long long)k * HW * ff, cell, q, valid, pd, s_wf, s_bf,
                   s_bo, s_wo, h, ff, lane, pre, sg, z, xh, inv);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          agg[p][j] += fmaf(xh[p][j], s_lns[c], s_lnb[c]);
        }
    }
    float upre[P][J], dvd[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (a.mean) agg[p][j] *= 0.25f;
        upre[p][j] = s_nb0[lane + 32 * j];
      }
    row_matmul<J, P>(vd, upre, s_n0a, h, lane, LD);
    row_matmul<J, P>(agg, upre, s_n0b, h, lane, LD);
    float u[P][J], xn[P][J], inv_n[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        u[p][j] = upre[p][j] / (1.f + expf(-upre[p][j]));
        xn[p][j] = s_nb1[lane + 32 * j];
      }
    row_matmul<J, P>(u, xn, s_n1, h, lane, LD);

    // ---- node backward
    float dy[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      inv_n[p] = ln_normalize<J>(xn[p], h, lane);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        dvd[p][j] = (valid[p] && c < h) ? a.g[cell[p] * h + c] : 0.f;
        dy[p][j] = dvd[p][j];
        v_nlns[j] = fmaf(dy[p][j], xn[p][j], v_nlns[j]);
        v_nlnb[j] += dy[p][j];
      }
      ln_backward<J>(dy[p], xn[p], inv_n[p], s_nlns, h, lane);
#pragma unroll
      for (int j = 0; j < J; ++j) v_nb1[j] += dy[p][j];
    }
    float dup[P][J], dagg[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) dup[p][j] = dagg[p][j] = 0.f;
    row_matmul_t<J, P>(dy, dup, s_n1, h, lane, LD);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float s = 1.f / (1.f + expf(-upre[p][j]));
        dup[p][j] *= s * (1.f + upre[p][j] * (1.f - s));
        v_nb0[j] += dup[p][j];
      }
    row_matmul_t<J, P>(dup, dvd, s_n0a, h, lane, LD);  // dvd = g + dupre @ Nd0a^T
    row_matmul_t<J, P>(dup, dagg, s_n0b, h, lane, LD);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = warp * P + p;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (a.mean) dagg[p][j] *= 0.25f;
        // rows of cells past the end hold dy = dupre = 0 and add nothing
        t0[r * HP + c] = u[p][j];
        t1[r * HP + c] = dy[p][j];
        t2[r * HP + c] = vd[p][j];
        t3[r * HP + c] = dup[p][j];
        t4[r * HP + c] = agg[p][j];
      }
    }
    __syncthreads();
    tile_xty<J>(s_dn1, t0, t1, R, h);
    tile_xty<J>(s_dn0a, t2, t3, R, h);
    tile_xty<J>(s_dn0b, t4, t3, R, h);
    __syncthreads();

    // ---- pass 2: per-corner backward
    float dpd[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) dpd[p][j] = 0.f;
    for (int k = 0; k < 4; ++k) {
      const float* psg = k == 0 ? a.psg[0] : k == 1 ? a.psg[1] : k == 2 ? a.psg[2] : a.psg[3];
      float pre[P][J], sg[P][J], z[P][J], xh[P][J], inv[P];
      corner<J, P>(psg, a.feats + (long long)k * HW * ff, cell, q, valid, pd, s_wf, s_bf,
                   s_bo, s_wo, h, ff, lane, pre, sg, z, xh, inv);
      float dt[P][J], dp[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          dt[p][j] = dagg[p][j];
          v_lns[j] = fmaf(dagg[p][j], xh[p][j], v_lns[j]);
          v_lnb[j] += dagg[p][j];
          dp[p][j] = 0.f;
        }
        ln_backward<J>(dt[p], xh[p], inv[p], s_lns, h, lane);
#pragma unroll
        for (int j = 0; j < J; ++j) v_bo[j] += dt[p][j];
      }
      row_matmul_t<J, P>(dt, dp, s_wo, h, lane, LD);
      float* dpsg = k == 0 ? a.dpsg[0] : k == 1 ? a.dpsg[1] : k == 2 ? a.dpsg[2] : a.dpsg[3];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int r = warp * P + p;
        const float* fe = a.feats + ((long long)k * HW + q[p]) * ff;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          dp[p][j] *= sg[p][j] * (1.f + pre[p][j] * (1.f - sg[p][j]));
          v_bf[j] += dp[p][j];
          dpd[p][j] += dp[p][j];
          if (valid[p] && c < h) dpsg[cell[p] * h + c] = dp[p][j];
          t0[r * HP + c] = z[p][j];
          t1[r * HP + c] = dt[p][j];
          t2[r * HP + c] = dp[p][j];
          t3[r * HP + c] = c < ff ? fe[c] : 0.f;
        }
      }
      __syncthreads();
      tile_xty<J>(s_dwo, t0, t1, R, h);
      tile_xty<J>(s_dwf, t3, t2, R, ff);
      __syncthreads();
    }

    // ---- the destination projection's backward
    row_matmul_t<J, P>(dpd, dvd, s_wd, h, lane, LD);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = warp * P + p;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (valid[p] && c < h) a.dvd[cell[p] * h + c] = dvd[p][j];
        t0[r * HP + c] = vd[p][j];
        t1[r * HP + c] = dpd[p][j];
      }
    }
    __syncthreads();
    tile_xty<J>(s_dwd, t0, t1, R, h);
    __syncthreads();
  }

  // this block's partial, in the wrapper's order: dWf, dbf, dWd, dWo, dbo,
  // dlns, dlnb, dNd0a, dNd0b, dnb0, dNd1, dnb1, dnlns, dnlnb; the vector
  // sums go through the tiles, summed in warp order
  float* s_red = t0;  // [WARPS][8][HP]
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    float* w = s_red + warp * 8 * HP + c;
    w[0 * HP] = v_bf[j];
    w[1 * HP] = v_bo[j];
    w[2 * HP] = v_lns[j];
    w[3 * HP] = v_lnb[j];
    w[4 * HP] = v_nb0[j];
    w[5 * HP] = v_nb1[j];
    w[6 * HP] = v_nlns[j];
    w[7 * HP] = v_nlnb[j];
  }
  __syncthreads();
  const int hh = h * h;
  const int n_total = ff * h + 5 * hh + 8 * h;
  float* out = a.partial + (long long)blockIdx.x * n_total;
  auto put_mat = [&](int off, const float* acc, int rows) {
    for (int i = threadIdx.x; i < rows * h; i += THREADS) out[off + i] = acc[(i / h) * HP + i % h];
  };
  auto put_vec = [&](int off, int v) {
    for (int c = threadIdx.x; c < h; c += THREADS) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += s_red[(w * 8 + v) * HP + c];
      out[off + c] = s;
    }
  };
  int off = 0;
  put_mat(off, s_dwf, ff); off += ff * h;
  put_vec(off, 0); off += h;            // dbf
  put_mat(off, s_dwd, h); off += hh;
  put_mat(off, s_dwo, h); off += hh;
  put_vec(off, 1); off += h;            // dbo
  put_vec(off, 2); off += h;            // dlns
  put_vec(off, 3); off += h;            // dlnb
  put_mat(off, s_dn0a, h); off += hh;
  put_mat(off, s_dn0b, h); off += hh;
  put_vec(off, 4); off += h;            // dnb0
  put_mat(off, s_dn1, h); off += hh;
  put_vec(off, 5); off += h;            // dnb1
  put_vec(off, 6); off += h;            // dnlns
  put_vec(off, 7);                      // dnlnb
}

template <int J, int P>
cudaError_t grid(int B, int HW, int* blocks) {
  const size_t smem = smem_floats<J, P>() * sizeof(float);
  auto kernel = corner_hop_bwd<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // one block a group of WARPS * P cells, as the kernel's loop takes them
  return grid_for(kernel, THREADS, smem, ((long long)B * HW + P - 1) / P, blocks);
}

template <int J, int P>
cudaError_t launch(const Args& a, float* dw, int blocks, cudaStream_t stream) {
  const size_t smem = smem_floats<J, P>() * sizeof(float);
  auto kernel = corner_hop_bwd<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(a.partial, dw, a.ff * a.h + 5 * a.h * a.h + 8 * a.h, blocks,
                             stream);
}

}  // namespace

// C entry: the number of blocks p4t_corner_hop_bwd launches for these
// sizes (its partial buffer holds that many (ff*h + 5h*h + 8h)-float
// partials). h <= 64, ff <= 32. Returns a cudaError_t.
extern "C" int p4t_corner_hop_bwd_grid(int B, int H, int W, int h, int ff, int* blocks) {
  if (ff > MAX_FF) return (int)cudaErrorInvalidValue;
  switch ((h + 31) / 32) {
    case 1: return grid<1, 4>(B, H * W, blocks);
    case 2: return grid<2, 2>(B, H * W, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry: the corner hop's backward on `stream` for the cotangent g
// (B, H, W, h) of v_out. Inputs as the forward's (psg_k, vd: (B, H, W, h);
// feats: (4, H, W, ff); wf: (ff, h); wd, wo, nd0a, nd0b, nd1: (h, h);
// the vectors (h,)). Writes dpsg0..3 and dvd (B, H, W, h), and
// dw = [dWf | dbf | dWd | dWo | dbo | dlns | dlnb | dNd0a | dNd0b | dnb0 |
// dNd1 | dnb1 | dnlns | dnlnb] through `partial` (blocks x that size,
// blocks from p4t_corner_hop_bwd_grid). nlnb takes no part in the
// gradients. All fp32, contiguous, on the current device; h <= 64 and
// ff <= 32 (the caller checks). Returns the cudaError_t of the launches.
extern "C" int p4t_corner_hop_bwd(const float* psg0, const float* psg1, const float* psg2,
                                  const float* psg3, const float* vd, const float* feats,
                                  const float* wf, const float* bf, const float* wd,
                                  const float* wo, const float* bo, const float* lns,
                                  const float* lnb, const float* nd0a, const float* nd0b,
                                  const float* nb0, const float* nd1, const float* nb1,
                                  const float* nlns, const float* nlnb, const float* g,
                                  float* dpsg0, float* dpsg1, float* dpsg2, float* dpsg3,
                                  float* dvd, float* partial, float* dw, int B, int H, int W,
                                  int h, int ff, int mean, int blocks, void* stream) {
  (void)nlnb;
  Args a{{psg0, psg1, psg2, psg3}, vd, feats, wf, bf, wd, wo, bo, lns, lnb,
         nd0a, nd0b, nb0, nd1, nb1, nlns, g, {dpsg0, dpsg1, dpsg2, dpsg3},
         dvd, partial, B, H * W, h, ff, mean};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ff > MAX_FF) return (int)cudaErrorInvalidValue;
  switch ((h + 31) / 32) {
    case 1: return launch<1, 4>(a, dw, blocks, s);
    case 2: return launch<2, 2>(a, dw, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
