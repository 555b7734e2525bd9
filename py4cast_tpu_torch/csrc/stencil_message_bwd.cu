// Lattice stencil edge message, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel py4cast_tpu/ops/stencil_kernel.py::_bwd_kernel
// (called through _bwd_call; its lane-packed twin _bwd_kernel_packed is
// a TPU layout device with the same math). Per lattice cell and each of
// its 8 directions k it recomputes the forward (pre, silu, the LayerNorm
// statistics) and runs the chain back:
//
//   g     = g_out_k + g_agg * mask_k
//   dt    = LN backward of g;   dWo += z^T dt,  dbo += dt
//   dpre  = (dt @ Wo^T) * silu'(pre);   dWe += e_k^T dpre,  dbe += dpre
//   de_k  = dpre @ We^T (+ g_out_k when residual);  dvs_k = dpre
//   dpd   = sum_k dpre
//
// What bounds it on the H100: at the GraphLAM level-0 lattice (125x125,
// h=64, fp32) the function must move ~172 MB (e, vs, g_out, de, dvs at
// 32 MB each; pd, g_agg, dpd at 4 MB; ~51 us at 3.35 TB/s) and do ~6.3
// GFLOP (six h x h products per cell and direction: two recomputed, two
// transposed, two weight-gradient updates; ~94 us at the 67 TFLOP/s
// CUDA-core peak): it is bound by operations.
//
// What the design does about it: as in the forward, one warp owns P
// cells and keeps each row in registers (lane l holds channels l, l+32),
// and every intermediate stays in registers; device memory sees only
// the true inputs and outputs. Both weight matrices sit once in shared
// memory with an odd row stride, so the products with W and with W^T
// read them free of bank conflicts.
//
// The weight gradients are sums over 8*B*H*W rows (1 M at level 0);
// the TPU's sequential grid added them up in place, Hopper's blocks run
// in parallel in no order. So the grid is persistent (as many blocks as
// the SMs hold) and each block adds, after every direction, the tile of
// its 8 warps' rows (z, dt, e, dpre) into two h x h accumulators in its
// shared memory (each of 256 threads a 2J x 2J patch summed in
// registers). Each block writes one fp32 partial of every weight
// gradient; a second kernel sums the partials in block order. No
// atomics: the result repeats bit for bit from run to run.
//
// Widths: F and h up to 64 (J <= 2). At h=64 one block holds both
// matrices (33 KB), both accumulators (32 KB) and the row tiles (16 KB);
// at 128 the matrices and accumulators alone would take 264 KB, above
// the 227 KB a block may have, and at 96 the per-cell rows the backward
// keeps live (twice the forward's) would spill. The wrapper raises above
// 64 (ops/stencil_kernel.py::MAX_BWD_WIDTH).

#include "warp_rows.cuh"

namespace {

using namespace p4t;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;  // tile_xty's 16 x 16 thread grid
static_assert(THREADS == 256, "tile_xty needs 256 threads");

struct Args {
  const float *e, *vs, *pd, *mask, *we, *be, *wo, *bo, *lns, *g_out, *g_agg;
  float *de, *dvs, *dpd, *partial;
  int B, HW, F, h, residual;
};

template <int J, int P>
constexpr size_t smem_floats() {
  constexpr int HP = 32 * J, LD = HP + 1, R = WARPS * P;
  // We, Wo; be, bo, lns; dWe, dWo accumulators; 4 row tiles
  return 2 * HP * LD + 3 * HP + 2 * HP * HP + 4 * R * HP;
}

template <int J, int P>
__global__ void __launch_bounds__(THREADS) stencil_message_bwd(Args a) {
  constexpr int HP = 32 * J, LD = HP + 1, R = WARPS * P;
  const int F = a.F, h = a.h, HW = a.HW;
  extern __shared__ float smem[];
  float* s_we = smem;              // [HP][LD]
  float* s_wo = s_we + HP * LD;    // [HP][LD]
  float* s_be = s_wo + HP * LD;    // [HP] each
  float* s_bo = s_be + HP;
  float* s_lns = s_bo + HP;
  float* s_dwe = s_lns + HP;       // [HP][HP] accumulators
  float* s_dwo = s_dwe + HP * HP;
  float* t_e = s_dwo + HP * HP;    // [R][HP] row tiles
  float* t_dp = t_e + R * HP;
  float* t_z = t_dp + R * HP;
  float* t_dt = t_z + R * HP;
  stage_ld<J>(s_we, a.we, F, h, LD);
  stage_ld<J>(s_wo, a.wo, h, h, LD);
  stage<J>(s_be, a.be, 1, h);
  stage<J>(s_bo, a.bo, 1, h);
  stage<J>(s_lns, a.lns, 1, h);
  for (int i = threadIdx.x; i < 2 * HP * HP; i += THREADS) s_dwe[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_cells = (long long)a.B * HW;
  const long long n_groups = (n_cells + R - 1) / R;
  // per-lane sums of the vector gradients over this block's rows
  float v_be[J], v_bo[J], v_lns[J], v_lnb[J];
#pragma unroll
  for (int j = 0; j < J; ++j) v_be[j] = v_bo[j] = v_lns[j] = v_lnb[j] = 0.f;

  for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    long long cell[P], bq[P], q[P];
    bool valid[P];
    float pdr[P][J], gag[P][J], dpd[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cell[p] = grp * R + warp * P + p;
      valid[p] = cell[p] < n_cells;
      bq[p] = valid[p] ? cell[p] / HW : 0;
      q[p] = valid[p] ? cell[p] - bq[p] * HW : 0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        const bool in = valid[p] && c < h;
        pdr[p][j] = in ? a.pd[cell[p] * h + c] : 0.f;
        gag[p][j] = in ? a.g_agg[cell[p] * h + c] : 0.f;
        dpd[p][j] = 0.f;
      }
    }
    for (int k = 0; k < 8; ++k) {
      long long row[P];  // (b, k, q) row of the (B, 8, H, W, .) arrays
      float ek[P][J], pre[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        row[p] = (bq[p] * 8 + k) * HW + q[p];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          ek[p][j] = (valid[p] && c < F) ? a.e[row[p] * F + c] : 0.f;
          const float v = (valid[p] && c < h) ? a.vs[row[p] * h + c] : 0.f;
          pre[p][j] = s_be[c] + v + pdr[p][j];
        }
      }
      row_matmul<J, P>(ek, pre, s_we, F, lane, LD);
      float sg[P][J], z[P][J], xh[P][J], inv[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          sg[p][j] = 1.f / (1.f + expf(-pre[p][j]));
          z[p][j] = pre[p][j] * sg[p][j];
          xh[p][j] = s_bo[lane + 32 * j];
        }
      row_matmul<J, P>(z, xh, s_wo, h, lane, LD);
      // g -> dt through the LayerNorm; the vector gradients on the way
      float dt[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        inv[p] = ln_normalize<J>(xh[p], h, lane);
        const float m = valid[p] ? a.mask[(long long)k * HW + q[p]] : 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          const float go = (valid[p] && c < h) ? a.g_out[row[p] * h + c] : 0.f;
          dt[p][j] = fmaf(gag[p][j], m, go);
          v_lns[j] = fmaf(dt[p][j], xh[p][j], v_lns[j]);
          v_lnb[j] += dt[p][j];
        }
        ln_backward<J>(dt[p], xh[p], inv[p], s_lns, h, lane);
#pragma unroll
        for (int j = 0; j < J; ++j) v_bo[j] += dt[p][j];
      }
      // dpre = (dt @ Wo^T) * silu'(pre)
      float dp[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < J; ++j) dp[p][j] = 0.f;
      row_matmul_t<J, P>(dt, dp, s_wo, h, lane, LD);
      float de[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          dp[p][j] *= sg[p][j] * (1.f + pre[p][j] * (1.f - sg[p][j]));
          v_be[j] += dp[p][j];
          dpd[p][j] += dp[p][j];
          de[p][j] = (a.residual && valid[p] && c < h) ? a.g_out[row[p] * h + c] : 0.f;
        }
      row_matmul_t<J, P>(dp, de, s_we, h, lane, LD);
      // outputs, and this direction's rows into the block's tiles (rows
      // of cells past the end hold dt = dpre = e = 0 and add nothing)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int r = warp * P + p;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          if (valid[p]) {
            if (c < F) a.de[row[p] * F + c] = de[p][j];
            if (c < h) a.dvs[row[p] * h + c] = dp[p][j];
          }
          t_e[r * HP + c] = ek[p][j];
          t_dp[r * HP + c] = dp[p][j];
          t_z[r * HP + c] = z[p][j];
          t_dt[r * HP + c] = dt[p][j];
        }
      }
      __syncthreads();
      tile_xty<J>(s_dwe, t_e, t_dp, R, F);
      tile_xty<J>(s_dwo, t_z, t_dt, R, h);
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (!valid[p]) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < h) a.dpd[cell[p] * h + c] = dpd[p][j];
      }
    }
  }

  // this block's partial: dWe, dbe, dWo, dbo, dlns, dlnb (the wrapper's
  // order); the vector sums go through the tiles, summed in warp order
  float* s_red = t_e;  // [WARPS][4][HP]
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    s_red[(warp * 4 + 0) * HP + c] = v_be[j];
    s_red[(warp * 4 + 1) * HP + c] = v_bo[j];
    s_red[(warp * 4 + 2) * HP + c] = v_lns[j];
    s_red[(warp * 4 + 3) * HP + c] = v_lnb[j];
  }
  __syncthreads();
  const int n_total = F * h + h * h + 4 * h;
  float* out = a.partial + (long long)blockIdx.x * n_total;
  for (int i = threadIdx.x; i < F * h; i += THREADS) out[i] = s_dwe[(i / h) * HP + i % h];
  out += F * h;
  for (int i = threadIdx.x; i < h * h; i += THREADS)
    out[h + i] = s_dwo[(i / h) * HP + i % h];
  for (int i = threadIdx.x; i < 4 * h; i += THREADS) {
    const int v = i / h, c = i % h;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += s_red[(w * 4 + v) * HP + c];
    // dbe sits before dWo, the other three after it
    out[v == 0 ? c : h + h * h + (v - 1) * h + c] = s;
  }
}

template <int J, int P>
cudaError_t grid(int B, int HW, int* blocks) {
  const size_t smem = smem_floats<J, P>() * sizeof(float);
  auto kernel = stencil_message_bwd<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // one block a group of WARPS * P cells, as the kernel's loop takes them
  return grid_for(kernel, THREADS, smem, ((long long)B * HW + P - 1) / P, blocks);
}

template <int J, int P>
cudaError_t launch(const Args& a, float* dw, int blocks, cudaStream_t stream) {
  const size_t smem = smem_floats<J, P>() * sizeof(float);
  auto kernel = stencil_message_bwd<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(a.partial, dw, a.F * a.h + a.h * a.h + 4 * a.h, blocks, stream);
}

}  // namespace

// C entry: the number of blocks p4t_stencil_message_bwd launches for
// these sizes (its partial buffer holds that many (F*h + h*h + 4h)-float
// partials). F, h <= 64. Returns a cudaError_t.
extern "C" int p4t_stencil_message_bwd_grid(int B, int H, int W, int F, int h, int* blocks) {
  switch (((F > h ? F : h) + 31) / 32) {
    case 1: return grid<1, 4>(B, H * W, blocks);
    case 2: return grid<2, 2>(B, H * W, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry: the stencil message's backward on `stream`. Inputs as the
// forward's (e: (B, 8, H, W, F); vs: (B, 8, H, W, h); pd: (B, H, W, h);
// mask: (8, H, W, 1); we: (F, h); wo: (h, h); be, bo, lns, lnb: (h,))
// plus g_out (B, 8, H, W, h) and g_agg (B, H, W, h). Writes de, dvs,
// dpd, and dw = [dWe | dbe | dWo | dbo | dlns | dlnb] (F*h + h*h + 4h
// floats) through `partial` (blocks x that size, blocks from
// p4t_stencil_message_bwd_grid). lnb takes no part in the gradients.
// All fp32, contiguous, on the current device; F, h <= 64 (the caller
// checks). Returns the cudaError_t of the launches.
extern "C" int p4t_stencil_message_bwd(const float* e, const float* vs, const float* pd,
                                       const float* mask, const float* we, const float* be,
                                       const float* wo, const float* bo, const float* lns,
                                       const float* lnb, const float* g_out, const float* g_agg,
                                       float* de, float* dvs, float* dpd, float* partial,
                                       float* dw, int B, int H, int W, int F, int h,
                                       int residual, int blocks, void* stream) {
  (void)lnb;
  Args a{e, vs, pd, mask, we, be, wo, bo, lns, g_out, g_agg,
         de, dvs, dpd, partial, B, H * W, F, h, residual};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (((F > h ? F : h) + 31) / 32) {
    case 1: return launch<1, 4>(a, dw, blocks, s);
    case 2: return launch<2, 2>(a, dw, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
