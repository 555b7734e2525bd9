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
// CUDA-core peak): it is bound by operations, so by how many FMAs the
// SMs issue per shared-memory load and per barrier.
//
// What the design does about it (the building blocks are row_tiles.cuh):
// a block of 256 threads walks row tiles of BM rows, a row being one
// (cell, direction); a tile holds BM/8 whole cells, their 8 directions
// side by side. Each of the four row products (e@We and z@Wo recomputed,
// dt@Wo^T, dpre@We^T) is a block product on register micro-tiles of 4
// rows x 4 columns, fed by 128-bit shared loads (8 loads for 64 FMAs, no
// shuffle); the row-wise work (bias, silu and its derivative, the
// LayerNorm forward and backward, the masked cotangent, the residual)
// runs on the same micro-tiles, a row's sums reduced over the 16 (8 at
// h <= 32) lanes that share it. The rows of e, z, dt and dpre (silu'
// before it) sit in four [BM][HP] tiles; vs, pd, g_out, g_agg and mask
// go from device memory straight into the micro-tiles, and de, dvs, dpd
// straight out. The next tile's e arrives by cp.async while the current
// tile finishes (into the tile z has just freed, so the two swap roles
// every tile). 4 barriers a tile.
//
// The weight gradients are sums over 8*B*H*W rows (1 M at level 0); the
// TPU's sequential grid added them up in place, Hopper's blocks run in
// parallel in no order. Each thread owns a 4x4 patch of dWe and of dWo
// and adds e^T dpre and z^T dt into it over every tile its block walks,
// BM rows at a time: the dWe patch stays in registers for the whole
// walk, the dWo patch in the thread's own slot of shared memory (read
// and written once a tile, no barrier). The vector gradients are
// per-thread sums in registers. Each block writes one fp32 partial at
// the end of its walk (the threads' sums added in a fixed order), and
// sum_partials_by_warps adds the partials in a fixed order, eight warps
// a column block. No atomics: the result repeats bit for bit.
//
// The grid is persistent: as many blocks as the SMs hold, fewer when the
// tiles are fewer, balanced so that no block takes more tiles than it
// must (p4t_stencil_message_bwd_grid).
//
// Widths: F and h up to 64, two instances: HP = 64 (BM = 64 rows, 8
// cells) and HP = 32 (BM = 128 rows, 16 cells; the 64 dW patches shared
// by 4 thread groups, each over a quarter of the rows). At HP = 64 a
// block holds both matrices (32 KB), the four row tiles (64 KB) and the
// dWo patches (16 KB); its threads take ~170 registers, so one block of
// 8 warps runs an SM (at 128 registers, for two blocks, ptxas spills).
// At 128 the matrices and tiles alone would take 192 KB and the dWe
// patches 64 registers a thread: the wrapper raises above 64
// (ops/stencil_kernel.py::MAX_BWD_WIDTH).

#include <cstdint>

#include "row_tiles.cuh"

namespace {

using namespace p4t;
using namespace p4t::rt;

struct Args {
  const float *e, *vs, *pd, *mask, *we, *be, *wo, *bo, *lns, *g_out, *g_agg;
  float *de, *dvs, *dpd, *partial;
  int B, HW, F, h, residual;
  int vec;  // F and h multiples of 4, every row array 16-byte aligned
};

template <int HP>
struct Shape {
  static constexpr int NX = HP / 4;            // lanes a row (4 columns each)
  static constexpr int NY = THREADS / NX;      // row groups
  static constexpr int TM = 4;                 // rows a thread
  static constexpr int BM = NY * TM;           // rows a tile
  static constexpr int CT = BM / 8;            // cells a tile
  static constexpr int PT = NX * NX;           // 4x4 patches of an HP x HP gradient
  static constexpr int G = THREADS / PT;       // thread groups sharing the patches
  // We, Wo (swizzled); be, bo, lns (and a pad); four row tiles; the dWo
  // accumulators of the G thread groups
  static constexpr size_t smem_floats = 2 * HP * HP + 4 * HP + 4 * BM * HP + G * HP * HP;
  static constexpr size_t smem_bytes = smem_floats * sizeof(float);
  static_assert(8 % TM == 0 && BM % 8 == 0, "a thread's rows are directions of one cell");
  static_assert(THREADS % PT == 0, "");
  static_assert(NY * 4 * HP + G * HP * HP <= 2 * HP * HP + 4 * HP + 4 * BM * HP,
                "the end sums fit below the dWo accumulators");
};

template <int HP>
__global__ void __launch_bounds__(THREADS, 1) stencil_message_bwd(Args a) {
  using S = Shape<HP>;
  constexpr int NX = S::NX, NY = S::NY, TM = S::TM, BM = S::BM, CT = S::CT, G = S::G;
  const int F = a.F, h = a.h, HW = a.HW;
  const bool vec = a.vec != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_we = smem;             // [HP][HP] swizzled
  float* s_wo = s_we + HP * HP;   // [HP][HP] swizzled
  float* s_vec = s_wo + HP * HP;  // be, bo, lns: [3][HP] (+ pad)
  float* s_buf = s_vec + 4 * HP;  // [2][BM][HP]: e and z, swapping roles
  float* s_dt = s_buf + 2 * BM * HP;
  float* s_dp = s_dt + BM * HP;
  float* s_dwo = s_dp + BM * HP;  // [G][HP][HP]

  // 8 * B * H * W < 2^31 (the host checks): cell and row numbers are ints
  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + CT - 1) / CT;
  // rows of the (B, 8, H, W, .) arrays for the tile's cells, null past the end
  auto e_rows = [&](int tile) {
    return [=](int r) -> const float* {
      const int cell = tile * CT + r / 8;
      if (cell >= n_cells) return nullptr;
      const int b = cell / HW;
      return a.e + (long long)((b * 8 + r % 8) * HW + (cell - b * HW)) * F;
    };
  };

  int tile = blockIdx.x;
  if (tile < n_tiles) load_rows<BM, HP>(s_buf, e_rows(tile), F, vec, a.e);
  stage_swizzled<HP>(s_we, a.we, F, h);
  stage_swizzled<HP>(s_wo, a.wo, h, h);
  for (int i = threadIdx.x; i < 4 * HP; i += THREADS) {
    const int v = i / HP, c = i % HP;
    const float* src = v == 0 ? a.be : v == 1 ? a.bo : a.lns;
    s_vec[i] = (v < 3 && c < h) ? src[c] : 0.f;
  }
  for (int i = threadIdx.x; i < G * HP * HP; i += THREADS) s_dwo[i] = 0.f;

  const int tid = threadIdx.x, tx = tid % NX, ty = tid / NX;
  const int c0 = 4 * tx, r0 = TM * ty, k0 = r0 % 8;  // columns; rows; first direction
  // this thread's 4x4 patch of dWe (in registers) and of dWo (in its
  // group's shared accumulator), and its group's rows
  const int pg = tid / S::PT, pi = tid % S::PT;
  const int f0 = 4 * (pi / NX), pc0 = 4 * (pi % NX);
  const int pr0 = pg * (BM / G), pr1 = pr0 + BM / G;
  float* dwo_patch = s_dwo + (pg * HP + f0) * HP + pc0;
  float dwe[4][4], v_be[4], v_bo[4], v_lns[4], v_lnb[4];
  zero_tile<4>(dwe);
#pragma unroll
  for (int j = 0; j < 4; ++j) v_be[j] = v_bo[j] = v_lns[j] = v_lnb[j] = 0.f;
  wait_copies();
  __syncthreads();

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    float* s_e = s_buf + buf * BM * HP;
    float* s_z = s_buf + (buf ^ 1) * BM * HP;
    const int cell = tile * CT + r0 / 8;
    const bool valid = cell < n_cells;
    const int bq = valid ? cell / HW : 0, q = valid ? cell - bq * HW : 0;
    const long long row0 = (long long)(bq * 8 + k0) * HW + q;  // direction k0; + i*HW

    // Each step issues its loads from device memory before its product
    // and uses them after it, so the product hides their latency.
    // ---- pre = e @ We + be + vs + pd;  z = silu(pre) -> s_z, silu' -> s_dp
    float acc[TM][4], in[TM][4], in4[4] = {0.f, 0.f, 0.f, 0.f}, v4[4];
    zero_tile<TM>(in);
    if (valid) {
      load4(in4, a.pd + (long long)cell * h, c0, h, vec);
#pragma unroll
      for (int i = 0; i < TM; ++i) load4(in[i], a.vs + (row0 + i * HW) * h, c0, h, vec);
    }
    zero_tile<TM>(acc);
    tile_mm<HP, TM>(acc, s_e, r0, s_we, c0);
    lds4(v4, s_vec + c0);  // be
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = acc[i][j] + (in[i][j] + (in4[j] + v4[j]));
        const float sg = __frcp_rn(1.f + __expf(-p));
        in[i][j] = sg * (1.f + p * (1.f - sg));
        acc[i][j] = p * sg;
      }
    store_tile<HP, TM>(s_z, r0, c0, acc);
    store_tile<HP, TM>(s_dp, r0, c0, in);  // s_dp is free until dpre
    __syncthreads();

    // ---- t = z @ Wo + bo -> xhat;  g -> dt through the LayerNorm -> s_dt
    zero_tile<TM>(in);
    in4[0] = in4[1] = in4[2] = in4[3] = 0.f;
    float m[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) m[i] = 0.f;
    if (valid) {
      load4(in4, a.g_agg + (long long)cell * h, c0, h, vec);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        load4(in[i], a.g_out + (row0 + i * HW) * h, c0, h, vec);
        m[i] = a.mask[(long long)(k0 + i) * HW + q];
      }
    }
    zero_tile<TM>(acc);
    tile_mm<HP, TM>(acc, s_z, r0, s_wo, c0);
    lds4(v4, s_vec + HP + c0);  // bo
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += v4[j];
    lds4(v4, s_vec + 2 * HP + c0);  // lns
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float inv = ln_normalize4<NX>(acc[i], c0, h);  // acc[i] = xhat
      float* g = in[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[j] = fmaf(in4[j], m[i], g[j]);
        v_lns[j] = fmaf(g[j], acc[i][j], v_lns[j]);
        v_lnb[j] += g[j];
      }
      ln_backward4<NX>(in[i], acc[i], inv, v4, c0, h);
#pragma unroll
      for (int j = 0; j < 4; ++j) v_bo[j] += g[j];  // g = dt
    }
    store_tile<HP, TM>(s_dt, r0, c0, in);
    __syncthreads();

    // ---- dWo += z^T dt;  dpre = (dt @ Wo^T) * silu'(pre) -> dvs, s_dp
    {
      float dwo[4][4];
      load_tile<HP, 4>(dwo, dwo_patch, 0, 0);
      xty_acc<HP>(dwo, s_z, s_dt, f0, pc0, pr0, pr1);
      store_tile<HP, 4>(dwo_patch, 0, 0, dwo);
    }
    zero_tile<TM>(acc);
    tile_mm_t<HP, TM>(acc, s_dt, r0, s_wo, c0);
    load_tile<HP, TM>(in, s_dp, r0, c0);  // silu'(pre), this thread's own
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= in[i][j];
        v_be[j] += acc[i][j];
      }
      if (valid) store4(a.dvs + (row0 + i * HW) * h, c0, h, vec, acc[i]);
    }
    store_tile<HP, TM>(s_dp, r0, c0, acc);
    __syncthreads();  // s_dp complete; s_z and s_dt free

    // the next tile's e, into the tile z held, while this one finishes
    if (tile + gridDim.x < n_tiles)
      load_rows<BM, HP>(s_z, e_rows(tile + gridDim.x), F, vec, a.e);

    // ---- de = dpre @ We^T (+ g_out);  dWe += e^T dpre;  dpd = sum_k dpre
    zero_tile<TM>(in);
    if (a.residual && valid) {
#pragma unroll
      for (int i = 0; i < TM; ++i) load4(in[i], a.g_out + (row0 + i * HW) * h, c0, h, vec);
    }
    zero_tile<TM>(acc);
    tile_mm_t<HP, TM>(acc, s_dp, r0, s_we, c0);
    if (valid) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += in[i][j];
        store4(a.de + (row0 + i * HW) * F, c0, F, vec, acc[i]);
      }
    }
    xty_acc<HP>(dwe, s_e, s_dp, f0, pc0, pr0, pr1);
    for (int i = tid; i < CT * HP; i += THREADS) {
      const int cl = i / HP, c = i % HP;
      const int cc = tile * CT + cl;
      if (cc >= n_cells || c >= h) continue;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += s_dp[(cl * 8 + k) * HP + c];
      a.dpd[(long long)cc * h + c] = s;
    }
    wait_copies();
    __syncthreads();
  }

  // this block's partial: dWe, dbe, dWo, dbo, dlns, dlnb (the wrapper's
  // order). The vector sums go through shared memory by row group, the
  // dW patches by thread group, each added up in a fixed order.
  float* s_red = smem;                 // [NY][4][HP]
  float* s_gwe = s_red + NY * 4 * HP;  // [G][HP][HP]
  const float* s_gwo = s_dwo;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_red[(ty * 4 + 0) * HP + c0 + j] = v_be[j];
    s_red[(ty * 4 + 1) * HP + c0 + j] = v_bo[j];
    s_red[(ty * 4 + 2) * HP + c0 + j] = v_lns[j];
    s_red[(ty * 4 + 3) * HP + c0 + j] = v_lnb[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s_gwe[(pg * HP + f0 + i) * HP + pc0 + j] = dwe[i][j];
    }
  __syncthreads();
  const int n_total = F * h + h * h + 4 * h;
  float* out = a.partial + (long long)blockIdx.x * n_total;
  for (int i = tid; i < F * h; i += THREADS) {
    const int f = i / h, c = i % h;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) s += s_gwe[(g * HP + f) * HP + c];
    out[i] = s;
  }
  for (int i = tid; i < h * h; i += THREADS) {
    const int f = i / h, c = i % h;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) s += s_gwo[(g * HP + f) * HP + c];
    out[F * h + h + i] = s;
  }
  for (int i = tid; i < 4 * h; i += THREADS) {
    const int v = i / h, c = i % h;
    float s = 0.f;
    for (int y = 0; y < NY; ++y) s += s_red[(y * 4 + v) * HP + c];
    // dbe sits before dWo, the other three after it
    out[v == 0 ? F * h + c : F * h + h + h * h + (v - 1) * h + c] = s;
  }
}

template <int HP>
cudaError_t configure() {
  return cudaFuncSetAttribute(stencil_message_bwd<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Shape<HP>::smem_bytes);
}

template <int HP>
cudaError_t blocks_per_sm(int* per_sm) {
  cudaError_t err = configure<HP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, stencil_message_bwd<HP>, THREADS,
                                                       Shape<HP>::smem_bytes);
}

// As many blocks as the SMs hold, or fewer: the tiles spread evenly, so
// that no block takes more tiles than the largest share must.
template <int HP>
cudaError_t grid(int B, int HW, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<HP>(&per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = ((long long)B * HW + Shape<HP>::CT - 1) / Shape<HP>::CT;
  const long long cap = (long long)sms * per_sm;
  const long long per_block = (tiles + cap - 1) / cap;
  const long long n = (tiles + per_block - 1) / per_block;
  *blocks = (int)(n > 0 ? n : 1);
  return cudaSuccess;
}

template <int HP>
cudaError_t launch(const Args& a, float* dw, int blocks, cudaStream_t stream) {
  cudaError_t err = configure<HP>();
  if (err != cudaSuccess) return err;
  stencil_message_bwd<HP><<<blocks, THREADS, Shape<HP>::smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials_by_warps(a.partial, dw, a.F * a.h + a.h * a.h + 4 * a.h, blocks, stream);
}

template <int HP>
cudaError_t attributes(int* out) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm<HP>(&per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, stencil_message_bwd<HP>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)Shape<HP>::smem_bytes;
  out[3] = per_sm;
  out[4] = Shape<HP>::BM;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// C entry: the number of blocks p4t_stencil_message_bwd launches for
// these sizes (its partial buffer holds that many (F*h + h*h + 4h)-float
// partials). F, h <= 64. Returns a cudaError_t.
extern "C" int p4t_stencil_message_bwd_grid(int B, int H, int W, int F, int h, int* blocks) {
  if ((long long)B * H * W * 8 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int width = F > h ? F : h;
  if (width <= 32) return grid<32>(B, H * W, blocks);
  if (width <= 64) return grid<64>(B, H * W, blocks);
  return (int)cudaErrorInvalidValue;
}

// C entry: out[5] = registers a thread, local (spill) bytes a thread,
// dynamic shared memory bytes, resident blocks an SM and rows a tile of
// the kernel that p4t_stencil_message_bwd launches for widths F, h.
extern "C" int p4t_stencil_message_bwd_attributes(int F, int h, int* out) {
  const int width = F > h ? F : h;
  if (width <= 32) return attributes<32>(out);
  if (width <= 64) return attributes<64>(out);
  return (int)cudaErrorInvalidValue;
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
  if ((long long)B * H * W * 8 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bool vec = F % 4 == 0 && h % 4 == 0 && aligned16(e) && aligned16(vs) && aligned16(pd) &&
                   aligned16(g_out) && aligned16(g_agg) && aligned16(de) && aligned16(dvs);
  Args a{e, vs, pd, mask, we, be, wo, bo, lns, g_out, g_agg,
         de, dvs, dpd, partial, B, H * W, F, h, residual, vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = F > h ? F : h;
  if (width <= 32) return launch<32>(a, dw, blocks, s);
  if (width <= 64) return launch<64>(a, dw, blocks, s);
  return (int)cudaErrorInvalidValue;
}
