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
// patches 64 registers a thread, so these instances stop at 64.
//
// Wider (F or h from 65 to 512): stencil_message_bwd_wide, on
// wide_rows.cuh (HP = 128, 256 or 512; tiles of 64, 32 or 8 rows),
// replaces py4cast_tpu/ops/stencil_kernel.py::_bwd_kernel (:245) there. What
// bounds it there: at h = 128 the two matrices and four tiles would take
// 192 KB and the h x h gradient patches 64 registers a thread, at h = 256
// one matrix alone is 256 KB and the patches 256 floats a thread; the
// work (~12 h^2 FMA-pairs a row) makes it bound by operations (at the
// 125x125 level, h = 256: ~25 GFLOP, 0.38 ms at the fp32 peak, against
// ~0.6 GB, 0.18 ms). What the design does: the row steps (e @ We and z @
// Wo recomputed, the LayerNorm and silu backward, dt @ Wo^T, dpre @ We^T)
// run on four row tiles (e then g, z then g * xhat, dt, silu' then dpre),
// each product streaming its weight in chunks; z and dt go to a scratch
// array, and dWe = e^T dpre (dpre is dvs) and dWo = z^T dt are summed
// after the walk by wide::xty_partials, one fp32 partial a block over a
// slice of the rows; dbe, dbo, dlns and dlnb are per-tile column sums of
// the tiles into one per-block sum. rt::sum_partials_by_warps adds the
// partials; every sum runs in a fixed order, so a call repeats bit for
// bit. The scratch (2 x 8 B H W h floats) follows the partials in
// `partial` (p4t_stencil_message_bwd_scratch).

#include <cstdint>

#include "row_tiles.cuh"
#include "wide_rows.cuh"

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

// ------------------------------------------- wide rows (F or h > 64)
template <int HP>
struct WideShape {
  using C = wide::Cfg<HP>;
  static constexpr int CT = C::BM / 8;  // cells a tile
  // e (then g), z (then g * xhat), dt, silu' (then dpre); the weight
  // chunks; the block's dbe, dbo, dlns, dlnb
  static constexpr size_t smem_bytes = (4 * C::TILE + C::CHUNKS + 4 * HP) * sizeof(float);
  static_assert(smem_bytes <= 232448, "227 KB a block");
};

// The floats of one block's partial: dWe, dbe, dWo, dbo, dlns, dlnb.
__host__ __device__ inline long long partial_floats(int F, int h) {
  return (long long)F * h + (long long)h * h + 4 * h;
}

// Where the scratch begins in `partial`: after the blocks' partials, on a
// 16-byte boundary.
inline long long scratch_offset(int F, int h, int blocks) {
  return (blocks * partial_floats(F, h) + 3) / 4 * 4;
}

template <int HP>
__global__ void __launch_bounds__(THREADS, 1)
    stencil_message_bwd_wide(Args a, float* z_rows, float* dt_rows, int wvec_flag) {
  using namespace p4t::wide;
  using C = Cfg<HP>;
  constexpr int TM = C::TM, CJ = C::CJ, CT = WideShape<HP>::CT;
  const int F = a.F, h = a.h, HW = a.HW;
  const bool vec = a.vec != 0, wvec = wvec_flag != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_e = smem;  // four [BM][LD] row tiles
  float* s_z = s_e + C::TILE;
  float* s_dt = s_z + C::TILE;
  float* s_dp = s_dt + C::TILE;
  float* s_w = s_dp + C::TILE;     // the weight chunks
  float* s_sum = s_w + C::CHUNKS;  // [4][HP]: dbe, dbo, dlns, dlnb
  for (int i = threadIdx.x; i < 4 * HP; i += THREADS) s_sum[i] = 0.f;
  const Lane<C> t;
  const int r0 = TM * t.ty, k0 = r0 % 8;  // rows; first direction

  // 8 * B * H * W < 2^31 (the host checks): cell and row numbers are ints
  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + CT - 1) / CT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers of every tile are done
    fill_tile<C>(
        s_e,
        [=](int r) -> const float* {
          const int cell = tile * CT + r / 8;
          if (cell >= n_cells) return nullptr;
          const int b = cell / HW;
          return a.e + (long long)((b * 8 + r % 8) * HW + (cell - b * HW)) * F;
        },
        F, vec, a.e);
    const int cell = tile * CT + r0 / 8;
    const bool valid = cell < n_cells;
    const int bq = valid ? cell / HW : 0, q = valid ? cell - bq * HW : 0;
    const long long row0 = (long long)(bq * 8 + k0) * HW + q;  // direction k0; + i*HW

    // ---- pre = e @ We + be + vs + pd;  z = silu(pre) -> s_z, scratch;
    // silu'(pre) -> s_dp
    Frag<C> acc, in;
    zero<C>(acc);
    mm<C, false>(acc, s_e, t, a.we, F, h, wvec, s_w);
    zero<C>(in);
    {
      float pd[CJ][4], v[CJ][4];
      load_vec<C>(v, a.be, t, h);
#pragma unroll
      for (int j = 0; j < CJ; ++j) pd[j][0] = pd[j][1] = pd[j][2] = pd[j][3] = 0.f;
      if (valid) {
        load_row<C>(pd, a.pd + (long long)cell * h, t, h, vec);
#pragma unroll
        for (int i = 0; i < TM; ++i) load_row<C>(in[i], a.vs + (row0 + i * HW) * h, t, h, vec);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = acc[i][j][c] + (in[i][j][c] + (pd[j][c] + v[j][c]));
            const float sg = wide::sigmoid(p);
            in[i][j][c] = sg * (1.f + p * (1.f - sg));
            acc[i][j][c] = p * sg;
          }
    }
    put<C>(s_z, t, acc);
    put<C>(s_dp, t, in);
    if (valid) {
#pragma unroll
      for (int i = 0; i < TM; ++i) store_row<C>(z_rows + (row0 + i * HW) * h, t, h, vec, acc[i]);
    }

    // ---- t = z @ Wo + bo -> xhat;  g = g_out + g_agg * mask;  dt through
    // the LayerNorm -> s_dt, scratch; g -> s_e, g * xhat -> s_z
    zero<C>(acc);
    mm<C, false>(acc, s_z, t, a.wo, h, h, wvec, s_w);
    float inv[TM];
    {
      float v[CJ][4];
      load_vec<C>(v, a.bo, t, h);
      add_vec<C>(acc, v);
#pragma unroll
      for (int i = 0; i < TM; ++i) inv[i] = ln_normalize<C>(acc[i], t, h);  // acc = xhat
      zero<C>(in);
      if (valid) {
        load_row<C>(v, a.g_agg + (long long)cell * h, t, h, vec);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float m = a.mask[(long long)(k0 + i) * HW + q];
          load_row<C>(in[i], a.g_out + (row0 + i * HW) * h, t, h, vec);
#pragma unroll
          for (int j = 0; j < CJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) in[i][j][c] = fmaf(v[j][c], m, in[i][j][c]);
        }
      }
      // the products' last barrier: s_e's and s_z's readers are done
      put<C>(s_e, t, in);
      put_product<C>(s_z, t, in, acc);
      load_vec<C>(v, a.lns, t, h);
#pragma unroll
      for (int i = 0; i < TM; ++i) ln_backward<C>(in[i], acc[i], inv[i], v, t, h);  // in = dt
    }
    put<C>(s_dt, t, in);
    if (valid) {
#pragma unroll
      for (int i = 0; i < TM; ++i) store_row<C>(dt_rows + (row0 + i * HW) * h, t, h, vec, in[i]);
    }

    // ---- dpre = (dt @ Wo^T) * silu'(pre) -> dvs, s_dp
    zero<C>(acc);
    mm<C, true>(acc, s_dt, t, a.wo, h, h, wvec, s_w);
    get<C>(in, s_dp, t);  // silu'(pre): this thread's own
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= in[i][j][c];
      if (valid) store_row<C>(a.dvs + (row0 + i * HW) * h, t, h, vec, acc[i]);
    }
    put<C>(s_dp, t, acc);  // over this thread's own silu'

    // ---- de = dpre @ We^T (+ g_out)
    zero<C>(acc);
    mm<C, true>(acc, s_dp, t, a.we, h, F, wvec, s_w);
    if (valid) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (a.residual) {
          load_row<C>(in[i], a.g_out + (row0 + i * HW) * h, t, h, vec);
#pragma unroll
          for (int j = 0; j < CJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] += in[i][j][c];
        }
        store_row<C>(a.de + (row0 + i * HW) * F, t, F, vec, acc[i]);
      }
    }

    // ---- the tile's shares of dbe, dbo, dlns, dlnb; dpd = sum_k dpre
    // (every tile complete: the last product's barriers)
    add_colsums<C>(s_sum, s_dp);
    add_colsums<C>(s_sum + HP, s_dt);
    add_colsums<C>(s_sum + 2 * HP, s_z);
    add_colsums<C>(s_sum + 3 * HP, s_e);
    sum_directions<C>(a.dpd, s_dp, tile * CT, n_cells, h);
  }

  // this block's vector gradients (dbe sits before dWo, the other three
  // after it); the matrices come from xty_partials
  __syncthreads();
  float* out = a.partial + (long long)blockIdx.x * partial_floats(F, h);
  for (int i = threadIdx.x; i < 4 * h; i += THREADS) {
    const int v = i / h, c = i % h;
    out[v == 0 ? F * h + c : F * h + h + h * h + (v - 1) * h + c] = s_sum[v * HP + c];
  }
}

template <int HP>
cudaError_t grid_wide(int B, int HW, int* blocks) {
  constexpr int CT = WideShape<HP>::CT;
  return wide::persistent_grid(stencil_message_bwd_wide<HP>, WideShape<HP>::smem_bytes,
                               ((long long)B * HW + CT - 1) / CT, blocks);
}

template <int HP>
cudaError_t launch_wide(const Args& a, float* dw, int blocks, int wvec, cudaStream_t stream) {
  constexpr size_t smem = WideShape<HP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(stencil_message_bwd_wide<HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int F = a.F, h = a.h;
  const long long rows = 8ll * a.B * a.HW, total = partial_floats(F, h);
  float* z_rows = a.partial + scratch_offset(F, h, blocks);
  float* dt_rows = z_rows + rows * h;
  stencil_message_bwd_wide<HP><<<blocks, THREADS, smem, stream>>>(a, z_rows, dt_rows, wvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dWe = e^T dpre (dpre is dvs), dWo = z^T dt, one partial a block
  err = wide::launch_xty({a.e, a.e, a.e, a.e, a.dvs, a.dvs, a.dvs, a.dvs, rows, rows, 1, F, h,
                          a.partial, total, 0},
                         blocks, stream);
  if (err != cudaSuccess) return err;
  err = wide::launch_xty({z_rows, z_rows, z_rows, z_rows, dt_rows, dt_rows, dt_rows, dt_rows,
                          rows, rows, 1, h, h, a.partial, total, (long long)F * h + h},
                         blocks, stream);
  if (err != cudaSuccess) return err;
  return launch_sum_partials_by_warps(a.partial, dw, (int)total, blocks, stream);
}

template <int HP>
cudaError_t attributes_wide(int* out) {
  return wide::kernel_attributes(stencil_message_bwd_wide<HP>, WideShape<HP>::smem_bytes,
                                 wide::Cfg<HP>::BM, out);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// The row-tile instances take widths up to WIDE_ABOVE; above it the wide
// instance (wide_rows.cuh) takes them, up to wide::MAX_HP. Every ladder
// below dispatches on it.
constexpr int WIDE_ABOVE = 64;

// C entry: 1 when p4t_stencil_message_bwd launches the wide instance for these
// widths, 0 when a row-tile one does, -1 when no instance takes them.
extern "C" int p4t_stencil_message_bwd_wide(int F, int h) {
  const int width = F > h ? F : h;
  return width > wide::MAX_HP ? -1 : width > WIDE_ABOVE ? 1 : 0;
}

// C entry: the number of blocks p4t_stencil_message_bwd launches for
// these sizes (its partial buffer holds that many (F*h + h*h + 4h)-float
// partials, and the scratch p4t_stencil_message_bwd_scratch gives). F,
// h <= 512. Returns a cudaError_t.
extern "C" int p4t_stencil_message_bwd_grid(int B, int H, int W, int F, int h, int* blocks) {
  if ((long long)B * H * W * 8 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int width = F > h ? F : h;
  if (width <= 32) return grid<32>(B, H * W, blocks);
  if (width <= WIDE_ABOVE) return grid<WIDE_ABOVE>(B, H * W, blocks);
  if (width <= 128) return grid_wide<128>(B, H * W, blocks);
  if (width <= 256) return grid_wide<256>(B, H * W, blocks);
  if (width <= wide::MAX_HP) return grid_wide<wide::MAX_HP>(B, H * W, blocks);
  return (int)cudaErrorInvalidValue;
}

// C entry: *floats = what `partial` holds beyond the blocks' partials for
// these sizes: 0 up to WIDE_ABOVE; above it the wide instance's z and dt
// rows (2 x 8 B H W h floats) and 4 floats of alignment.
extern "C" int p4t_stencil_message_bwd_scratch(int B, int H, int W, int F, int h,
                                               long long* floats) {
  const int width = F > h ? F : h;
  *floats = width <= WIDE_ABOVE ? 0 : 4 + 2 * 8ll * B * H * W * h;
  return width <= wide::MAX_HP ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// C entry: out[5] = registers a thread, local (spill) bytes a thread,
// dynamic shared memory bytes, resident blocks an SM and rows a tile of
// the kernel that p4t_stencil_message_bwd launches for widths F, h (the
// wide instance above WIDE_ABOVE).
extern "C" int p4t_stencil_message_bwd_attributes(int F, int h, int* out) {
  const int width = F > h ? F : h;
  if (width <= 32) return attributes<32>(out);
  if (width <= WIDE_ABOVE) return attributes<WIDE_ABOVE>(out);
  if (width <= 128) return attributes_wide<128>(out);
  if (width <= 256) return attributes_wide<256>(out);
  if (width <= wide::MAX_HP) return attributes_wide<wide::MAX_HP>(out);
  return (int)cudaErrorInvalidValue;
}

// C entry: the stencil message's backward on `stream`. Inputs as the
// forward's (e: (B, 8, H, W, F); vs: (B, 8, H, W, h); pd: (B, H, W, h);
// mask: (8, H, W, 1); we: (F, h); wo: (h, h); be, bo, lns, lnb: (h,))
// plus g_out (B, 8, H, W, h) and g_agg (B, H, W, h). Writes de, dvs,
// dpd, and dw = [dWe | dbe | dWo | dbo | dlns | dlnb] (F*h + h*h + 4h
// floats) through `partial` (blocks x that size, blocks from
// p4t_stencil_message_bwd_grid, then p4t_stencil_message_bwd_scratch's
// floats). lnb takes no part in the gradients. All fp32, contiguous, on
// the current device; F, h <= 512 (the caller checks; above WIDE_ABOVE the
// wide instance). Returns the cudaError_t of the launches.
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
  if (width <= WIDE_ABOVE) return launch<WIDE_ABOVE>(a, dw, blocks, s);
  // the wide instance streams We and Wo by 16-byte copies when aligned
  const int wvec = vec && aligned16(we) && aligned16(wo) ? 1 : 0;
  if (width <= 128) return launch_wide<128>(a, dw, blocks, wvec, s);
  if (width <= 256) return launch_wide<256>(a, dw, blocks, wvec, s);
  if (width <= wide::MAX_HP) return launch_wide<wide::MAX_HP>(a, dw, blocks, wvec, s);
  return (int)cudaErrorInvalidValue;
}
