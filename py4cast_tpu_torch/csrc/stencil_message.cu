// Lattice stencil edge message, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel py4cast_tpu/ops/stencil_kernel.py::_fwd_kernel
// (called through _fwd_call; its lane-packed twin _fwd_kernel_packed is
// a TPU layout device with the same math). Per lattice cell and each of
// its 8 directions k, with vs_k the source projection ps shifted onto
// the cell (vs_k[b, y, x] = ps[b, y - di, x - dj] for (di, dj) = DIRS8[k],
// 0 off the lattice):
//
//   e_new_k = LN(silu(e_k @ We + be + vs_k + pd) @ Wo + bo)
//   out_k   = e_new_k (+ e_k when residual)
//   agg     = sum_k e_new_k * mask_k          (always the raw e_new)
//
// What bounds it on the H100: at the GraphLAM level-0 lattice (125x125,
// h=64, fp32) the function must move ~76 MB (e and out at 32 MB each;
// ps, pd and agg at 4 MB) and do ~2.2 GFLOP (two h x h products a cell
// and direction): ~23 us at 3.35 TB/s against ~33 us at the 67 TFLOP/s
// CUDA-core peak, so it is bound by operations, by how many FMAs the
// SMs issue per shared-memory load and per barrier.
//
// What the design does about it (the building blocks are row_tiles.cuh,
// as in the backward): a block of 256 threads walks row tiles of BM
// rows, a row being one (cell, direction); a tile holds BM/8 whole cells,
// their 8 directions side by side. Both products (e @ We, silu(pre) @
// Wo) are block products on register micro-tiles of TM rows x 4 columns
// fed by 128-bit shared loads from the swizzled weights (TM + 4 loads
// for 16 TM FMAs, no shuffle). A thread's TM rows are TM directions of
// one cell, so the row-wise work runs on the same micro-tiles: bias,
// silu, the LayerNorm (a row's sums over the NX lanes that share it),
// the residual, and the 128-bit stores of out. agg is each thread's sum
// over its rows in direction order, then over the cell's 8 / TM row
// groups by a butterfly within the warp: a fixed order, no atomics, so
// a call repeats bit for bit.
//
// The TPU kernel read vs, eight shifted copies of ps that the caller
// made before every call (32 MB at level 0, 9 device ops), so that its
// VMEM tiles needed no halo. Here each thread loads its TM rows of vs
// from ps at the neighbour cells itself (0 off the lattice), with
// 128-bit loads that a cell's eight neighbours share through L1 and L2,
// issued before the e @ We product, which hides their latency; pd and
// mask go the same way into the micro-tiles. Only e goes through shared
// memory: the next tile's e arrives by cp.async while the current tile
// computes (two e tiles, swapping roles), and silu(pre) is the one other
// row tile. Two barriers a tile. A tile's rows are HP + 4 floats apart
// (HP <= 64), so that the row groups of a warp, which read a row each at
// the same time, hit other banks (at a stride of HP every row starts on
// bank 0: two wavefronts a read in place of one); the weights arrive by
// cp.async too, all at once, so a block's prologue waits for one round
// trip to L2 instead of one a weight read; that counts most where a
// block takes one tile or two (the 63x63 and 32x32 levels).
//
// The grid is persistent: as many blocks as the SMs hold, fewer when the
// tiles are fewer, balanced so that no block takes more tiles than it
// must (the 32x32 lattice at h = 64 is 128 tiles of 8 cells, a block on
// 128 of the 132 SMs).
//
// Widths: F and h up to 128, three instances of one template: HP = 32
// (TM = 4, 128 rows a tile), HP = 64 (TM = 4, 64 rows) and HP = 128
// (TM = 8, 64 rows: a thread holds all 8 directions of its cell). At
// HP <= 64 a block takes the two matrices (HP^2 floats each), the four
// vectors and three row tiles, 84 KB at HP = 64, so two blocks share an
// SM (launch bounds hold a thread to 128 registers); at HP = 128 one
// block, 226 KB. Widths that are not multiples of 4 take plain loads in
// place of the 128-bit ones.
//
// Wider (F or h from 129 to 512): stencil_message_fwd_wide, on
// wide_rows.cuh (HP = 256 or 512; tiles of 32 or 8 rows, 4 cells or 1),
// replaces py4cast_tpu/ops/stencil_kernel.py::_fwd_kernel (:52) at those
// widths (at 129-256 the row tiles above would need 2 x 256 KB of weights).
// What bounds it there: at h = 256 one h x h matrix is 256 KB, above the
// 227 KB of a block, and the work per cell and direction (4 h^2 FMAs)
// grows 16x over h = 64 while the bytes grow 4x: at the 125x125 level
// ~8.4 GFLOP (0.13 ms at the fp32 peak) against ~300 MB (0.09 ms), so
// operations. What the design does: the same steps (e @ We, pre, silu,
// z @ Wo, the LayerNorm, out, agg) on row tiles of e and z in shared
// memory, each product streaming its weight in chunks of 16 or 8 rows
// (cp.async, double-buffered), never the whole matrix; agg is each
// cell's 8 masked rows summed in direction order from the z tile once
// the products are done (one barrier), so a call repeats bit for bit.

#include <cstdint>

#include "row_tiles.cuh"
#include "wide_rows.cuh"

namespace {

using namespace p4t;
using namespace p4t::rt;

struct Args {
  const float *e, *ps, *pd, *mask, *we, *be, *wo, *bo, *lns, *lnb;
  float *out, *agg;
  int B, H, W, F, h, residual;
  int vec;  // F and h multiples of 4, every row array and weight 16-byte aligned
};

template <int HP>
struct Shape {
  static constexpr int TM = HP == 128 ? 8 : 4;  // rows a thread
  static constexpr int NX = HP / 4;             // lanes a row (4 columns each)
  static constexpr int NY = THREADS / NX;       // row groups
  static constexpr int BM = NY * TM;            // rows a tile
  static constexpr int CT = BM / 8;             // cells a tile
  static constexpr int GROUPS = 8 / TM;         // row groups a cell
  static constexpr int MIN_BLOCKS = HP <= 64 ? 2 : 1;
  // row stride of a tile: at HP <= 64 a warp holds two or four row
  // groups, whose rows HP + 4 puts on other banks (no room at HP = 128,
  // where a warp is one row group)
  static constexpr int LD = HP <= 64 ? HP + 4 : HP;
  // We, Wo (swizzled); be, bo, lns, lnb; two e tiles and the silu tile
  static constexpr size_t smem_floats = 2 * HP * HP + 4 * HP + 3 * BM * LD;
  static constexpr size_t smem_bytes = smem_floats * sizeof(float);
  static_assert(8 % TM == 0 && BM % 8 == 0, "a thread's rows are directions of one cell");
  static_assert(GROUPS * NX <= 32, "a cell's row groups share a warp");
};

// (di, dj) of direction k in lattice_ops.DIRS8 order: the 3 x 3
// neighbourhood row by row, the centre left out.
__device__ __forceinline__ int dir_di(int k) { return (k + (k >= 4)) / 3 - 1; }
__device__ __forceinline__ int dir_dj(int k) { return (k + (k >= 4)) % 3 - 1; }

template <int HP>
__global__ void __launch_bounds__(THREADS, Shape<HP>::MIN_BLOCKS) stencil_message_fwd(Args a) {
  using S = Shape<HP>;
  constexpr int NX = S::NX, TM = S::TM, BM = S::BM, CT = S::CT, LD = S::LD;
  const int F = a.F, h = a.h, H = a.H, W = a.W, HW = H * W;
  const bool vec = a.vec != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_we = smem;             // [HP][HP] swizzled
  float* s_wo = s_we + HP * HP;   // [HP][HP] swizzled
  float* s_vec = s_wo + HP * HP;  // be, bo, lns, lnb: [4][HP]
  float* s_buf = s_vec + 4 * HP;  // [2][BM][LD]: this tile's e and the next
  float* s_z = s_buf + 2 * BM * LD;

  // 8 * B * H * W < 2^31 (the host checks): cell and row numbers are ints
  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + CT - 1) / CT;
  // rows of the (B, 8, H, W, F) e for the tile's cells, null past the end
  auto e_rows = [&](int tile) {
    return [=](int r) -> const float* {
      const int cell = tile * CT + r / 8;
      if (cell >= n_cells) return nullptr;
      const int b = cell / HW;
      return a.e + (long long)((b * 8 + r % 8) * HW + (cell - b * HW)) * F;
    };
  };

  int tile = blockIdx.x;
  stage_swizzled_async<HP>(s_we, a.we, F, h, vec);
  stage_swizzled_async<HP>(s_wo, a.wo, h, h, vec);
  if (tile < n_tiles) load_rows<BM, HP, LD>(s_buf, e_rows(tile), F, vec, a.e);
  for (int i = threadIdx.x; i < 4 * HP; i += THREADS) {
    const int v = i / HP, c = i % HP;
    const float* src = v == 0 ? a.be : v == 1 ? a.bo : v == 2 ? a.lns : a.lnb;
    s_vec[i] = c < h ? src[c] : 0.f;
  }

  const int tid = threadIdx.x, tx = tid % NX, ty = tid / NX;
  const int c0 = 4 * tx, r0 = TM * ty, k0 = r0 % 8;  // columns; rows; first direction
  wait_copies();
  __syncthreads();

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    float* s_e = s_buf + buf * BM * LD;
    // the next tile's e, into the tile the last one used (its readers
    // passed the barrier that ended it)
    if (tile + gridDim.x < n_tiles)
      load_rows<BM, HP, LD>(s_buf + (buf ^ 1) * BM * LD, e_rows(tile + gridDim.x), F, vec, a.e);

    const int cell = tile * CT + r0 / 8;
    const bool valid = cell < n_cells;
    const int b = valid ? cell / HW : 0, q = valid ? cell - b * HW : 0;
    const int y = q / W, x = q - y * W;

    // ---- pre = e @ We + be + vs + pd;  z = silu(pre) -> s_z. The loads
    // from device memory go out before the product, which hides them.
    float acc[TM][4], in[TM][4], m[TM], v4[4], pd4[4] = {0.f, 0.f, 0.f, 0.f};
    zero_tile<TM>(in);
#pragma unroll
    for (int i = 0; i < TM; ++i) m[i] = 0.f;
    if (valid) {
      load4(pd4, a.pd + (long long)cell * h, c0, h, vec);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int k = k0 + i;
        const int ys = y - dir_di(k), xs = x - dir_dj(k);
        if (ys >= 0 && ys < H && xs >= 0 && xs < W)
          load4(in[i], a.ps + ((long long)b * HW + ys * W + xs) * h, c0, h, vec);
        m[i] = a.mask[k * HW + q];
      }
    }
    zero_tile<TM>(acc);
    tile_mm<HP, TM, LD>(acc, s_e, r0, s_we, c0);
    lds4(v4, s_vec + c0);  // be
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = acc[i][j] + (in[i][j] + (pd4[j] + v4[j]));
        acc[i][j] = p * __frcp_rn(1.f + __expf(-p));
      }
    store_tile<HP, TM, LD>(s_z, r0, c0, acc);
    __syncthreads();

    // ---- e_new = LN(z @ Wo + bo) * lns + lnb;  out, and agg's share
    zero_tile<TM>(acc);
    tile_mm<HP, TM, LD>(acc, s_z, r0, s_wo, c0);
    lds4(v4, s_vec + HP + c0);  // bo
    float sc[4], bi[4], part[4] = {0.f, 0.f, 0.f, 0.f};
    lds4(sc, s_vec + 2 * HP + c0);
    lds4(bi, s_vec + 3 * HP + c0);
    if (a.residual) load_tile<HP, TM, LD>(in, s_e, r0, c0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += v4[j];
      ln_normalize4<NX>(acc[i], c0, h);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float en = fmaf(acc[i][j], sc[j], bi[j]);
        part[j] = fmaf(en, m[i], part[j]);
        acc[i][j] = a.residual ? en + in[i][j] : en;
      }
      if (valid) store4(a.out + ((long long)(b * 8 + k0 + i) * HW + q) * h, c0, h, vec, acc[i]);
    }
    // the cell's row groups are GROUPS consecutive groups of NX lanes of
    // one warp: a butterfly gives each the same sum
#pragma unroll
    for (int o = NX; o < S::GROUPS * NX; o <<= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[j] += __shfl_xor_sync(FULL, part[j], o);
    if (valid && k0 == 0) store4(a.agg + (long long)cell * h, c0, h, vec, part);

    wait_copies();
    __syncthreads();  // the next e complete; s_z and this e free
  }
}

template <int HP>
cudaError_t configure() {
  return cudaFuncSetAttribute(stencil_message_fwd<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Shape<HP>::smem_bytes);
}

template <int HP>
cudaError_t blocks_per_sm(int* per_sm) {
  cudaError_t err = configure<HP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, stencil_message_fwd<HP>, THREADS,
                                                       Shape<HP>::smem_bytes);
}

// As many blocks as the SMs hold, or fewer: the tiles spread evenly, so
// that no block takes more tiles than the largest share must.
template <int HP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<HP>(&per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = ((long long)a.B * a.H * a.W + Shape<HP>::CT - 1) / Shape<HP>::CT;
  const long long cap = (long long)sms * per_sm;
  const long long per_block = (tiles + cap - 1) / cap;
  const long long n = (tiles + per_block - 1) / per_block;
  stencil_message_fwd<HP><<<(int)(n > 0 ? n : 1), THREADS, Shape<HP>::smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HP>
cudaError_t attributes(int* out) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm<HP>(&per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, stencil_message_fwd<HP>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)Shape<HP>::smem_bytes;
  out[3] = per_sm;
  out[4] = Shape<HP>::BM;
  return cudaSuccess;
}

// ------------------------------------------- wide rows (F or h > 128)
template <int HP>
struct WideShape {
  using C = wide::Cfg<HP>;
  static constexpr int CT = C::BM / 8;  // cells a tile
  // e and z (then the masked e_new) row tiles; the weight chunks
  static constexpr size_t smem_bytes = (2 * C::TILE + C::CHUNKS) * sizeof(float);
  static_assert(smem_bytes <= 232448, "227 KB a block");
};

template <int HP>
__global__ void __launch_bounds__(THREADS, 1) stencil_message_fwd_wide(Args a) {
  using namespace p4t::wide;
  using C = Cfg<HP>;
  constexpr int TM = C::TM, CJ = C::CJ, CT = WideShape<HP>::CT;
  const int F = a.F, h = a.h, H = a.H, W = a.W, HW = H * W;
  const bool vec = a.vec != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_e = smem;
  float* s_z = s_e + C::TILE;
  float* s_w = s_z + C::TILE;
  const Lane<C> t;
  const int r0 = TM * t.ty, k0 = r0 % 8;  // rows; first direction

  // 8 * B * H * W < 2^31 (the host checks): cell and row numbers are ints
  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + CT - 1) / CT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers of s_e and s_z are done
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
    const int b = valid ? cell / HW : 0, q = valid ? cell - b * HW : 0;
    const int y = q / W, x = q - y * W;

    // ---- pre = e @ We + be + vs + pd;  z = silu(pre) -> s_z
    Frag<C> acc, in;
    zero<C>(acc);
    mm<C, false>(acc, s_e, t, a.we, F, h, vec, s_w);
    zero<C>(in);
    {
      float pd[CJ][4], v[CJ][4];
      load_vec<C>(v, a.be, t, h);
      if (valid) {
        load_row<C>(pd, a.pd + (long long)cell * h, t, h, vec);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int k = k0 + i;
          const int ys = y - dir_di(k), xs = x - dir_dj(k);
          if (ys >= 0 && ys < H && xs >= 0 && xs < W)
            load_row<C>(in[i], a.ps + ((long long)b * HW + ys * W + xs) * h, t, h, vec);
        }
      } else {
#pragma unroll
        for (int j = 0; j < CJ; ++j) pd[j][0] = pd[j][1] = pd[j][2] = pd[j][3] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = acc[i][j][c] + (in[i][j][c] + (pd[j][c] + v[j][c]));
            acc[i][j][c] = p * wide::sigmoid(p);
          }
    }
    put<C>(s_z, t, acc);

    // ---- e_new = LN(z @ Wo + bo) * lns + lnb;  out, and the masked e_new
    zero<C>(acc);
    mm<C, false>(acc, s_z, t, a.wo, h, h, vec, s_w);
    {
      float v[CJ][4], v2[CJ][4];
      load_vec<C>(v, a.bo, t, h);
      add_vec<C>(acc, v);
      load_vec<C>(v, a.lns, t, h);
      load_vec<C>(v2, a.lnb, t, h);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ln_normalize<C>(acc[i], t, h);
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = fmaf(acc[i][j][c], v[j][c], v2[j][c]);
      }
    }
    if (a.residual) get<C>(in, s_e, t);  // this thread's own rows of e
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float m = valid ? a.mask[(k0 + i) * HW + q] : 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float en = acc[i][j][c];
          acc[i][j][c] = a.residual ? en + in[i][j][c] : en;
          in[i][j][c] = en * m;
        }
      if (valid)
        store_row<C>(a.out + ((long long)(b * 8 + k0 + i) * HW + q) * h, t, h, vec, acc[i]);
    }
    // agg: each cell's 8 masked rows in direction order (s_z's readers
    // passed the product's last barrier)
    put<C>(s_z, t, in);
    __syncthreads();
    sum_directions<C>(a.agg, s_z, tile * CT, n_cells, h);
  }
}

template <int HP>
cudaError_t launch_wide(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = WideShape<HP>::smem_bytes;
  constexpr int CT = WideShape<HP>::CT;
  int blocks = 0;
  cudaError_t err = wide::persistent_grid(stencil_message_fwd_wide<HP>, smem,
                                          ((long long)a.B * a.H * a.W + CT - 1) / CT, &blocks);
  if (err != cudaSuccess) return err;
  stencil_message_fwd_wide<HP><<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HP>
cudaError_t attributes_wide(int* out) {
  return wide::kernel_attributes(stencil_message_fwd_wide<HP>, WideShape<HP>::smem_bytes,
                                 wide::Cfg<HP>::BM, out);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// The row-tile instances take widths up to WIDE_ABOVE; above it the wide
// instance (wide_rows.cuh) takes them, up to wide::MAX_HP. Every ladder
// below dispatches on it.
constexpr int WIDE_ABOVE = 128;

// C entry: 1 when p4t_stencil_message_fwd launches the wide instance for these
// widths, 0 when a row-tile one does, -1 when no instance takes them.
extern "C" int p4t_stencil_message_fwd_wide(int F, int h) {
  const int width = F > h ? F : h;
  return width > wide::MAX_HP ? -1 : width > WIDE_ABOVE ? 1 : 0;
}

// C entry: out[5] = registers a thread, local (spill) bytes a thread,
// dynamic shared memory bytes, resident blocks an SM and rows a tile of
// the kernel that p4t_stencil_message_fwd launches for widths F, h (the
// wide instance above WIDE_ABOVE).
extern "C" int p4t_stencil_message_fwd_attributes(int F, int h, int* out) {
  const int width = F > h ? F : h;
  if (width <= 32) return attributes<32>(out);
  if (width <= 64) return attributes<64>(out);
  if (width <= WIDE_ABOVE) return attributes<WIDE_ABOVE>(out);
  if (width <= 256) return attributes_wide<256>(out);
  if (width <= wide::MAX_HP) return attributes_wide<wide::MAX_HP>(out);
  return (int)cudaErrorInvalidValue;
}

// C entry: (out, agg) = stencil message of (e, ps, pd, mask) on `stream`.
// e: (B, 8, H, W, F); ps, pd, agg: (B, H, W, h); out: (B, 8, H, W, h);
// mask: (8, H, W, 1); we: (F, h); wo: (h, h); be, bo, lns, lnb: (h,).
// The kernel shifts ps onto each cell itself (lattice_ops.shift2d for
// each direction of DIRS8). All fp32, contiguous, on the current
// device; F, h <= 512 (the caller checks; above WIDE_ABOVE the wide instance).
// Returns the cudaError_t of the launch.
extern "C" int p4t_stencil_message_fwd(const float* e, const float* ps, const float* pd,
                                       const float* mask, const float* we, const float* be,
                                       const float* wo, const float* bo, const float* lns,
                                       const float* lnb, float* out, float* agg, int B, int H,
                                       int W, int F, int h, int residual, void* stream) {
  if ((long long)B * H * W * 8 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bool vec = F % 4 == 0 && h % 4 == 0 && aligned16(e) && aligned16(ps) && aligned16(pd) &&
                   aligned16(out) && aligned16(agg) && aligned16(we) && aligned16(wo);
  Args a{e, ps, pd, mask, we, be, wo, bo, lns, lnb, out, agg, B, H, W, F, h, residual,
         vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = F > h ? F : h;
  if (width <= 32) return launch<32>(a, s);
  if (width <= 64) return launch<64>(a, s);
  if (width <= WIDE_ABOVE) return launch<WIDE_ABOVE>(a, s);
  if (width <= 256) return launch_wide<256>(a, s);
  if (width <= wide::MAX_HP) return launch_wide<wide::MAX_HP>(a, s);
  return (int)cudaErrorInvalidValue;
}
