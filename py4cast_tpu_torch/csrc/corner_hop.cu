// Lattice mesh->grid corner hop (m2g), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel py4cast_tpu/ops/hop_kernel.py::_fwd_kernel
// (called through _fwd_call; its lane-packed twin _fwd_kernel_packed is
// a TPU layout device with the same math). Per grid cell, with psg_k the
// source projection ps gathered from mesh level 0 onto the cell through
// the corner maps (psg_k[b, i, j] = ps[b, rows[k/2][i], cols[k%2][j]],
// corner order r0c0, r0c1, r1c0, r1c1, as build_graph_artifacts
// enumerates the surrounding-4 edges):
//
//   pd    = vd @ Wd
//   t_k   = LN(silu(feats_k @ Wf + bf + psg_k + pd) @ Wo + bo)   k = 4 corners
//   agg   = sum_k t_k                    (/4 for mean aggregation)
//   u     = silu(vd @ Nd0a + agg @ Nd0b + nb0)
//   v_out = vd + LN(u @ Nd1 + nb1)
//
// What bounds it on the H100: at the GraphLAM 500x500 grid (h = 64, fp32,
// ps on the 125x125 level-0 lattice) the function must move ~144 MB (vd
// and v_out at 64 MB each, feats 12 MB, ps 4 MB; ~43 us at 3.35 TB/s) and
// do ~18.1 G operations (eight h x h products a cell: Wd, Wo for each of
// the 4 corners, Nd0a, Nd0b, Nd1; ~0.27 ms at the 67 TFLOP/s CUDA-core
// peak): it is bound by operations, so by how many FMAs the SMs issue per
// shared-memory load and per barrier. The TPU kernel read the four corner
// upsamples psg_k, built before the call by selection matmuls (~396 MB in
// all), because Mosaic wanted lane-aligned column tiles; here each cell
// gathers its corner rows of ps itself, and ps (4 MB) sits in L2.
//
// What the design does about it, for h <= 64 (the building blocks are
// row_tiles.cuh and corner_hop_tiles.cuh, which the backward's node pass
// shares): a block of 384 threads (256 at h <= 32) walks row tiles of BM
// cells, a row being one grid cell, on a persistent grid (as many blocks
// as the SMs hold, fewer when the tiles are fewer, balanced so that no
// block takes more tiles than it must). Each of the eight h x h products is a block
// product on register micro-tiles of 4 cells x 4 channels, fed by 128-bit
// shared loads from a [BM][HP + 4] row tile and a swizzled weight (8
// loads for 64 FMAs, no shuffle). pd stays in registers for the tile;
// for each corner, z_k = silu(feats_k @ Wf + bf + psg_k + pd) is formed
// on the micro-tile (feats_k @ Wf, ff <= 32 and 3 on the path, a short
// loop over ff) and stored to a shared z tile, then z_k @ Wo + bo, its
// LayerNorm (a row's sums over the NX lanes that share it) and the sum
// into agg run in registers. agg goes to a shared tile, then u and y,
// the node LayerNorm and out = vd + y in one 128-bit store a row.
//
// The gather: a thread loads its own rows of psg_k (4 channels each)
// straight from ps at the gathered cell, with 128-bit loads; the use is
// elementwise, so no shared tile is needed. Corner 0's loads go out
// before the pd product and corner k+1's before corner k's Wo product,
// so the L2 latency hides behind a product.
//
// Shared memory, registers and barriers per tile at h = 64 (HP = 64, BM
// = 96 cells): the five weights (80 KB, staged once a block by cp.async,
// swizzled), Wf and the eight vectors (10 KB), and four [BM][HP + 4] row
// tiles (102 KB): vd of this tile and of the next (cp.async while this
// one computes), and two z tiles (corners alternate between them, so one
// barrier a corner; they then hold agg and u): 196,608 B, one block an
// SM. The rows are HP + 4 floats apart so that the two row groups of a
// warp read other banks. Seven barriers a tile: one a corner, agg, u,
// and the end of the tile. The weights hold the SM to one block, so the
// block's size sets the warps that hide each other's latency: a thread
// holds pd, agg, the next corner's rows and a product's sums (~167
// registers), which 384 threads (12 warps, 170 registers a thread at
// most) still fit; on the H100 they took 0.77 ms at 500x500 where 256
// threads (64-cell tiles) took 0.90. At h <= 32 (HP = 32) a block is 256
// threads and a tile 128 cells. Registers and spills of each instance:
// chip_smoke.py phase 2 (ptxas) and hop_kernel.fwd_kernel_attributes.
//
// Widths 65 to 96: at HP = 128 the five swizzled weights alone would
// take 320 KB, above the 227 KB a block may have. There the forward is
// the port's first, warp-row design (corner_hop_fwd_warps, on
// warp_rows.cuh: a warp owns 2 cells, each row spread over the lanes,
// the weights at their true width of 96 in shared memory, every product
// through warp shuffles, below the fp32 peak), which reads ps through
// the same maps.
// Widths that are not a multiple of 4 take plain loads in place of the
// 128-bit ones.
//
// Wider (97 to 512): corner_hop_fwd_wide, on wide_rows.cuh (HP = 128,
// 256 or 512; tiles of 64, 32 or 8 cells), replaces
// py4cast_tpu/ops/hop_kernel.py::_fwd_kernel (:120) there. What bounds it there: the
// five h x h weights are 320 KB at h = 128 and 5 MB at 512, so no block
// holds them; the work, 16 h^2 FMA-pairs a cell, grows 16x from h = 64
// to 256 while the bytes grow 4x: at 500x500, h = 256, ~262 GFLOP (3.9
// ms at the fp32 peak) against ~0.5 GB (0.15 ms), bound by operations.
// What the design does: the same steps on three row tiles (vd; z, then
// u; agg), every product streaming its weight in chunks (cp.async,
// double-buffered), pd and agg in registers, the corners gathered from
// ps through the maps as above.

#include <cstdint>

#include "corner_hop_tiles.cuh"
#include "wide_rows.cuh"

namespace {

using namespace p4t;
using namespace p4t::rt;
using namespace p4t::hop;

struct Args {
  const float* ps;
  const int *rows, *cols;  // (2, H), (2, W): mesh-level-0 row and column of each corner
  const float *vd, *feats;
  const float *wf, *bf, *wd, *wo, *bo, *lns, *lnb;
  const float *nd0a, *nd0b, *nb0, *nd1, *nb1, *nlns, *nlnb;
  float* out;
  int B, Hc, Wc, H, W, h, ff, mean;
  int vec;  // h a multiple of 4; ps, vd, out and the h x h weights 16-byte aligned
};

// The cell of ps that corner k of grid cell (y, x) of batch entry b reads.
__device__ __forceinline__ long long source_cell(const Args& a, int k, int b, int y, int x) {
  return ((long long)b * a.Hc + __ldg(a.rows + (k >> 1) * a.H + y)) * a.Wc +
         __ldg(a.cols + (k & 1) * a.W + x);
}

// ------------------------------------------------------ row tiles (h <= 64)
template <int HP>
struct Shape {
  static constexpr int NT = HP == 64 ? 384 : THREADS;  // threads a block
  static constexpr int TM = 4;             // rows (cells) a thread
  static constexpr int NX = HP / 4;        // lanes a row (4 columns each)
  static constexpr int NY = NT / NX;       // row groups
  static constexpr int BM = NY * TM;       // cells a tile: 96 at HP = 64, 128 at 32
  static constexpr int LD = HP + 4;        // row stride of a tile
  static constexpr int HH = HP * HP, TILE = BM * LD;
  // Wd, Wo, Nd0a, Nd0b, Nd1 (swizzled); Wf; 8 vectors; two vd tiles (this
  // one and the next); two z tiles (even and odd corners; then agg and u)
  static constexpr size_t smem_floats = 5 * HH + MAX_FF * HP + 8 * HP + 4 * TILE;
  static constexpr size_t smem_bytes = smem_floats * sizeof(float);
  static_assert(smem_bytes <= 232448, "227 KB a block");
};

// The thread's rows of corner k's psg_k, read from ps at the gathered
// cells; zero for rows past the end. y, x, b: each row's grid cell.
template <int TM>
__device__ __forceinline__ void gather(float (&v)[TM][4], const Args& a, int k,
                                       const int (&b)[TM], const int (&y)[TM],
                                       const int (&x)[TM], const bool (&valid)[TM], int c0,
                                       bool vec) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
    if (valid[i]) load4(v[i], a.ps + source_cell(a, k, b[i], y[i], x[i]) * a.h, c0, a.h, vec);
  }
}

template <int HP>
__global__ void __launch_bounds__(Shape<HP>::NT, 1) corner_hop_fwd(Args a) {
  using S = Shape<HP>;
  constexpr int NX = S::NX, TM = S::TM, BM = S::BM, LD = S::LD, HH = S::HH, TILE = S::TILE;
  const int h = a.h, ff = a.ff, W = a.W, HW = a.H * a.W;
  const bool vec = a.vec != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_wd = smem;  // five [HP][HP] swizzled
  float* s_wo = s_wd + HH;
  float* s_n0a = s_wo + HH;
  float* s_n0b = s_n0a + HH;
  float* s_n1 = s_n0b + HH;
  float* s_wf = s_n1 + HH;            // [MAX_FF][HP]
  float* s_vec = s_wf + MAX_FF * HP;  // bf, bo, lns, lnb, nb0, nb1, nlns, nlnb: [8][HP]
  float* s_buf = s_vec + 8 * HP;      // [2][BM][LD]: this tile's vd and the next
  float* s_z = s_buf + 2 * TILE;      // [2][BM][LD]: z of even and odd corners
  float* s_agg = s_z;                 // after the corners: agg in the even z tile,
  float* s_u = s_z + TILE;            // u in the odd one

  // B * H * W < 2^31 (the host checks): cell numbers are ints
  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + BM - 1) / BM;
  const float* vd = a.vd;
  auto vd_rows = [&](int tile) {
    return [=](int r) -> const float* {
      const int cell = tile * BM + r;
      return cell < n_cells ? vd + (long long)cell * h : nullptr;
    };
  };

  int tile = blockIdx.x;
  stage_swizzled_async<HP>(s_wd, a.wd, h, h, vec);
  stage_swizzled_async<HP>(s_wo, a.wo, h, h, vec);
  stage_swizzled_async<HP>(s_n0a, a.nd0a, h, h, vec);
  stage_swizzled_async<HP>(s_n0b, a.nd0b, h, h, vec);
  stage_swizzled_async<HP>(s_n1, a.nd1, h, h, vec);
  if (tile < n_tiles) load_rows<BM, HP, LD>(s_buf, vd_rows(tile), h, vec, vd);
  stage_common<HP>(s_wf, s_vec, a.wf, ff, h, a.bf, a.bo, a.lns, a.lnb, a.nb0, a.nb1, a.nlns,
                   a.nlnb);

  const int tid = threadIdx.x, c0 = 4 * (tid % NX), r0 = TM * (tid / NX);
  wait_copies();
  __syncthreads();

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const float* s_vd = s_buf + buf * TILE;
    // the next tile's vd, into the tile the last one used (its readers
    // passed the barrier that ended it)
    if (tile + gridDim.x < n_tiles)
      load_rows<BM, HP, LD>(s_buf + (buf ^ 1) * TILE, vd_rows(tile + gridDim.x), h, vec, vd);

    int cell[TM], q[TM], b[TM], y[TM], x[TM];
    bool valid[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cell[i] = tile * BM + r0 + i;
      valid[i] = cell[i] < n_cells;
      b[i] = valid[i] ? cell[i] / HW : 0;
      q[i] = valid[i] ? cell[i] - b[i] * HW : 0;
      y[i] = q[i] / W;
      x[i] = q[i] - y[i] * W;
    }

    // ---- pd = vd @ Wd, with corner 0's rows of ps in flight
    float pd[TM][4], agg[TM][4], acc[TM][4], in[TM][4], dsil[TM][4];
    gather<TM>(in, a, 0, b, y, x, valid, c0, vec);
    zero_tile<TM>(pd);
    tile_mm<HP, TM, LD>(pd, s_vd, r0, s_wd, c0);
    zero_tile<TM>(agg);

    // ---- each corner: z_k -> a z tile; agg += LN(z_k @ Wo + bo) * lns + lnb
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const float* fe_k = a.feats + (long long)k * HW * ff;
      float* s_zk = s_z + (k & 1) * TILE;  // two buffers: one barrier a corner
      corner_pre<HP, TM>(
          acc, dsil, in, pd,
          [&](int i, int f) { return valid[i] ? __ldg(fe_k + (long long)q[i] * ff + f) : 0.f; },
          s_wf, s_vec, ff, c0);
      store_tile<HP, TM, LD>(s_zk, r0, c0, acc);
      __syncthreads();
      if (k < 3) gather<TM>(in, a, k + 1, b, y, x, valid, c0, vec);  // behind the product
      corner_into_agg<HP, TM, LD>(agg, s_zk, r0, s_wo, s_vec, c0, h);
    }
    if (a.mean) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) agg[i][j] *= 0.25f;
    }
    // corner 3 read the odd z tile; every thread's corner-2 product, the
    // last read of the even one, came before corner 3's barrier
    store_tile<HP, TM, LD>(s_agg, r0, c0, agg);
    __syncthreads();

    // ---- u = silu(vd @ Nd0a + agg @ Nd0b + nb0) -> s_u (the odd z tile,
    // whose corner-3 readers passed the barrier above)
    zero_tile<TM>(acc);
    tile_mm<HP, TM, LD>(acc, s_vd, r0, s_n0a, c0);
    tile_mm<HP, TM, LD>(acc, s_agg, r0, s_n0b, c0);
    {
      float nb0[4];
      lds4(nb0, s_vec + 4 * HP + c0);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = acc[i][j] + nb0[j];
          acc[i][j] = p * sigmoid(p);
        }
    }
    store_tile<HP, TM, LD>(s_u, r0, c0, acc);
    __syncthreads();

    // ---- v_out = vd + LN(u @ Nd1 + nb1) * nlns + nlnb
    zero_tile<TM>(acc);
    tile_mm<HP, TM, LD>(acc, s_u, r0, s_n1, c0);
    {
      float nb1[4], nlns[4], nlnb[4];
      lds4(nb1, s_vec + 5 * HP + c0);
      lds4(nlns, s_vec + 6 * HP + c0);
      lds4(nlnb, s_vec + 7 * HP + c0);
      load_tile<HP, TM, LD>(in, s_vd, r0, c0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += nb1[j];
        ln_normalize4<NX>(acc[i], c0, h);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = in[i][j] + fmaf(acc[i][j], nlns[j], nlnb[j]);
      }
    }
    store_rows<TM>(a.out, cell, valid, c0, h, vec, acc);

    wait_copies();
    __syncthreads();  // the next vd complete; this vd, agg and u free
  }
}

template <int HP>
cudaError_t configure() {
  return cudaFuncSetAttribute(corner_hop_fwd<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Shape<HP>::smem_bytes);
}

template <int HP>
cudaError_t blocks_per_sm(int* per_sm) {
  cudaError_t err = configure<HP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, corner_hop_fwd<HP>,
                                                       Shape<HP>::NT, Shape<HP>::smem_bytes);
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
  const long long tiles = ((long long)a.B * a.H * a.W + Shape<HP>::BM - 1) / Shape<HP>::BM;
  const long long cap = (long long)sms * per_sm;
  const long long per_block = (tiles + cap - 1) / cap;
  const long long n = (tiles + per_block - 1) / per_block;
  corner_hop_fwd<HP><<<(int)(n > 0 ? n : 1), Shape<HP>::NT, Shape<HP>::smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HP>
cudaError_t attributes(int* out) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm<HP>(&per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, corner_hop_fwd<HP>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)Shape<HP>::smem_bytes;
  out[3] = per_sm;
  out[4] = Shape<HP>::BM;
  return cudaSuccess;
}

// ------------------------------------------------ warp rows (65 <= h <= 96)
constexpr int WARPS = 8;

template <int J, int P>
__global__ void __launch_bounds__(WARPS * 32) corner_hop_fwd_warps(Args a) {
  constexpr int HP = 32 * J;
  const int h = a.h, ff = a.ff, HW = a.H * a.W;
  extern __shared__ float smem[];
  float* s_wd = smem;  // five [h][HP] matrices, then [ff][HP], then vectors
  float* s_wo = s_wd + h * HP;
  float* s_n0a = s_wo + h * HP;
  float* s_n0b = s_n0a + h * HP;
  float* s_n1 = s_n0b + h * HP;
  float* s_wf = s_n1 + h * HP;
  float* s_bf = s_wf + ff * HP;
  float* s_bo = s_bf + HP;
  float* s_lns = s_bo + HP;
  float* s_lnb = s_lns + HP;
  float* s_nb0 = s_lnb + HP;
  float* s_nb1 = s_nb0 + HP;
  float* s_nlns = s_nb1 + HP;
  float* s_nlnb = s_nlns + HP;
  stage<J>(s_wd, a.wd, h, h);
  stage<J>(s_wo, a.wo, h, h);
  stage<J>(s_n0a, a.nd0a, h, h);
  stage<J>(s_n0b, a.nd0b, h, h);
  stage<J>(s_n1, a.nd1, h, h);
  stage<J>(s_wf, a.wf, ff, h);
  stage<J>(s_bf, a.bf, 1, h);
  stage<J>(s_bo, a.bo, 1, h);
  stage<J>(s_lns, a.lns, 1, h);
  stage<J>(s_lnb, a.lnb, 1, h);
  stage<J>(s_nb0, a.nb0, 1, h);
  stage<J>(s_nb1, a.nb1, 1, h);
  stage<J>(s_nlns, a.nlns, 1, h);
  stage<J>(s_nlnb, a.nlnb, 1, h);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long n_cells = (long long)a.B * HW;
  const long long groups = (n_cells + P - 1) / P;
  const long long warp0 = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;

  for (long long g = warp0; g < groups; g += n_warps) {
    long long cell[P];
    int q[P], bq[P];
    bool valid[P];
    float vd[P][J], pd[P][J], agg[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cell[p] = g * P + p;
      valid[p] = cell[p] < n_cells;
      bq[p] = valid[p] ? (int)(cell[p] / HW) : 0;
      q[p] = valid[p] ? (int)(cell[p] - (long long)bq[p] * HW) : 0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        vd[p][j] = (valid[p] && c < h) ? a.vd[cell[p] * h + c] : 0.f;
        pd[p][j] = 0.f;
        agg[p][j] = 0.f;
      }
    }
    row_matmul<J, P>(vd, pd, s_wd, h, lane);

#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const int* rows_k = a.rows + (k >> 1) * a.H;
      const int* cols_k = a.cols + (k & 1) * a.W;
      float z[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* fe = a.feats + ((long long)k * HW + q[p]) * ff;
        const int y = q[p] / a.W;
        const float* src =
            a.ps + (((long long)bq[p] * a.Hc + rows_k[y]) * a.Wc + cols_k[q[p] - y * a.W]) * h;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          float pf = 0.f;
          for (int i = 0; i < ff; ++i) pf = fmaf(fe[i], s_wf[i * HP + c], pf);
          const float s = (valid[p] && c < h) ? src[c] : 0.f;
          z[p][j] = silu(pf + s_bf[c] + s + pd[p][j]);
        }
      }
      float t[P][J];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < J; ++j) t[p][j] = s_bo[lane + 32 * j];
      row_matmul<J, P>(z, t, s_wo, h, lane);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        layer_norm<J>(t[p], s_lns, s_lnb, h, lane);
#pragma unroll
        for (int j = 0; j < J; ++j) agg[p][j] += t[p][j];
      }
    }
    float u[P][J];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (a.mean) agg[p][j] *= 0.25f;
        u[p][j] = 0.f;
      }
    row_matmul<J, P>(vd, u, s_n0a, h, lane);
    row_matmul<J, P>(agg, u, s_n0b, h, lane);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        u[p][j] = silu(u[p][j] + s_nb0[lane + 32 * j]);
        agg[p][j] = s_nb1[lane + 32 * j];  // agg is spent: reuse it for y
      }
    row_matmul<J, P>(u, agg, s_n1, h, lane);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      layer_norm<J>(agg[p], s_nlns, s_nlnb, h, lane);
      if (!valid[p]) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < h) a.out[cell[p] * h + c] = vd[p][j] + agg[p][j];
      }
    }
  }
}

template <int J>
size_t warps_smem(int h, int ff) {
  return (size_t)(5 * h + ff + 8) * 32 * J * sizeof(float);
}

template <int J, int P>
cudaError_t warps_blocks_per_sm(size_t smem, int* per_sm) {
  auto kernel = corner_hop_fwd_warps<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, WARPS * 32, smem);
}

template <int J, int P>
cudaError_t launch_warps(const Args& a, cudaStream_t stream) {
  const size_t smem = warps_smem<J>(a.h, a.ff);
  auto kernel = corner_hop_fwd_warps<J, P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = grid_for(kernel, WARPS * 32, smem, ((long long)a.B * a.H * a.W + P - 1) / P, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The warp-row instance's attributes at width h and the most corner
// features (its shared memory grows with both).
template <int J, int P>
cudaError_t warps_attributes(int h, int* out) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  const size_t smem = warps_smem<J>(h, MAX_FF);
  cudaError_t err = warps_blocks_per_sm<J, P>(smem, &per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, corner_hop_fwd_warps<J, P>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = WARPS * P;
  return cudaSuccess;
}

// ------------------------------------------------- wide rows (h > 96)
template <int HP>
struct WideShape {
  using C = wide::Cfg<HP>;
  // vd, z (then u), agg row tiles; the weight chunks
  static constexpr size_t smem_bytes = (3 * C::TILE + C::CHUNKS) * sizeof(float);
  static_assert(smem_bytes <= 232448, "227 KB a block");
};

template <int HP>
__global__ void __launch_bounds__(THREADS, 1) corner_hop_fwd_wide(Args a) {
  using namespace p4t::wide;
  using C = Cfg<HP>;
  constexpr int TM = C::TM, CJ = C::CJ, BM = C::BM;
  const int h = a.h, ff = a.ff, W = a.W, HW = a.H * a.W;
  const bool vec = a.vec != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_vd = smem;  // three [BM][LD] row tiles
  float* s_z = s_vd + C::TILE;
  float* s_agg = s_z + C::TILE;
  float* s_w = s_agg + C::TILE;
  const Lane<C> t;

  // B * H * W < 2^31 (the host checks): cell numbers are ints
  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers of every tile are done
    fill_tile<C>(
        s_vd,
        [=](int r) -> const float* {
          const int cell = tile * BM + r;
          return cell < n_cells ? a.vd + (long long)cell * h : nullptr;
        },
        h, vec, a.vd);
    int cell[TM], q[TM], b[TM], y[TM], x[TM];
    bool valid[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cell[i] = tile * BM + TM * t.ty + i;
      valid[i] = cell[i] < n_cells;
      b[i] = valid[i] ? cell[i] / HW : 0;
      q[i] = valid[i] ? cell[i] - b[i] * HW : 0;
      y[i] = q[i] / W;
      x[i] = q[i] - y[i] * W;
    }

    // ---- pd = vd @ Wd
    Frag<C> pd, agg, acc, in;
    zero<C>(pd);
    mm<C, false>(pd, s_vd, t, a.wd, h, h, vec, s_w);
    zero<C>(agg);

    // ---- each corner: z_k -> s_z;  agg += LN(z_k @ Wo + bo) * lns + lnb
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const float* fe_k = a.feats + (long long)k * HW * ff;
      zero<C>(in);
      zero<C>(acc);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (valid[i])
          load_row<C>(in[i], a.ps + source_cell(a, k, b[i], y[i], x[i]) * h, t, h, vec);
      for (int f = 0; f < ff; ++f) {
        float w[CJ][4];
        load_vec<C>(w, a.wf + f * h, t, h);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float xf = valid[i] ? __ldg(fe_k + (long long)q[i] * ff + f) : 0.f;
#pragma unroll
          for (int j = 0; j < CJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = fmaf(xf, w[j][c], acc[i][j][c]);
        }
      }
      {
        float v[CJ][4];
        load_vec<C>(v, a.bf, t, h);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float p = ((acc[i][j][c] + v[j][c]) + in[i][j][c]) + pd[i][j][c];
              acc[i][j][c] = p * wide::sigmoid(p);
            }
      }
      put<C>(s_z, t, acc);  // the last product's readers of s_z are done
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
            for (int c = 0; c < 4; ++c) agg[i][j][c] += fmaf(acc[i][j][c], v[j][c], v2[j][c]);
        }
      }
    }
    if (a.mean) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) agg[i][j][c] *= 0.25f;
    }
    put<C>(s_agg, t, agg);

    // ---- u = silu(vd @ Nd0a + agg @ Nd0b + nb0) -> s_z
    zero<C>(acc);
    mm<C, false>(acc, s_vd, t, a.nd0a, h, h, vec, s_w);
    mm<C, false>(acc, s_agg, t, a.nd0b, h, h, vec, s_w);
    {
      float v[CJ][4];
      load_vec<C>(v, a.nb0, t, h);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = acc[i][j][c] + v[j][c];
            acc[i][j][c] = p * wide::sigmoid(p);
          }
    }
    put<C>(s_z, t, acc);

    // ---- v_out = vd + LN(u @ Nd1 + nb1) * nlns + nlnb
    zero<C>(acc);
    mm<C, false>(acc, s_z, t, a.nd1, h, h, vec, s_w);
    {
      float v[CJ][4], v2[CJ][4];
      load_vec<C>(v, a.nb1, t, h);
      add_vec<C>(acc, v);
      load_vec<C>(v, a.nlns, t, h);
      load_vec<C>(v2, a.nlnb, t, h);
      get<C>(in, s_vd, t);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ln_normalize<C>(acc[i], t, h);
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][j][c] = in[i][j][c] + fmaf(acc[i][j][c], v[j][c], v2[j][c]);
        if (valid[i]) store_row<C>(a.out + (long long)cell[i] * h, t, h, vec, acc[i]);
      }
    }
  }
}

template <int HP>
cudaError_t launch_wide(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = WideShape<HP>::smem_bytes;
  constexpr int BM = wide::Cfg<HP>::BM;
  int blocks = 0;
  cudaError_t err = wide::persistent_grid(corner_hop_fwd_wide<HP>, smem,
                                          ((long long)a.B * a.H * a.W + BM - 1) / BM, &blocks);
  if (err != cudaSuccess) return err;
  corner_hop_fwd_wide<HP><<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HP>
cudaError_t attributes_wide(int* out) {
  return wide::kernel_attributes(corner_hop_fwd_wide<HP>, WideShape<HP>::smem_bytes,
                                 wide::Cfg<HP>::BM, out);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// The row-tile instances take widths up to WIDE_ABOVE; above it the wide
// instance (wide_rows.cuh) takes them, up to wide::MAX_HP. Every ladder
// below dispatches on it.
constexpr int WIDE_ABOVE = 96;

// C entry: 1 when p4t_corner_hop_fwd launches the wide instance for these
// widths, 0 when a row-tile one does, -1 when no instance takes them.
extern "C" int p4t_corner_hop_fwd_wide(int h) {
  return h > wide::MAX_HP ? -1 : h > WIDE_ABOVE ? 1 : 0;
}

// C entry: out[5] = registers a thread, local (spill) bytes a thread,
// dynamic shared memory bytes (at 32 corner features for 64 < h <= 96),
// resident blocks an SM and cells a tile (cells a block takes at once
// for 64 < h <= 96) of the kernel that p4t_corner_hop_fwd launches for
// width h (the wide instance above WIDE_ABOVE).
extern "C" int p4t_corner_hop_fwd_attributes(int h, int* out) {
  if (h <= 32) return attributes<32>(out);
  if (h <= 64) return attributes<64>(out);
  if (h <= WIDE_ABOVE) return warps_attributes<3, 2>(h, out);
  if (h <= 128) return attributes_wide<128>(out);
  if (h <= 256) return attributes_wide<256>(out);
  if (h <= wide::MAX_HP) return attributes_wide<wide::MAX_HP>(out);
  return (int)cudaErrorInvalidValue;
}

// C entry: out = corner hop of (ps, vd, feats) on `stream`.
// ps: (B, Hc, Wc, h), the source projection on mesh level 0; rows: (2, H)
// and cols: (2, W) int32, the level-0 row and column of each corner
// (corner k of grid cell (i, j) reads ps[b, rows[k/2][i], cols[k%2][j]];
// the caller guarantees 0 <= rows < Hc and 0 <= cols < Wc); vd, out:
// (B, H, W, h); feats: (4, H, W, ff); wf: (ff, h); wd, wo, nd0a, nd0b,
// nd1: (h, h); bf, bo, lns, lnb, nb0, nb1, nlns, nlnb: (h,). All fp32 but
// the maps, contiguous, on the current device; h <= 512 (above WIDE_ABOVE
// the wide instance) and ff <= 32 (the caller checks). Returns the
// cudaError_t of the launch.
extern "C" int p4t_corner_hop_fwd(const float* ps, const int* rows, const int* cols,
                                  const float* vd, const float* feats, const float* wf,
                                  const float* bf, const float* wd, const float* wo,
                                  const float* bo, const float* lns, const float* lnb,
                                  const float* nd0a, const float* nd0b, const float* nb0,
                                  const float* nd1, const float* nb1, const float* nlns,
                                  const float* nlnb, float* out, int B, int Hc, int Wc, int H,
                                  int W, int h, int ff, int mean, void* stream) {
  if (ff > MAX_FF || (long long)B * H * W >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bool vec = h % 4 == 0 && aligned16(ps) && aligned16(vd) && aligned16(out) &&
                   aligned16(wd) && aligned16(wo) && aligned16(nd0a) && aligned16(nd0b) &&
                   aligned16(nd1);
  Args a{ps,  rows, cols, vd,  feats, wf,   bf,   wd, wo, bo, lns, lnb, nd0a, nd0b,
         nb0, nd1,  nb1,  nlns, nlnb, out, B,    Hc, Wc, H,  W,   h,   ff,   mean,
         vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 32) return launch<32>(a, s);
  if (h <= 64) return launch<64>(a, s);
  if (h <= WIDE_ABOVE) return launch_warps<3, 2>(a, s);
  if (h <= 128) return launch_wide<128>(a, s);
  if (h <= 256) return launch_wide<256>(a, s);
  if (h <= wide::MAX_HP) return launch_wide<wide::MAX_HP>(a, s);
  return (int)cudaErrorInvalidValue;
}
