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
// products per cell: 8 of the forward, 8 transposed, 8 weight-gradient
// updates; ~0.75 ms at the 67 TFLOP/s CUDA-core peak): it is bound by
// operations, so by how many FMAs the SMs issue per shared-memory load
// and per barrier. Recomputing the corners instead of caching them (as
// the TPU kernel does) adds 5 products a cell, 29 in all (~59 GFLOP).
//
// What the design does about it (the building blocks are row_tiles.cuh):
// a block of 256 threads walks row tiles of BM cells, a row being one
// grid cell. Every h x h product is a block product on register
// micro-tiles of 4 cells x 4 channels, fed by 128-bit shared loads from
// a [BM][HP] row tile and a swizzled weight (8 loads for 64 FMAs, no
// shuffle; 2 cells x 4 channels at h <= 32). The row-wise work (biases, silu and its derivative, the
// corner and node LayerNorms forward and backward, the mean scaling)
// runs on the same micro-tiles, a row's sums reduced over the 16 (8 at
// h <= 32) lanes that share it. feats_k @ Wf (ff <= 32, 3 on the path)
// is a short loop over ff on the micro-tile, not an HP-wide product.
//
// Two kernels, launched one after the other by the same C entry,
// because one fused kernel does not fit: the five weights (80 KB at
// h=64), five live row tiles (80 KB) and the five h x h gradient patch
// sets (80 KB) come to ~250 KB, above the 227 KB a block may have, and
// its threads could not hold the patches in registers either (each pass
// alone takes 168 and 224 registers at h=64).
// - corner_hop_bwd_node recomputes pd, the four corners (the forward's
//   steps, corner_hop_tiles.cuh), agg and the node MLP, runs the node
//   backward, writes dvd = g + dupre @ Nd0a^T and dagg (a (B,H,W,h)
//   scratch array), and adds dNd0a, dNd0b, dnb0, dNd1, dnb1, dnlns,
//   dnlnb. Shared memory at h=64: the five weights
//   (80 KB), Wf and the vectors (10 KB), five row tiles (vd, agg, z of
//   two corners that become u and dy, dupre; 80 KB), the dNd0a, dNd0b
//   and dNd1 patches (48 KB): 223,232 B. 10 barriers a tile.
// - corner_hop_bwd_corner recomputes pd and each corner, runs the corner
//   backward from dagg, writes dpsg_k, adds dpd @ Wd^T into dvd, and adds
//   dWf, dbf, dWd, dWo, dbo, dlns, dlnb. Shared memory at h=64: Wd, Wo
//   (32 KB), Wf and the vectors (10 KB), four row tiles (vd, z, dt,
//   dpre; 64 KB), the tile's corner features (32 KB at ff <= 32), the
//   dWd and dWo patches (32 KB): 174,080 B. 15 barriers a tile.
// The scratch costs ~320 MB more device traffic at 500x500 (dagg and
// dvd each written and read once more, vd read twice), ~0.1 ms.
//
// The weight gradients are sums over B*H*W cells (x4 corners for dWo
// and dWf). Each thread owns a 4 x 4 patch of every h x h gradient its
// kernel adds and adds a tile's rows into it (rt::xty_acc), BM rows at a
// time, for the block's whole walk, in the thread's own slot of shared
// memory (read and written once a tile or corner, no barrier: registers
// held in the patches would push the h <= 32 instances past 255 and
// into spills). dWf (ff x h) is spread over the
// threads as (row, 4-channel chunk) units, each over a slice of the
// tile's cells, in registers. The vector gradients are per-thread sums
// in registers. The two gradient sets are the two halves of dw, so each
// kernel writes its own columns of one fp32 partial a block, at the end
// of its walk, each sum added in a fixed order, and
// rt::sum_partials_by_warps adds the partials in a fixed order. No
// atomics: the result repeats bit for bit.
//
// The grid is persistent: as many blocks as the SMs hold, fewer when the
// tiles are fewer, balanced so that no block takes more tiles than it
// must; both kernels take the same grid, so block b writes partial b.
//
// Widths: h up to 64, ff up to 32, two instances: HP = 64 (BM = 64
// cells, 4 a thread) and HP = 32 (BM = 64 cells, 2 a thread: with 4,
// both passes sat at 255 registers and spilled; the 64 patches of an
// h x h gradient shared by 4 thread groups, each over a quarter of the
// rows). Widths that are not a multiple of 4 take plain loads instead
// of 128-bit ones. At 96, the forward's cap, the node pass's weights
// and tiles alone would take ~300 KB, so these instances stop at 64.
//
// Wider (65 to 512): corner_hop_bwd_node_wide and corner_hop_bwd_corner_wide,
// on wide_rows.cuh (HP = 128, 256 or 512; tiles of 64, 32 or 8 cells),
// replace py4cast_tpu/ops/hop_kernel.py::_bwd_kernel (:267) there, with
// the same split into a node pass and a corner pass and dagg between
// them. What bounds it there: at h = 128 the five weights are 320 KB and
// each pass's h x h gradient patches 192 KB, and the register patches
// (224 a thread at h = 64) cannot grow; the work, 29 h^2 FMA-pairs a
// cell, is ~950 GFLOP at 500x500 and h = 256 (14 ms at the fp32 peak)
// against ~2.3 GB (0.7 ms): bound by operations. What the design does:
// the row steps run on five row tiles a pass, every product streaming
// its weight in chunks (cp.async, double-buffered); the rows the weight
// gradients need and no output holds (agg, u, dy, dupre from the node
// pass; z_k and dt_k of each corner and dpd from the corner pass; 13 x
// B H W h floats after the partials in `partial`,
// p4t_corner_hop_bwd_scratch) go to scratch, and wide::xty_partials sums
// dWf (feats_k^T dpsg_k), dWd, dWo, dNd0a, dNd0b and dNd1 after both
// passes, one fp32 partial a block over a slice of the rows; the eight
// vector gradients are per-tile column sums into one per-block sum (dbf
// as the column sums of dpd). Every sum runs in a fixed order: a call
// repeats bit for bit.

#include <cstdint>

#include "corner_hop_tiles.cuh"
#include "wide_rows.cuh"

namespace {

using namespace p4t;
using namespace p4t::rt;
using namespace p4t::hop;

struct Args {
  const float *psg0, *psg1, *psg2, *psg3, *vd, *feats, *g;
  const float *wf, *bf, *wd, *wo, *bo, *lns, *lnb, *nd0a, *nd0b, *nb0, *nd1, *nb1, *nlns;
  float *dpsg0, *dpsg1, *dpsg2, *dpsg3, *dvd, *dagg, *partial;
  int B, HW, h, ff, mean;
  int vec;  // h a multiple of 4, every row array 16-byte aligned
};

// Offsets of the gradients in one block's partial, in the wrapper's
// order: the corner pass's seven, then the node pass's seven.
struct Layout {
  int wf, bf, wd, wo, bo, lns, lnb, n0a, n0b, nb0, n1, nb1, nlns, nlnb, total;
  __host__ __device__ Layout(int h, int ff) {
    const int hh = h * h;
    wf = 0, bf = ff * h, wd = bf + h, wo = wd + hh, bo = wo + hh, lns = bo + h, lnb = lns + h;
    n0a = lnb + h, n0b = n0a + hh, nb0 = n0b + hh, n1 = nb0 + h, nb1 = n1 + hh;
    nlns = nb1 + h, nlnb = nlns + h, total = nlnb + h;
  }
};

template <int HP>
struct Shape {
  static constexpr int NX = HP / 4;        // lanes a row (4 columns each)
  static constexpr int NY = THREADS / NX;  // row groups
  static constexpr int TM = HP == 64 ? 4 : 2;  // rows (cells) a thread
  static constexpr int BM = NY * TM;       // cells a tile
  static constexpr int PT = NX * NX;       // 4x4 patches of an HP x HP gradient
  static constexpr int G = THREADS / PT;   // thread groups sharing the patches
  static constexpr int HH = HP * HP, TILE = BM * HP;
  // node pass: Wd, Wo, Nd0a, Nd0b, Nd1 (swizzled); Wf; 7 vectors (and a
  // pad); five row tiles; the dNd0a, dNd0b and dNd1 patches of the G groups
  static constexpr size_t node_floats = 5 * HH + MAX_FF * HP + 8 * HP + 5 * TILE + 3 * G * HH;
  // corner pass: Wd, Wo; Wf; the same vectors; four row tiles; the
  // tile's four corner features [4][BM][ff]; the dWd and dWo patches
  static constexpr size_t corner_floats =
      2 * HH + MAX_FF * HP + 8 * HP + 4 * TILE + 4 * BM * MAX_FF + 2 * G * HH;
  static constexpr size_t node_bytes = node_floats * sizeof(float);
  static constexpr size_t corner_bytes = corner_floats * sizeof(float);
  static_assert(THREADS % PT == 0 && BM % G == 0, "");
  // the end sums go where the row tiles were
  static_assert(NY * 4 * HP <= 5 * TILE, "node end sums fit the tiles");
  static_assert(NY * 4 * HP + 2 * THREADS * 4 <= 4 * TILE + 4 * BM * MAX_FF,
                "corner end sums fit the tiles");
  static_assert(node_bytes <= 232448 && corner_bytes <= 232448, "227 KB a block");
};

// A block's fixed part of both passes: the thread's micro-tile (rows r0..,
// columns c0..) and its 4x4 patch of an HP x HP gradient (rows f0..,
// columns pc0.., over the tile rows pr0 .. pr1).
template <int HP>
struct Thread {
  using S = Shape<HP>;
  int tid, tx, ty, c0, r0, pg, f0, pc0, pr0, pr1;
  __device__ Thread() {
    tid = threadIdx.x, tx = tid % S::NX, ty = tid / S::NX, c0 = 4 * tx, r0 = S::TM * ty;
    pg = tid / S::PT;
    const int pi = tid % S::PT;
    f0 = 4 * (pi / S::NX), pc0 = 4 * (pi % S::NX);
    pr0 = pg * (S::BM / S::G), pr1 = pr0 + S::BM / S::G;
  }
  // this thread's patch slot in a shared [G][HP][HP] accumulator
  __device__ float* slot(float* acc) const { return acc + (pg * HP + f0) * HP + pc0; }
};

// patch += X^T Y over the thread group's rows of two shared row tiles;
// the patch is the thread's own slot of shared memory (no barrier).
template <int HP>
__device__ __forceinline__ void add_xty(float* patch, const float* X, const float* Y,
                                        const Thread<HP>& t) {
  float p[4][4];
  load_tile<HP, 4>(p, patch, 0, 0);
  xty_acc<HP>(p, X, Y, t.f0, t.pc0, t.pr0, t.pr1);
  store_tile<HP, 4>(patch, 0, 0, p);
}

// Load the thread's rows of a (B*H*W, h) array, zero past the end.
template <int TM>
__device__ __forceinline__ void load_rows4(float (&v)[TM][4], const float* base,
                                           const int (&cell)[TM], const bool (&valid)[TM],
                                           int c0, int h, bool vec) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
    if (valid[i]) load4(v[i], base + (long long)cell[i] * h, c0, h, vec);
  }
}

// Sum G thread groups' [HP][HP] patch accumulators into out[rows][h].
template <int HP, int G>
__device__ __forceinline__ void put_patches(float* out, const float* acc, int rows, int h) {
  for (int i = threadIdx.x; i < rows * h; i += THREADS) {
    const int f = i / h, c = i % h;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) s += acc[(g * HP + f) * HP + c];
    out[i] = s;
  }
}

// Write a thread's four vector sums into s_red [NY][4][HP] by row group.
template <int HP>
__device__ __forceinline__ void put_sums(float* s_red, int ty, int c0, const float (&v0)[4],
                                         const float (&v1)[4], const float (&v2)[4],
                                         const float (&v3)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_red[(ty * 4 + 0) * HP + c0 + j] = v0[j];
    s_red[(ty * 4 + 1) * HP + c0 + j] = v1[j];
    s_red[(ty * 4 + 2) * HP + c0 + j] = v2[j];
    s_red[(ty * 4 + 3) * HP + c0 + j] = v3[j];
  }
}

// out[o_v + c] = sum over the row groups of s_red[.][v][c], v < 4.
template <int HP, int NY>
__device__ __forceinline__ void sum_rows(float* out, const float* s_red, int h, int o0, int o1,
                                         int o2, int o3) {
  for (int i = threadIdx.x; i < 4 * h; i += THREADS) {
    const int v = i / h, c = i % h;
    float s = 0.f;
    for (int y = 0; y < NY; ++y) s += s_red[(y * 4 + v) * HP + c];
    out[(v == 0 ? o0 : v == 1 ? o1 : v == 2 ? o2 : o3) + c] = s;
  }
}

template <int HP>
__global__ void __launch_bounds__(THREADS, 1) corner_hop_bwd_node(Args a) {
  using S = Shape<HP>;
  constexpr int NY = S::NY, TM = S::TM, BM = S::BM, G = S::G, HH = S::HH, TILE = S::TILE;
  const int h = a.h, ff = a.ff, HW = a.HW;
  const bool vec = a.vec != 0;
  const float* vd = a.vd;
  extern __shared__ __align__(16) float smem[];
  float* s_wd = smem;  // five [HP][HP] swizzled
  float* s_wo = s_wd + HH;
  float* s_n0a = s_wo + HH;
  float* s_n0b = s_n0a + HH;
  float* s_n1 = s_n0b + HH;
  float* s_wf = s_n1 + HH;            // [MAX_FF][HP]
  float* s_vec = s_wf + MAX_FF * HP;  // bf, bo, lns, lnb, nb0, nb1, nlns: [8][HP]
  float* s_vd = s_vec + 8 * HP;       // five [BM][HP] row tiles
  float* s_z = s_vd + TILE;           // [2][BM][HP]: z of even and odd corners; then u, dy
  float* s_agg = s_z + 2 * TILE;
  float* s_dup = s_agg + TILE;
  float* s_dn = s_dup + TILE;         // [3][G][HP][HP]: dNd0a, dNd0b, dNd1
  float* s_u = s_z;
  float* s_dy = s_z + TILE;

  stage_swizzled<HP>(s_wd, a.wd, h, h);
  stage_swizzled<HP>(s_wo, a.wo, h, h);
  stage_swizzled<HP>(s_n0a, a.nd0a, h, h);
  stage_swizzled<HP>(s_n0b, a.nd0b, h, h);
  stage_swizzled<HP>(s_n1, a.nd1, h, h);
  stage_common<HP>(s_wf, s_vec, a.wf, ff, h, a.bf, a.bo, a.lns, a.lnb, a.nb0, a.nb1, a.nlns,
                   nullptr);
  for (int i = threadIdx.x; i < 3 * G * HH; i += THREADS) s_dn[i] = 0.f;

  const Thread<HP> t;
  const int c0 = t.c0, r0 = t.r0;
  float* n0a_patch = t.slot(s_dn);
  float* n0b_patch = t.slot(s_dn + G * HH);
  float* n1_patch = t.slot(s_dn + 2 * G * HH);
  float v_nb0[4], v_nb1[4], v_nlns[4], v_nlnb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v_nb0[j] = v_nb1[j] = v_nlns[j] = v_nlnb[j] = 0.f;

  // B * H * W < 2^31 (the host checks): cell numbers are ints
  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers of s_vd are done
    load_rows<BM, HP>(
        s_vd,
        [=](int r) -> const float* {
          const int cell = tile * BM + r;
          return cell < n_cells ? vd + (long long)cell * h : nullptr;
        },
        h, vec, vd);
    int cell[TM], q[TM];
    bool valid[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cell[i] = tile * BM + r0 + i;
      valid[i] = cell[i] < n_cells;
      q[i] = valid[i] ? cell[i] % HW : 0;
    }
    wait_copies();
    __syncthreads();

    // ---- pd = vd @ Wd; the four corners into agg
    float pd[TM][4], agg[TM][4], acc[TM][4], in[TM][4];
    zero_tile<TM>(pd);
    tile_mm<HP, TM>(pd, s_vd, r0, s_wd, c0);
    zero_tile<TM>(agg);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      // a select, not an index into the parameters: that would copy
      // them to local memory
      const float* psg = k == 0 ? a.psg0 : k == 1 ? a.psg1 : k == 2 ? a.psg2 : a.psg3;
      const float* fe_k = a.feats + (long long)k * HW * ff;
      float* s_zk = s_z + (k & 1) * TILE;  // two buffers: one barrier a corner
      load_rows4<TM>(in, psg, cell, valid, c0, h, vec);
      float dsil[TM][4];
      corner_pre<HP, TM>(
          acc, dsil, in, pd,
          [&](int i, int f) { return valid[i] ? __ldg(fe_k + (long long)q[i] * ff + f) : 0.f; },
          s_wf, s_vec, ff, c0);
      store_tile<HP, TM>(s_zk, r0, c0, acc);
      __syncthreads();
      corner_into_agg<HP, TM>(agg, s_zk, r0, s_wo, s_vec, c0, h);
    }
    if (a.mean) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) agg[i][j] *= 0.25f;
    }
    store_tile<HP, TM>(s_agg, r0, c0, agg);
    __syncthreads();  // s_agg complete; both z tiles free

    // ---- u = silu(vd @ Nd0a + agg @ Nd0b + nb0) -> s_u; silu' kept
    float dsu[TM][4], gg[TM][4];
    load_rows4<TM>(gg, a.g, cell, valid, c0, h, vec);
    zero_tile<TM>(acc);
    tile_mm<HP, TM>(acc, s_vd, r0, s_n0a, c0);
    tile_mm<HP, TM>(acc, s_agg, r0, s_n0b, c0);
    {
      float nb0[4];
      lds4(nb0, s_vec + 4 * HP + c0);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = acc[i][j] + nb0[j];
          const float sg = sigmoid(p);
          dsu[i][j] = sg * (1.f + p * (1.f - sg));
          acc[i][j] = p * sg;
        }
    }
    store_tile<HP, TM>(s_u, r0, c0, acc);
    __syncthreads();

    // ---- y = u @ Nd1 + nb1 -> xhat;  g -> dy through the LayerNorm -> s_dy
    zero_tile<TM>(acc);
    tile_mm<HP, TM>(acc, s_u, r0, s_n1, c0);
    {
      float nb1[4], nlns[4];
      lds4(nb1, s_vec + 5 * HP + c0);
      lds4(nlns, s_vec + 6 * HP + c0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += nb1[j];
        const float inv = ln_normalize4<S::NX>(acc[i], c0, h);  // acc[i] = xhat
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          in[i][j] = gg[i][j];
          v_nlns[j] = fmaf(gg[i][j], acc[i][j], v_nlns[j]);
          v_nlnb[j] += gg[i][j];
        }
        ln_backward4<S::NX>(in[i], acc[i], inv, nlns, c0, h);
#pragma unroll
        for (int j = 0; j < 4; ++j) v_nb1[j] += in[i][j];
      }
    }
    store_tile<HP, TM>(s_dy, r0, c0, in);
    __syncthreads();

    // ---- dNd1 += u^T dy;  dupre = (dy @ Nd1^T) * silu'(u_pre) -> s_dup
    add_xty<HP>(n1_patch, s_u, s_dy, t);
    zero_tile<TM>(acc);
    tile_mm_t<HP, TM>(acc, s_dy, r0, s_n1, c0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= dsu[i][j];
        v_nb0[j] += acc[i][j];
      }
    store_tile<HP, TM>(s_dup, r0, c0, acc);
    __syncthreads();

    // ---- dNd0a += vd^T dupre, dNd0b += agg^T dupre;  dvd, dagg
    add_xty<HP>(n0a_patch, s_vd, s_dup, t);
    add_xty<HP>(n0b_patch, s_agg, s_dup, t);
    zero_tile<TM>(acc);
    tile_mm_t<HP, TM>(acc, s_dup, r0, s_n0a, c0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = gg[i][j] + acc[i][j];
    store_rows<TM>(a.dvd, cell, valid, c0, h, vec, acc);
    zero_tile<TM>(acc);
    tile_mm_t<HP, TM>(acc, s_dup, r0, s_n0b, c0);
    if (a.mean) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= 0.25f;
    }
    store_rows<TM>(a.dagg, cell, valid, c0, h, vec, acc);
  }

  // this block's dNd0a, dNd0b, dnb0, dNd1, dnb1, dnlns, dnlnb: the patches
  // by thread group, the vector sums by row group through the tiles
  __syncthreads();
  float* s_red = s_vd;  // [NY][4][HP]
  put_sums<HP>(s_red, t.ty, c0, v_nb0, v_nb1, v_nlns, v_nlnb);
  __syncthreads();
  const Layout L(h, ff);
  float* out = a.partial + (long long)blockIdx.x * L.total;
  put_patches<HP, G>(out + L.n0a, s_dn, h, h);
  put_patches<HP, G>(out + L.n0b, s_dn + G * HH, h, h);
  put_patches<HP, G>(out + L.n1, s_dn + 2 * G * HH, h, h);
  sum_rows<HP, NY>(out, s_red, h, L.nb0, L.nb1, L.nlns, L.nlnb);
}

template <int HP>
__global__ void __launch_bounds__(THREADS, 1) corner_hop_bwd_corner(Args a) {
  using S = Shape<HP>;
  constexpr int NX = S::NX, NY = S::NY, TM = S::TM, BM = S::BM, G = S::G, HH = S::HH,
                TILE = S::TILE;
  const int h = a.h, ff = a.ff, HW = a.HW;
  const bool vec = a.vec != 0;
  const float* vd = a.vd;
  extern __shared__ __align__(16) float smem[];
  float* s_wd = smem;  // two [HP][HP] swizzled
  float* s_wo = s_wd + HH;
  float* s_wf = s_wo + HH;            // [MAX_FF][HP]
  float* s_vec = s_wf + MAX_FF * HP;  // bf, bo, lns, ... (as the node pass's): [8][HP]
  float* s_vd = s_vec + 8 * HP;       // four [BM][HP] row tiles
  float* s_z = s_vd + TILE;           // z, then dpd
  float* s_dt = s_z + TILE;
  float* s_dp = s_dt + TILE;
  float* s_fe = s_dp + TILE;          // [4][BM][ff]
  float* s_dwd = s_fe + 4 * BM * MAX_FF;  // [2][G][HP][HP]: dWd, dWo
  float* s_dwo = s_dwd + G * HH;

  stage_swizzled<HP>(s_wd, a.wd, h, h);
  stage_swizzled<HP>(s_wo, a.wo, h, h);
  stage_common<HP>(s_wf, s_vec, a.wf, ff, h, a.bf, a.bo, a.lns, a.lnb, a.nb0, a.nb1, a.nlns,
                   nullptr);
  for (int i = threadIdx.x; i < 2 * G * HH; i += THREADS) s_dwd[i] = 0.f;

  const Thread<HP> t;
  const int tid = t.tid, c0 = t.c0, r0 = t.r0;
  float* dwd_patch = t.slot(s_dwd);
  float* dwo_patch = t.slot(s_dwo);
  float v_bf[4], v_bo[4], v_lns[4], v_lnb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v_bf[j] = v_bo[j] = v_lns[j] = v_lnb[j] = 0.f;
  // dWf: ff * NX units (a row f of dWf, a 4-channel chunk), each over a
  // slice of the tile's cells (rows sl, sl + n_sl, ...); at most two
  // units a thread (ff * NX <= 512), in registers for the whole walk
  const int n_units = ff * NX;
  const int n_sl = n_units >= THREADS ? 1 : THREADS / n_units;
  const int sl = n_units >= THREADS ? 0 : tid / n_units;
  const int u0 = n_units >= THREADS ? tid : tid % n_units, u1 = tid + THREADS;
  const bool on0 = sl < n_sl, on1 = n_units > THREADS && u1 < n_units;
  const int wf_f0 = u0 / NX, wf_c0 = 4 * (u0 % NX), wf_f1 = u1 / NX, wf_c1 = 4 * (u1 % NX);
  float dwf[2][4];
  zero_tile<2>(dwf);

  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers of s_vd and s_fe are done
    load_rows<BM, HP>(
        s_vd,
        [=](int r) -> const float* {
          const int cell = tile * BM + r;
          return cell < n_cells ? vd + (long long)cell * h : nullptr;
        },
        h, vec, vd);
    for (int i = tid; i < 4 * BM * ff; i += THREADS) {
      const int k = i / (BM * ff), rf = i - k * BM * ff, r = rf / ff, f = rf - r * ff;
      const int cell = tile * BM + r;
      s_fe[i] = cell < n_cells ? a.feats[((long long)k * HW + cell % HW) * ff + f] : 0.f;
    }
    int cell[TM];
    bool valid[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cell[i] = tile * BM + r0 + i;
      valid[i] = cell[i] < n_cells;
    }
    float dg[TM][4];  // dagg, 0 past the end: those rows add nothing
    load_rows4<TM>(dg, a.dagg, cell, valid, c0, h, vec);
    wait_copies();
    __syncthreads();

    float pd[TM][4], dpd[TM][4], acc[TM][4], in[TM][4];
    zero_tile<TM>(pd);
    tile_mm<HP, TM>(pd, s_vd, r0, s_wd, c0);
    zero_tile<TM>(dpd);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const float* psg = k == 0 ? a.psg0 : k == 1 ? a.psg1 : k == 2 ? a.psg2 : a.psg3;
      float* dpsg = k == 0 ? a.dpsg0 : k == 1 ? a.dpsg1 : k == 2 ? a.dpsg2 : a.dpsg3;
      const float* fe_k = s_fe + k * BM * ff;

      // ---- z = silu(pre) -> s_z; silu' kept
      load_rows4<TM>(in, psg, cell, valid, c0, h, vec);
      float dsil[TM][4];
      corner_pre<HP, TM>(
          acc, dsil, in, pd, [&](int i, int f) { return fe_k[(r0 + i) * ff + f]; }, s_wf,
          s_vec, ff, c0);
      store_tile<HP, TM>(s_z, r0, c0, acc);
      __syncthreads();

      // ---- t = z @ Wo + bo -> xhat;  dagg -> dt through the LayerNorm -> s_dt
      zero_tile<TM>(acc);
      tile_mm<HP, TM>(acc, s_z, r0, s_wo, c0);
      {
        float bo[4], lns[4];
        lds4(bo, s_vec + HP + c0);
        lds4(lns, s_vec + 2 * HP + c0);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += bo[j];
          const float inv = ln_normalize4<NX>(acc[i], c0, h);  // acc[i] = xhat
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            in[i][j] = dg[i][j];
            v_lns[j] = fmaf(dg[i][j], acc[i][j], v_lns[j]);
            v_lnb[j] += dg[i][j];
          }
          ln_backward4<NX>(in[i], acc[i], inv, lns, c0, h);
#pragma unroll
          for (int j = 0; j < 4; ++j) v_bo[j] += in[i][j];
        }
      }
      store_tile<HP, TM>(s_dt, r0, c0, in);
      __syncthreads();

      // ---- dWo += z^T dt;  dpre = (dt @ Wo^T) * silu'(pre) -> dpsg_k, s_dp
      add_xty<HP>(dwo_patch, s_z, s_dt, t);
      zero_tile<TM>(acc);
      tile_mm_t<HP, TM>(acc, s_dt, r0, s_wo, c0);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] *= dsil[i][j];
          v_bf[j] += acc[i][j];
          dpd[i][j] += acc[i][j];
        }
      store_rows<TM>(dpsg, cell, valid, c0, h, vec, acc);
      store_tile<HP, TM>(s_dp, r0, c0, acc);
      __syncthreads();

      // ---- dWf += feats_k^T dpre, by units
      if (on0) {
        for (int r = sl; r < BM; r += n_sl) {
          const float x = fe_k[r * ff + wf_f0];
          float y[4];
          lds4(y, s_dp + r * HP + wf_c0);
#pragma unroll
          for (int j = 0; j < 4; ++j) dwf[0][j] = fmaf(x, y[j], dwf[0][j]);
        }
      }
      if (on1) {
        for (int r = 0; r < BM; ++r) {
          const float x = fe_k[r * ff + wf_f1];
          float y[4];
          lds4(y, s_dp + r * HP + wf_c1);
#pragma unroll
          for (int j = 0; j < 4; ++j) dwf[1][j] = fmaf(x, y[j], dwf[1][j]);
        }
      }
    }

    // ---- dWd += vd^T dpd;  dvd += dpd @ Wd^T
    store_tile<HP, TM>(s_z, r0, c0, dpd);  // s_z's last readers passed the barrier above
    __syncthreads();
    add_xty<HP>(dwd_patch, s_vd, s_z, t);
    load_rows4<TM>(in, a.dvd, cell, valid, c0, h, vec);
    zero_tile<TM>(acc);
    tile_mm_t<HP, TM>(acc, s_z, r0, s_wd, c0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = in[i][j] + acc[i][j];
    store_rows<TM>(a.dvd, cell, valid, c0, h, vec, acc);
  }

  // this block's dWf, dbf, dWd, dWo, dbo, dlns, dlnb: the patches by
  // thread group, the vector sums by row group and the dWf units by slice
  // through the tiles
  __syncthreads();
  float* s_red = s_vd;                  // [NY][4][HP]
  float* s_gwf = s_red + NY * 4 * HP;   // [n_sl][n_units][4], or [2 * THREADS][4]
  put_sums<HP>(s_red, t.ty, c0, v_bf, v_bo, v_lns, v_lnb);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (on0) s_gwf[(sl * n_units + u0) * 4 + j] = dwf[0][j];
    if (on1) s_gwf[u1 * 4 + j] = dwf[1][j];
  }
  __syncthreads();
  const Layout L(h, ff);
  float* out = a.partial + (long long)blockIdx.x * L.total;
  for (int i = tid; i < ff * h; i += THREADS) {
    const int f = i / h, c = i % h, u = f * NX + c / 4;
    float s = 0.f;
    for (int k = 0; k < n_sl; ++k) s += s_gwf[(k * n_units + u) * 4 + c % 4];
    out[L.wf + i] = s;
  }
  put_patches<HP, G>(out + L.wd, s_dwd, h, h);
  put_patches<HP, G>(out + L.wo, s_dwo, h, h);
  sum_rows<HP, NY>(out, s_red, h, L.bf, L.bo, L.lns, L.lnb);
}

template <int HP>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      corner_hop_bwd_node<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Shape<HP>::node_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(corner_hop_bwd_corner<HP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Shape<HP>::corner_bytes);
}

// Resident blocks an SM of the node pass (per_sm[0]) and the corner pass
// (per_sm[1]).
template <int HP>
cudaError_t blocks_per_sm(int (&per_sm)[2]) {
  cudaError_t err = configure<HP>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[0], corner_hop_bwd_node<HP>,
                                                        THREADS, Shape<HP>::node_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[1], corner_hop_bwd_corner<HP>,
                                                        THREADS, Shape<HP>::corner_bytes);
  return err;
}

// As many blocks as the SMs hold of either pass, or fewer: the tiles
// spread evenly, so that no block takes more tiles than the largest
// share must. Both passes take this grid.
template <int HP>
cudaError_t grid(int B, int HW, int* blocks) {
  int dev = 0, sms = 0, per_sm[2] = {0, 0};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm<HP>(per_sm);
  if (err != cudaSuccess) return err;
  const int fit = per_sm[0] < per_sm[1] ? per_sm[0] : per_sm[1];
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = ((long long)B * HW + Shape<HP>::BM - 1) / Shape<HP>::BM;
  const long long cap = (long long)sms * fit;
  const long long per_block = (tiles + cap - 1) / cap;
  const long long n = (tiles + per_block - 1) / per_block;
  *blocks = (int)(n > 0 ? n : 1);
  return cudaSuccess;
}

template <int HP>
cudaError_t launch(const Args& a, float* dw, int blocks, cudaStream_t stream) {
  cudaError_t err = configure<HP>();
  if (err != cudaSuccess) return err;
  corner_hop_bwd_node<HP><<<blocks, THREADS, Shape<HP>::node_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  corner_hop_bwd_corner<HP><<<blocks, THREADS, Shape<HP>::corner_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials_by_warps(a.partial, dw, Layout(a.h, a.ff).total, blocks, stream);
}

template <int HP>
cudaError_t attributes(int* out) {
  int per_sm[2] = {0, 0};
  cudaFuncAttributes fa[2];
  cudaError_t err = blocks_per_sm<HP>(per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa[0], corner_hop_bwd_node<HP>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa[1], corner_hop_bwd_corner<HP>);
  if (err != cudaSuccess) return err;
  const size_t smem[2] = {Shape<HP>::node_bytes, Shape<HP>::corner_bytes};
  for (int k = 0; k < 2; ++k) {
    out[5 * k + 0] = fa[k].numRegs;
    out[5 * k + 1] = (int)fa[k].localSizeBytes;
    out[5 * k + 2] = (int)smem[k];
    out[5 * k + 3] = per_sm[k];
    out[5 * k + 4] = Shape<HP>::BM;
  }
  return cudaSuccess;
}

// ------------------------------------------------- wide rows (h > 64)
template <int HP>
struct WideShape {
  using C = wide::Cfg<HP>;
  // node pass: vd (then silu'(u_pre)), z (then u, g * xhat), agg, dy, g
  // (then dupre); corner pass: vd, z (then dagg * xhat, dpd), dt, silu'
  // (then dpre), dagg. Five row tiles, the weight chunks, four vector sums
  static constexpr size_t smem_bytes = (5 * C::TILE + C::CHUNKS + 4 * HP) * sizeof(float);
  static_assert(smem_bytes <= 232448, "227 KB a block");
};

// The scratch rows, each B*H*W x h, after the partials: the node pass's
// agg, u, dy, dupre (0..3), the corner pass's z_k (4 + k), dt_k (8 + k)
// and dpd (12).
constexpr int SCRATCH_ARRAYS = 13;

inline long long scratch_offset(const Layout& L, int blocks) {
  return ((long long)blocks * L.total + 3) / 4 * 4;
}

// pre_k = feats_k @ Wf + bf + psg_k + pd for the thread's rows: acc =
// silu(pre_k), and dsil = silu'(pre_k) when asked (the order of
// corner_pre's sums).
template <class C, bool DSIL>
__device__ __forceinline__ void wide_corner_pre(wide::Frag<C>& acc, wide::Frag<C>& in,
                                                const wide::Frag<C>& pd, const float* fe_k,
                                                const int (&q)[C::TM], const bool (&valid)[C::TM],
                                                const Args& a, const wide::Lane<C>& t) {
  using namespace p4t::wide;
  constexpr int TM = C::TM, CJ = C::CJ;
  const int h = a.h, ff = a.ff;
  zero<C>(acc);
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
  float v[CJ][4];
  load_vec<C>(v, a.bf, t, h);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ((acc[i][j][c] + v[j][c]) + in[i][j][c]) + pd[i][j][c];
        const float sg = wide::sigmoid(p);
        if (DSIL) in[i][j][c] = sg * (1.f + p * (1.f - sg));
        acc[i][j][c] = p * sg;
      }
}

// The thread's rows of a (B*H*W, h) array, zero past the end.
template <class C>
__device__ __forceinline__ void load_cells(wide::Frag<C>& v, const float* base,
                                           const int (&cell)[C::TM], const bool (&valid)[C::TM],
                                           const wide::Lane<C>& t, int h, bool vec) {
  wide::zero<C>(v);
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
    if (valid[i]) wide::load_row<C>(v[i], base + (long long)cell[i] * h, t, h, vec);
}

template <class C>
__device__ __forceinline__ void store_cells(float* base, const int (&cell)[C::TM],
                                            const bool (&valid)[C::TM], const wide::Lane<C>& t,
                                            int h, bool vec, const wide::Frag<C>& v) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
    if (valid[i]) wide::store_row<C>(base + (long long)cell[i] * h, t, h, vec, v[i]);
}

template <class C>
__device__ __forceinline__ void scale(wide::Frag<C>& v, float s) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::CJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[i][j][c] *= s;
}

template <int HP>
__global__ void __launch_bounds__(THREADS, 1)
    corner_hop_bwd_node_wide(Args a, float* scratch, int wvec_flag) {
  using namespace p4t::wide;
  using C = Cfg<HP>;
  constexpr int TM = C::TM, CJ = C::CJ, BM = C::BM;
  const int h = a.h, ff = a.ff, HW = a.HW;
  const bool vec = a.vec != 0, wvec = wvec_flag != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_vd = smem;  // five [BM][LD] row tiles
  float* s_z = s_vd + C::TILE;
  float* s_agg = s_z + C::TILE;
  float* s_dy = s_agg + C::TILE;
  float* s_g = s_dy + C::TILE;
  float* s_w = s_g + C::TILE;      // the weight chunks
  float* s_sum = s_w + C::CHUNKS;  // [4][HP]: dnb0, dnb1, dnlns, dnlnb
  for (int i = threadIdx.x; i < 4 * HP; i += THREADS) s_sum[i] = 0.f;
  const long long rh = (long long)a.B * HW * h;
  float* agg_rows = scratch;
  float* u_rows = scratch + rh;
  float* dy_rows = scratch + 2 * rh;
  float* dup_rows = scratch + 3 * rh;
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
    int cell[TM], q[TM];
    bool valid[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cell[i] = tile * BM + TM * t.ty + i;
      valid[i] = cell[i] < n_cells;
      q[i] = valid[i] ? cell[i] % HW : 0;
    }

    // ---- pd = vd @ Wd; the four corners into agg
    Frag<C> pd, agg, acc, in;
    zero<C>(pd);
    mm<C, false>(pd, s_vd, t, a.wd, h, h, wvec, s_w);
    zero<C>(agg);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      // a select, not an index into the parameters: that would copy
      // them to local memory
      const float* psg = k == 0 ? a.psg0 : k == 1 ? a.psg1 : k == 2 ? a.psg2 : a.psg3;
      load_cells<C>(in, psg, cell, valid, t, h, vec);
      wide_corner_pre<C, false>(acc, in, pd, a.feats + (long long)k * HW * ff, q, valid, a, t);
      put<C>(s_z, t, acc);  // the last product's readers of s_z are done
      zero<C>(acc);
      mm<C, false>(acc, s_z, t, a.wo, h, h, wvec, s_w);
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
    if (a.mean) scale<C>(agg, 0.25f);
    put<C>(s_agg, t, agg);
    store_cells<C>(agg_rows, cell, valid, t, h, vec, agg);

    // ---- u = silu(vd @ Nd0a + agg @ Nd0b + nb0) -> s_z, scratch;
    // silu'(u_pre) -> s_vd (vd's last reader was the Nd0a product)
    zero<C>(acc);
    mm<C, false>(acc, s_vd, t, a.nd0a, h, h, wvec, s_w);
    mm<C, false>(acc, s_agg, t, a.nd0b, h, h, wvec, s_w);
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
            const float sg = wide::sigmoid(p);
            in[i][j][c] = sg * (1.f + p * (1.f - sg));
            acc[i][j][c] = p * sg;
          }
    }
    put<C>(s_z, t, acc);
    put<C>(s_vd, t, in);
    store_cells<C>(u_rows, cell, valid, t, h, vec, acc);

    // ---- y = u @ Nd1 + nb1 -> xhat;  g -> dy through the LayerNorm ->
    // s_dy, scratch; g -> s_g, g * xhat -> s_z
    zero<C>(acc);
    mm<C, false>(acc, s_z, t, a.nd1, h, h, wvec, s_w);
    {
      float v[CJ][4], inv[TM];
      load_vec<C>(v, a.nb1, t, h);
      add_vec<C>(acc, v);
#pragma unroll
      for (int i = 0; i < TM; ++i) inv[i] = ln_normalize<C>(acc[i], t, h);  // acc = xhat
      load_cells<C>(in, a.g, cell, valid, t, h, vec);
      put<C>(s_g, t, in);
      put_product<C>(s_z, t, in, acc);
      load_vec<C>(v, a.nlns, t, h);
#pragma unroll
      for (int i = 0; i < TM; ++i) ln_backward<C>(in[i], acc[i], inv[i], v, t, h);  // in = dy
    }
    put<C>(s_dy, t, in);
    store_cells<C>(dy_rows, cell, valid, t, h, vec, in);

    // ---- dupre = (dy @ Nd1^T) * silu'(u_pre) -> s_g (after the tile's
    // dnlnb, dnlns and dnb1 shares are taken from s_g, s_z, s_dy), scratch
    zero<C>(acc);
    mm<C, true>(acc, s_dy, t, a.nd1, h, h, wvec, s_w);
    add_colsums<C>(s_sum + HP, s_dy);
    add_colsums<C>(s_sum + 2 * HP, s_z);
    add_colsums<C>(s_sum + 3 * HP, s_g);
    get<C>(in, s_vd, t);  // silu'(u_pre): this thread's own
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= in[i][j][c];
    __syncthreads();  // the column sums' reads of s_g are done
    put<C>(s_g, t, acc);
    store_cells<C>(dup_rows, cell, valid, t, h, vec, acc);

    // ---- dvd = g + dupre @ Nd0a^T;  dagg = dupre @ Nd0b^T (/4 if mean)
    zero<C>(acc);
    mm<C, true>(acc, s_g, t, a.nd0a, h, h, wvec, s_w);
    load_cells<C>(in, a.g, cell, valid, t, h, vec);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = in[i][j][c] + acc[i][j][c];
    store_cells<C>(a.dvd, cell, valid, t, h, vec, acc);
    zero<C>(acc);
    mm<C, true>(acc, s_g, t, a.nd0b, h, h, wvec, s_w);
    if (a.mean) scale<C>(acc, 0.25f);
    store_cells<C>(a.dagg, cell, valid, t, h, vec, acc);
    add_colsums<C>(s_sum, s_g);  // dnb0 (s_g complete: the products' barriers)
  }

  __syncthreads();
  const Layout L(h, ff);
  float* out = a.partial + (long long)blockIdx.x * L.total;
  for (int i = threadIdx.x; i < 4 * h; i += THREADS) {
    const int v = i / h, c = i % h;
    out[(v == 0 ? L.nb0 : v == 1 ? L.nb1 : v == 2 ? L.nlns : L.nlnb) + c] = s_sum[v * HP + c];
  }
}

template <int HP>
__global__ void __launch_bounds__(THREADS, 1)
    corner_hop_bwd_corner_wide(Args a, float* scratch, int wvec_flag) {
  using namespace p4t::wide;
  using C = Cfg<HP>;
  constexpr int TM = C::TM, CJ = C::CJ, BM = C::BM;
  const int h = a.h, ff = a.ff, HW = a.HW;
  const bool vec = a.vec != 0, wvec = wvec_flag != 0;
  extern __shared__ __align__(16) float smem[];
  float* s_vd = smem;  // five [BM][LD] row tiles
  float* s_z = s_vd + C::TILE;
  float* s_dt = s_z + C::TILE;
  float* s_dp = s_dt + C::TILE;
  float* s_dg = s_dp + C::TILE;
  float* s_w = s_dg + C::TILE;     // the weight chunks
  float* s_sum = s_w + C::CHUNKS;  // [4][HP]: dbf, dbo, dlns, dlnb
  for (int i = threadIdx.x; i < 4 * HP; i += THREADS) s_sum[i] = 0.f;
  const long long rh = (long long)a.B * HW * h;
  float* dpd_rows = scratch + 12 * rh;
  const Lane<C> t;

  const int n_cells = a.B * HW;
  const int n_tiles = (n_cells + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers of every tile are done
    auto rows_of = [=](const float* base) {
      return [=](int r) -> const float* {
        const int cell = tile * BM + r;
        return cell < n_cells ? base + (long long)cell * h : nullptr;
      };
    };
    fill_tile<C>(s_vd, rows_of(a.vd), h, vec, a.vd);
    fill_tile<C>(s_dg, rows_of(a.dagg), h, vec, a.dagg);
    int cell[TM], q[TM];
    bool valid[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cell[i] = tile * BM + TM * t.ty + i;
      valid[i] = cell[i] < n_cells;
      q[i] = valid[i] ? cell[i] % HW : 0;
    }

    Frag<C> pd, dpd, acc, in;
    zero<C>(pd);
    mm<C, false>(pd, s_vd, t, a.wd, h, h, wvec, s_w);
    zero<C>(dpd);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const float* psg = k == 0 ? a.psg0 : k == 1 ? a.psg1 : k == 2 ? a.psg2 : a.psg3;
      float* dpsg = k == 0 ? a.dpsg0 : k == 1 ? a.dpsg1 : k == 2 ? a.dpsg2 : a.dpsg3;

      // ---- z = silu(pre) -> s_z, scratch; silu'(pre) -> s_dp
      load_cells<C>(in, psg, cell, valid, t, h, vec);
      wide_corner_pre<C, true>(acc, in, pd, a.feats + (long long)k * HW * ff, q, valid, a, t);
      put<C>(s_z, t, acc);
      put<C>(s_dp, t, in);
      store_cells<C>(scratch + (4 + k) * rh, cell, valid, t, h, vec, acc);

      // ---- t = z @ Wo + bo -> xhat;  dagg -> dt through the LayerNorm ->
      // s_dt, scratch; dagg * xhat -> s_z
      zero<C>(acc);
      mm<C, false>(acc, s_z, t, a.wo, h, h, wvec, s_w);
      {
        float v[CJ][4], inv[TM];
        load_vec<C>(v, a.bo, t, h);
        add_vec<C>(acc, v);
#pragma unroll
        for (int i = 0; i < TM; ++i) inv[i] = ln_normalize<C>(acc[i], t, h);  // acc = xhat
        get<C>(in, s_dg, t);  // dagg: this thread's own rows
        put_product<C>(s_z, t, in, acc);
        load_vec<C>(v, a.lns, t, h);
#pragma unroll
        for (int i = 0; i < TM; ++i) ln_backward<C>(in[i], acc[i], inv[i], v, t, h);  // in = dt
      }
      put<C>(s_dt, t, in);
      store_cells<C>(scratch + (8 + k) * rh, cell, valid, t, h, vec, in);

      // ---- dpre = (dt @ Wo^T) * silu'(pre) -> dpsg_k; dpd += dpre
      zero<C>(acc);
      mm<C, true>(acc, s_dt, t, a.wo, h, h, wvec, s_w);
      // this corner's shares of dlns, dbo and dlnb (every tile complete:
      // the product's barriers)
      add_colsums<C>(s_sum + HP, s_dt);
      add_colsums<C>(s_sum + 2 * HP, s_z);
      add_colsums<C>(s_sum + 3 * HP, s_dg);
      get<C>(in, s_dp, t);  // silu'(pre): this thread's own
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][j][c] *= in[i][j][c];
            dpd[i][j][c] += acc[i][j][c];
          }
      store_cells<C>(dpsg, cell, valid, t, h, vec, acc);
      __syncthreads();  // the column sums' reads are done before the next stores
    }

    // ---- dvd += dpd @ Wd^T;  dpd -> s_z, scratch (for dWd), and dbf's share
    put<C>(s_z, t, dpd);
    store_cells<C>(dpd_rows, cell, valid, t, h, vec, dpd);
    zero<C>(acc);
    mm<C, true>(acc, s_z, t, a.wd, h, h, wvec, s_w);
    load_cells<C>(in, a.dvd, cell, valid, t, h, vec);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = in[i][j][c] + acc[i][j][c];
    store_cells<C>(a.dvd, cell, valid, t, h, vec, acc);
    add_colsums<C>(s_sum, s_z);  // dbf = the column sums of dpd
  }

  __syncthreads();
  const Layout L(h, ff);
  float* out = a.partial + (long long)blockIdx.x * L.total;
  for (int i = threadIdx.x; i < 4 * h; i += THREADS) {
    const int v = i / h, c = i % h;
    out[(v == 0 ? L.bf : v == 1 ? L.bo : v == 2 ? L.lns : L.lnb) + c] = s_sum[v * HP + c];
  }
}

template <int HP>
cudaError_t grid_wide(int B, int HW, int* blocks) {
  constexpr size_t smem = WideShape<HP>::smem_bytes;
  const long long tiles = ((long long)B * HW + wide::Cfg<HP>::BM - 1) / wide::Cfg<HP>::BM;
  int node = 0, corner = 0;
  cudaError_t err = wide::persistent_grid(corner_hop_bwd_node_wide<HP>, smem, tiles, &node);
  if (err == cudaSuccess)
    err = wide::persistent_grid(corner_hop_bwd_corner_wide<HP>, smem, tiles, &corner);
  *blocks = node < corner ? node : corner;  // both passes take this grid
  return err;
}

// One xty_partials launch: sum over nseg (X, Y) pairs of X^T Y into the
// gradient at `off` of each block's partial.
inline cudaError_t xty(const float* const (&x)[4], const float* const (&y)[4], int nseg,
                       long long rows, long long xmod, int K, int N, float* partial,
                       const Layout& L, int off, int blocks, cudaStream_t stream) {
  return wide::launch_xty({x[0], x[1], x[2], x[3], y[0], y[1], y[2], y[3], rows, xmod, nseg, K,
                           N, partial, L.total, off},
                          blocks, stream);
}

template <int HP>
cudaError_t launch_wide(const Args& a, float* dw, int blocks, int wvec, cudaStream_t stream) {
  constexpr size_t smem = WideShape<HP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(corner_hop_bwd_node_wide<HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(corner_hop_bwd_corner_wide<HP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Layout L(a.h, a.ff);
  float* scratch = a.partial + scratch_offset(L, blocks);
  corner_hop_bwd_node_wide<HP><<<blocks, THREADS, smem, stream>>>(a, scratch, wvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  corner_hop_bwd_corner_wide<HP><<<blocks, THREADS, smem, stream>>>(a, scratch, wvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int h = a.h, ff = a.ff;
  const long long rows = (long long)a.B * a.HW, rh = rows * h;
  const float* s[SCRATCH_ARRAYS];
  for (int i = 0; i < SCRATCH_ARRAYS; ++i) s[i] = scratch + i * rh;
  const long long fk = (long long)a.HW * ff;  // one corner's features
  const float* const fe[4] = {a.feats, a.feats + fk, a.feats + 2 * fk, a.feats + 3 * fk};
  const float* const dpsg[4] = {a.dpsg0, a.dpsg1, a.dpsg2, a.dpsg3};
  const float* const vd[4] = {a.vd, a.vd, a.vd, a.vd};
  const float* const z[4] = {s[4], s[5], s[6], s[7]};
  const float* const dt[4] = {s[8], s[9], s[10], s[11]};
  const float* const dpd[4] = {s[12], s[12], s[12], s[12]};
  const float* const agg[4] = {s[0], s[0], s[0], s[0]};
  const float* const u[4] = {s[1], s[1], s[1], s[1]};
  const float* const dy[4] = {s[2], s[2], s[2], s[2]};
  const float* const dup[4] = {s[3], s[3], s[3], s[3]};
  // dWf = sum_k feats_k^T dpre_k (feats_k row r % (H W): the batch shares
  // it), dWd = vd^T dpd, dWo = sum_k z_k^T dt_k, dNd0a = vd^T dupre,
  // dNd0b = agg^T dupre, dNd1 = u^T dy
  if (err == cudaSuccess) err = xty(fe, dpsg, 4, rows, a.HW, ff, h, a.partial, L, L.wf, blocks, stream);
  if (err == cudaSuccess) err = xty(vd, dpd, 1, rows, rows, h, h, a.partial, L, L.wd, blocks, stream);
  if (err == cudaSuccess) err = xty(z, dt, 4, rows, rows, h, h, a.partial, L, L.wo, blocks, stream);
  if (err == cudaSuccess) err = xty(vd, dup, 1, rows, rows, h, h, a.partial, L, L.n0a, blocks, stream);
  if (err == cudaSuccess) err = xty(agg, dup, 1, rows, rows, h, h, a.partial, L, L.n0b, blocks, stream);
  if (err == cudaSuccess) err = xty(u, dy, 1, rows, rows, h, h, a.partial, L, L.n1, blocks, stream);
  if (err != cudaSuccess) return err;
  return launch_sum_partials_by_warps(a.partial, dw, L.total, blocks, stream);
}

template <int HP>
cudaError_t attributes_wide(int* out) {
  constexpr size_t smem = WideShape<HP>::smem_bytes;
  cudaError_t err = wide::kernel_attributes(corner_hop_bwd_node_wide<HP>, smem,
                                            wide::Cfg<HP>::BM, out);
  if (err != cudaSuccess) return err;
  return wide::kernel_attributes(corner_hop_bwd_corner_wide<HP>, smem, wide::Cfg<HP>::BM,
                                 out + 5);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// The row-tile instances take widths up to WIDE_ABOVE; above it the wide
// instance (wide_rows.cuh) takes them, up to wide::MAX_HP. Every ladder
// below dispatches on it.
constexpr int WIDE_ABOVE = 64;

// C entry: 1 when p4t_corner_hop_bwd launches the wide instance for these
// widths, 0 when a row-tile one does, -1 when no instance takes them.
extern "C" int p4t_corner_hop_bwd_wide(int h) {
  return h > wide::MAX_HP ? -1 : h > WIDE_ABOVE ? 1 : 0;
}

// C entry: the number of blocks p4t_corner_hop_bwd launches for these
// sizes (its partial buffer holds that many (ff*h + 5h*h + 8h)-float
// partials, and the scratch p4t_corner_hop_bwd_scratch gives). h <= 512,
// ff <= 32. Returns a cudaError_t.
extern "C" int p4t_corner_hop_bwd_grid(int B, int H, int W, int h, int ff, int* blocks) {
  if (ff > MAX_FF || (long long)B * H * W >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (h <= 32) return grid<32>(B, H * W, blocks);
  if (h <= WIDE_ABOVE) return grid<WIDE_ABOVE>(B, H * W, blocks);
  if (h <= 128) return grid_wide<128>(B, H * W, blocks);
  if (h <= 256) return grid_wide<256>(B, H * W, blocks);
  if (h <= wide::MAX_HP) return grid_wide<wide::MAX_HP>(B, H * W, blocks);
  return (int)cudaErrorInvalidValue;
}

// C entry: *floats = what `partial` holds beyond the blocks' partials for
// these sizes: 0 up to WIDE_ABOVE; above it the wide instance's scratch
// rows (13 x B H W h floats) and 4 floats of alignment.
extern "C" int p4t_corner_hop_bwd_scratch(int B, int H, int W, int h, long long* floats) {
  *floats = h <= WIDE_ABOVE ? 0 : 4 + (long long)SCRATCH_ARRAYS * B * H * W * h;
  return h <= wide::MAX_HP ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// C entry: out[10] = for the node pass, then the corner pass, that
// p4t_corner_hop_bwd launches for width h (the wide instance above WIDE_ABOVE):
// registers a thread, local (spill) bytes a thread, dynamic shared
// memory bytes, resident blocks an SM and cells a tile.
extern "C" int p4t_corner_hop_bwd_attributes(int h, int* out) {
  if (h <= 32) return attributes<32>(out);
  if (h <= WIDE_ABOVE) return attributes<WIDE_ABOVE>(out);
  if (h <= 128) return attributes_wide<128>(out);
  if (h <= 256) return attributes_wide<256>(out);
  if (h <= wide::MAX_HP) return attributes_wide<wide::MAX_HP>(out);
  return (int)cudaErrorInvalidValue;
}

// C entry: the corner hop's backward on `stream` for the cotangent g
// (B, H, W, h) of v_out. Inputs as the forward's (psg_k, vd: (B, H, W, h);
// feats: (4, H, W, ff); wf: (ff, h); wd, wo, nd0a, nd0b, nd1: (h, h);
// the vectors (h,)). Writes dpsg0..3 and dvd (B, H, W, h), and
// dw = [dWf | dbf | dWd | dWo | dbo | dlns | dlnb | dNd0a | dNd0b | dnb0 |
// dNd1 | dnb1 | dnlns | dnlnb] through `partial` (blocks x that size,
// blocks from p4t_corner_hop_bwd_grid, then p4t_corner_hop_bwd_scratch's
// floats). dagg is (B, H, W, h) scratch between the two passes. nlnb
// takes no part in the gradients. All fp32, contiguous, on the current
// device; h <= 512 (above WIDE_ABOVE the wide instance) and ff <= 32 (the caller
// checks). Returns the cudaError_t of the launches.
extern "C" int p4t_corner_hop_bwd(const float* psg0, const float* psg1, const float* psg2,
                                  const float* psg3, const float* vd, const float* feats,
                                  const float* wf, const float* bf, const float* wd,
                                  const float* wo, const float* bo, const float* lns,
                                  const float* lnb, const float* nd0a, const float* nd0b,
                                  const float* nb0, const float* nd1, const float* nb1,
                                  const float* nlns, const float* nlnb, const float* g,
                                  float* dpsg0, float* dpsg1, float* dpsg2, float* dpsg3,
                                  float* dvd, float* dagg, float* partial, float* dw, int B,
                                  int H, int W, int h, int ff, int mean, int blocks,
                                  void* stream) {
  (void)nlnb;
  if (ff > MAX_FF || (long long)B * H * W >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bool vec = h % 4 == 0 && aligned16(psg0) && aligned16(psg1) && aligned16(psg2) &&
                   aligned16(psg3) && aligned16(vd) && aligned16(g) && aligned16(dpsg0) &&
                   aligned16(dpsg1) && aligned16(dpsg2) && aligned16(dpsg3) && aligned16(dvd) &&
                   aligned16(dagg);
  Args a{psg0, psg1, psg2, psg3, vd, feats, g, wf, bf, wd, wo, bo, lns, lnb, nd0a, nd0b, nb0,
         nd1, nb1, nlns, dpsg0, dpsg1, dpsg2, dpsg3, dvd, dagg, partial, B, H * W, h, ff,
         mean, vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 32) return launch<32>(a, dw, blocks, s);
  if (h <= WIDE_ABOVE) return launch<WIDE_ABOVE>(a, dw, blocks, s);
  // the wide instance streams the weights by 16-byte copies when aligned
  const int wvec = vec && aligned16(wd) && aligned16(wo) && aligned16(nd0a) &&
                   aligned16(nd0b) && aligned16(nd1) ? 1 : 0;
  if (h <= 128) return launch_wide<128>(a, dw, blocks, wvec, s);
  if (h <= 256) return launch_wide<256>(a, dw, blocks, wvec, s);
  if (h <= wide::MAX_HP) return launch_wide<wide::MAX_HP>(a, dw, blocks, wvec, s);
  return (int)cudaErrorInvalidValue;
}
