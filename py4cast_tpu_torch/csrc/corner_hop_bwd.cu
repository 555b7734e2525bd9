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
// and tiles alone would take ~300 KB: the wrapper raises above 64
// (ops/hop_kernel.py::MAX_BWD_WIDTH).

#include <cstdint>

#include "corner_hop_tiles.cuh"

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

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

}  // namespace

// C entry: the number of blocks p4t_corner_hop_bwd launches for these
// sizes (its partial buffer holds that many (ff*h + 5h*h + 8h)-float
// partials). h <= 64, ff <= 32. Returns a cudaError_t.
extern "C" int p4t_corner_hop_bwd_grid(int B, int H, int W, int h, int ff, int* blocks) {
  if (ff > MAX_FF || (long long)B * H * W >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (h <= 32) return grid<32>(B, H * W, blocks);
  if (h <= 64) return grid<64>(B, H * W, blocks);
  return (int)cudaErrorInvalidValue;
}

// C entry: out[10] = for the node pass, then the corner pass, that
// p4t_corner_hop_bwd launches for width h: registers a thread, local
// (spill) bytes a thread, dynamic shared memory bytes, resident blocks
// an SM and cells a tile.
extern "C" int p4t_corner_hop_bwd_attributes(int h, int* out) {
  if (h <= 32) return attributes<32>(out);
  if (h <= 64) return attributes<64>(out);
  return (int)cudaErrorInvalidValue;
}

// C entry: the corner hop's backward on `stream` for the cotangent g
// (B, H, W, h) of v_out. Inputs as the forward's (psg_k, vd: (B, H, W, h);
// feats: (4, H, W, ff); wf: (ff, h); wd, wo, nd0a, nd0b, nd1: (h, h);
// the vectors (h,)). Writes dpsg0..3 and dvd (B, H, W, h), and
// dw = [dWf | dbf | dWd | dWo | dbo | dlns | dlnb | dNd0a | dNd0b | dnb0 |
// dNd1 | dnb1 | dnlns | dnlnb] through `partial` (blocks x that size,
// blocks from p4t_corner_hop_bwd_grid). dagg is (B, H, W, h) scratch
// between the two passes. nlnb takes no part in the gradients. All
// fp32, contiguous, on the current device; h <= 64 and ff <= 32 (the
// caller checks). Returns the cudaError_t of the launches.
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
  if (h <= 64) return launch<64>(a, dw, blocks, s);
  return (int)cudaErrorInvalidValue;
}
