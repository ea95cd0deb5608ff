// GRU cell, forward and backward, float32 in and out.
//
// Replaces the TPU kernels `_gru_kernel` (entry `fused_gru_fwd`) and
// `_gru_bwd_kernel` (entry `fused_gru_bwd`) of
// src/repro/kernels/fused_gru.py.
//
//   gx = x wx + bx,  gh = h wh + bh,  gates [r | z | n] in thirds of 3 d_h
//   r = sigmoid(gx_r + gh_r),  z = sigmoid(gx_z + gh_z)
//   n = tanh(gx_n + r gh_n),   h' = (1 - z) n + z h
//
// Layout as the JAX package's, row-major: x (B, d_in), h (B, d_h),
// wx (d_in, 3 d_h), wh (d_h, 3 d_h), bx, bh (3 d_h,). Any B, d_in, d_h:
// rows past B and columns past d_h are zero-filled in shared memory and
// never written; rows whose stride is not a multiple of 16 bytes (odd
// d_in or d_h) are staged one float a copy instead of 16 bytes.
//
// Route: every product runs on the tensor cores as 3xTF32 (gru_tile.cuh):
// each operand split once into tf32 hi and lo parts, three mma.sync
// m16n8k8 per product, float32 accumulation; within ~2^-20 of float32,
// where one tf32 pass is ~2^-11. Bound on an H100 at TGN's updater shape
// (B 400, d_in 616, d_h 172): the forward is 3 x 325 MFLOP at 495 TFLOP/s
// of dense TF32 = 1.97 us against 3.2 MB of operands (0.95 us at 3.35
// TB/s): operations; the backward 3 x 977 MFLOP = 5.92 us. (At float32's
// 67 TFLOP/s without the tensor cores: 4.86 and 14.58 us.)
//
// Forward (`gru::gate_kernel`, one launch): a tile of 32 rows x 32 hidden
// columns x the three gates; a cluster of two blocks splits the 788-deep
// [x | h] [wx; wh] contraction at TGN's shape, and block 1 hands its
// partial sums to block 0 through distributed shared memory, added in rank
// order. What it does about the causes of the first version's time:
//   * too few blocks (78 on 132 SMs): 2 x 13 x 6 = 156 blocks;
//   * each slice copied, waited on, then used, 26 in series: a ring of
//     three cp.async stages keeps two slices in flight while one is
//     multiplied, and each block walks 13 slices, not 26;
//   * the transposed staging store hit 8 banks: x, h and the weights are
//     staged as they lie in memory, rows padded so that a warp's fragment
//     reads hit 32 banks;
//   * float32 FMAs only: 3xTF32 on the tensor cores at float32 parity,
//     split on the bits (cvt.rna.tf32 cost ~20% more at TGN's shape).
// The epilogue's operands are read before the mainloop and the gates
// never leave registers: one write of h'. One tiling serves every batch:
// a batch within one row tile gets 12 blocks at d_h 172 and is
// latency-bound.
//
// Backward, two launches, no atomics, every sum in a fixed order
// (bitwise deterministic):
//   1. `gru::gate_kernel<BWD>`: the forward's tiles recompute the gates
//      and write the pre-activation grads dgx, dgh (B, 3 d_h) to a
//      workspace, and dh = g z;
//   2. `grad_products_kernel`: one grouped launch over a flat list of 64 x
//      64 output tiles of four products, each owned by one block that sums
//      over its depth in order: dx = dgx wx^T, dh += dgh wh^T, [dwx; dbx]
//      = [x | 1]^T dgx, [dwh; dbh] = [h | 1]^T dgh (a row of ones under
//      x^T gives the bias grads, the column sums of dgx). 208 tiles at
//      TGN's shape, none idle.
#include "common.cuh"
#include "gru_tile.cuh"

namespace {

using gru::BK;
using gru::STAGES;
using gru::THREADS;

constexpr int GM = 64, GN = 64;  // output tile of the grad products

// C (m, n) (+)= A (m, k) B (k, n). Weight-grad products (`wgrad`) read A
// as the (k, m) row-major matrix it is the transpose of and B as (k, n);
// the others read A as (m, k) and B as the (n, k) matrix it is the
// transpose of. With `bias`, A has a row m of ones whose product row goes
// to bias[0, n).
struct Product {
  const float* a;
  const float* b;
  float* c;
  float* bias;
  int lda, ldb, ldc, m, n, k, accumulate;
};

struct Grouped {
  Product p[4];   // dx, dh, dwx, dwh
  int first[5];   // first[i]: index of product i's first tile; first[4]: all
};

template <bool WGRAD>
struct ProductTile {
  // [k][m] / [k][n] rows padded by 8, [m][k] / [n][k] rows by 4: a warp's
  // fragment reads hit 32 banks either way
  static constexpr int AS = WGRAD ? GM + 8 : BK + 4;
  static constexpr int BS = WGRAD ? GN + 8 : BK + 4;
  static constexpr int A_FLOATS = WGRAD ? BK * AS : GM * AS;
  static constexpr int STAGE = A_FLOATS + (WGRAD ? BK * BS : GN * BS);
};
static_assert(ProductTile<true>::STAGE == ProductTile<false>::STAGE, "");
constexpr size_t PRODUCT_SMEM =
    STAGES * ProductTile<true>::STAGE * sizeof(float);

// One 64 x 64 tile of C; four warps of 32 x 32 (2 m16 x 4 n8 each).
template <bool WGRAD, bool VEC>
__device__ __forceinline__ void product_tile(const Product& p, int tile,
                                             float* smem) {
  using T = ProductTile<WGRAD>;
  const int tiles_n = (p.n + GN - 1) / GN;
  const int m0 = (tile / tiles_n) * GM, n0 = (tile % tiles_n) * GN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = warp & 1, wn = warp >> 1;
  // local row of A's row of ones in this tile, -1 if none
  const int ones =
      (p.bias != nullptr && p.m >= m0 && p.m < m0 + GM) ? p.m - m0 : -1;
  float acc[2][4][4] = {};

  auto load = [&](int slice, int stage) {
    float* as = smem + stage * T::STAGE;
    float* bs = as + T::A_FLOATS;
    const int k0 = slice * BK;
    if constexpr (WGRAD) {
      gru::load_tile<BK, GM, T::AS, VEC>(as, p.a, p.lda, k0, m0, p.k, p.m);
      gru::load_tile<BK, GN, T::BS, VEC>(bs, p.b, p.ldb, k0, n0, p.k, p.n);
    } else {
      gru::load_tile<GM, BK, T::AS, VEC>(as, p.a, p.lda, m0, k0, p.m, p.k);
      gru::load_tile<GN, BK, T::BS, VEC>(bs, p.b, p.ldb, n0, k0, p.n, p.k);
    }
  };

  auto compute = [&](int slice, int stage) {
    const float* as = smem + stage * T::STAGE;
    const float* bs = as + T::A_FLOATS;
    float part[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      gru::Tf32x3::A a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm * 32 + i * 16 + gq;
        float v[4];
        if constexpr (WGRAD) {
          const float* ap = as + (kk + tq) * T::AS + m;
          v[0] = ap[0];
          v[1] = ap[8];
          v[2] = ap[4 * T::AS];
          v[3] = ap[4 * T::AS + 8];
          if (ones >= 0) {
            const int kg = slice * BK + kk + tq;
            if (m == ones) {
              v[0] = kg < p.k ? 1.0f : 0.0f;
              v[2] = kg + 4 < p.k ? 1.0f : 0.0f;
            }
            if (m + 8 == ones) {
              v[1] = kg < p.k ? 1.0f : 0.0f;
              v[3] = kg + 4 < p.k ? 1.0f : 0.0f;
            }
          }
        } else {
          const float* ap = as + m * T::AS + kk + tq;
          v[0] = ap[0];
          v[1] = ap[8 * T::AS];
          v[2] = ap[4];
          v[3] = ap[8 * T::AS + 4];
        }
        a[i] = gru::Tf32x3::split_a(v);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + gq;
        const float b0 = WGRAD ? bs[(kk + tq) * T::BS + n]
                               : bs[n * T::BS + kk + tq];
        const float b1 = WGRAD ? bs[(kk + tq + 4) * T::BS + n]
                               : bs[n * T::BS + kk + tq + 4];
        const gru::Tf32x3::B b = gru::Tf32x3::split_b(b0, b1);
#pragma unroll
        for (int i = 0; i < 2; ++i) gru::Tf32x3::mma(part[i][j], a[i], b);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  };

  gru::pipelined((p.k + BK - 1) / BK, load, compute);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 32 + i * 16 + gq + (e >> 1) * 8;
        const int c = n0 + wn * 32 + j * 8 + 2 * tq + (e & 1);
        if (c >= p.n) continue;
        if (r < p.m) {
          float* dst = p.c + static_cast<size_t>(r) * p.ldc + c;
          *dst = p.accumulate ? *dst + acc[i][j][e] : acc[i][j][e];
        } else if (r == p.m && p.bias != nullptr) {
          p.bias[c] = acc[i][j][e];
        }
      }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
grad_products_kernel(const Grouped g) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  int i = 0;
  while (i < 3 && t >= g.first[i + 1]) ++i;
  const Product p = g.p[i];
  if (i < 2)
    product_tile<false, VEC>(p, t - g.first[i], smem);
  else
    product_tile<true, VEC>(p, t - g.first[i], smem);
}

}  // namespace

// x (rows, din), h (rows, dh), wx (din, 3 dh), wh (dh, 3 dh), bx, bh
// (3 dh,), out (rows, dh); float32, contiguous.
extern "C" int fused_gru_fwd(const void* x, const void* h, const void* wx,
                             const void* wh, const void* bx, const void* bh,
                             int rows, int din, int dh, void* out,
                             void* stream) {
  if (rows == 0 || dh == 0) return 0;
  const gru::GateArgs p{
      static_cast<const float*>(x),  static_cast<const float*>(h),
      static_cast<const float*>(wx), static_cast<const float*>(wh),
      static_cast<const float*>(bx), static_cast<const float*>(bh),
      nullptr, rows, din, dh, static_cast<float*>(out), nullptr, nullptr};
  return gru::launch_gates<false>(p, static_cast<cudaStream_t>(stream));
}

// As fused_gru_fwd, plus the cotangent g (rows, dh) and two (rows, 3 dh)
// float32 workspaces; writes dx (rows, din), dh_out (rows, dh), dwx, dwh,
// dbx, dbh (the shapes of wx, wh, bx, bh).
extern "C" int fused_gru_bwd(const void* g, const void* x, const void* h,
                             const void* wx, const void* wh, const void* bx,
                             const void* bh, int rows, int din, int dh,
                             void* dgx, void* dgh, void* dx, void* dh_out,
                             void* dwx, void* dwh, void* dbx, void* dbh,
                             void* stream) {
  if (dh == 0) return 0;
  const gru::GateArgs p{
      static_cast<const float*>(x),  static_cast<const float*>(h),
      static_cast<const float*>(wx), static_cast<const float*>(wh),
      static_cast<const float*>(bx), static_cast<const float*>(bh),
      static_cast<const float*>(g),  rows, din, dh,
      static_cast<float*>(dh_out),   static_cast<float*>(dgx),
      static_cast<float*>(dgh)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    const int err = gru::launch_gates<true>(p, st);
    if (err) return err;
  }
  // with rows == 0 the weight and bias grads are the zeros of empty sums
  const int d3 = 3 * dh;
  Grouped gp{{
      {p.dgx, p.wx, static_cast<float*>(dx), nullptr, d3, d3, din, rows,
       din, d3, 0},
      {p.dgh, p.wh, p.out, nullptr, d3, d3, dh, rows, dh, d3, 1},
      {p.x, p.dgx, static_cast<float*>(dwx), static_cast<float*>(dbx), din,
       d3, d3, din, d3, rows, 0},
      {p.h, p.dgh, static_cast<float*>(dwh), static_cast<float*>(dbh), dh,
       d3, d3, dh, d3, rows, 0}}, {}};
  gp.first[0] = 0;
  for (int i = 0; i < 4; ++i) {
    const Product& q = gp.p[i];
    const int mt = q.m + (q.bias != nullptr);
    gp.first[i + 1] =
        gp.first[i] + ((mt + GM - 1) / GM) * ((q.n + GN - 1) / GN);
  }
  if (gp.first[4] == 0) return 0;
  // the workspaces dgx, dgh are read as the forward's operands are
  const bool vec = gru::vec_ok(p) && gru::aligned16(p.dgx) &&
                   gru::aligned16(p.dgh);
  const dim3 grid(gp.first[4]);
  return static_cast<int>(
      vec ? gru::launch<grad_products_kernel<true>, PRODUCT_SMEM>(grid, 1,
                                                                  st, gp)
          : gru::launch<grad_products_kernel<false>, PRODUCT_SMEM>(grid, 1,
                                                                   st, gp));
}

