// RWKV6 (Finch) WKV recurrence, backward: the gradients of r, k, v, w, u
// and of the initial state, given the output's cotangent and the final
// state's.
//
// Replaces no TPU kernel: the JAX package differentiates its XLA path
// (`rwkv6_chunked_xla`, src/repro/kernels/ref.py:190, through
// src/repro/kernels/ops.py:312-321), and its Pallas kernel has no VJP.
// Per (batch b, head h), with Dk = Dv = 64, the forward is
//
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//
// and with G_t = dL/dS_t (G_{S-1} the final state's cotangent, or 0) the
// backward is
//
//   dr_t = S_{t-1} do_t + u k_t (v_t . do_t)
//   dk_t = G_t v_t + u r_t (v_t . do_t)
//   dv_t = G_t^T k_t + (r_t . (u k_t)) do_t
//   dw_t = rowsum(G_t * S_{t-1})
//   du   = sum over (b, t) of r_t k_t (v_t . do_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T,  d(initial state) = G_{-1}.
//
// `ref.rwkv6_bwd_ref` is the plain version; `ref.rwkv6_bwd_chunked_ref`
// is this kernel's algebra. It is the chunked forward's
// (csrc/rwkv6_scan.cu) carried into the backward: chunks of C = 64
// tokens cut into sub-chunks of 8, every decay a product of w (each
// factor at most 1, so any w in (0, 1] is in range and nothing
// overflows), the products on wgmma at float32 precision with each
// float32 operand split on its bits into three bf16 parts (hi + mid +
// lo; the terms down to 2^-16 of hi hi). With Q'_t, K'_t the products of
// w in a sub-chunk before and after token t, omega a sub-chunk's whole
// product, rho_a / kappa_a those of the sub-chunks before / after a,
// g(a, b) those strictly between b < a, Rq = Q' r and Kc = K' k, four
// launches:
//   1. `sum` (a block a (b, h, chunk)): the chunk's summaries, U = (Kc
//      kappa)^T V and Y = (Rq rho)^T dO (one warpgroup each), and its
//      decay dec.
//   2. `edges` (a thread a state element): a scan over the chunks, S_0 <-
//      dec S_0 + U and G_C <- dec G_C + Y, in place: the state before
//      each chunk and the cotangent after it; the last G_C is the initial
//      state's gradient. Elementwise, 2 x 64 steps at the training call.
//   3. `grad` (a block a (b, h, chunk), two warpgroups, four sub-chunks
//      each): at sub-chunk a, the state at its start and the cotangent at
//      its end as products, S_a = rho_a S_0 + sum_{b<a} (g(a, b) Kc_b)^T
//      V_b and G_a = kappa_a G_C + sum_{e>a} (g(e, a) Rq_e)^T dO_e
//      (m64n64k16, A from registers, B the staged V / dO tiles); then
//      S_a dO_a^T (m64n8k16, A from registers), G_a V_a^T and G_a^T Kc_a
//      (G_a's parts staged, read as A, the second transposed), and X_a =
//      rowsum(G_a * S_a); then per element, over the sub-chunk's 8
//      tokens (W(i, j) the product of w strictly between j and i, dA(i,
//      j) = do_i . v_j):
//        dr_t = Q'_t (S_a do_t) + sum_{j<t} W(t, j) k_j dA(t, j) + u k_t dA
//        dk_t = K'_t (G_a v_t) + sum_{i>t} W(i, t) r_i dA(i, t) + u r_t dA
//        dv_t = G_a^T Kc_t + sum_{i>=t} A(i, t) do_i
//        dw_t = K'_t Q'_t X_a + K'_t sum_{j<t} W(t, j) k_j (G_a v_j)
//               + Q'_t sum_{i>t} W(i, t) r_i (S_a do_i)
//               + sum_{j<t<i} W(i, t) W(t, j) r_i k_j dA(i, j),
//      dw expanded about the sub-chunk's edges from rowsum(G_t * S_{t-1})
//      (no reverse sum of r dr - k dk, no division by w); u's partial
//      a chunk.
//   4. `du`: u's gradient, summed over the (b, chunk) partials in order.
// Sums in a fixed order, no atomics: two calls give the same bits.
//
// Bound on an H100 at RWKV6-1.6B's training call (B 1, S 4096, H 32, bf16
// r, k, v, dr, dk, dv; float32 w, do, dw): the bytes (inputs read once,
// outputs written once) 201 MB, ~60 us at 3.35 TB/s. The function's
// operations in the chunked form take ~41 us even as six bf16 passes a
// float32 product, so the bytes bound it; chip_smoke.py's `wkv_bwd_bound`
// computes the bound from each call's shape. This design reads the
// inputs twice (launches 1 and 3) and writes and reads the chunk edges
// (2 x 33.5 MB, twice in launch 2), ~0.6 GB in all.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 64;          // head dim (Dk = Dv)
constexpr int C = 64;          // tokens a chunk
constexpr int SUB = 8;         // tokens a sub-chunk
constexpr int NS = C / SUB;    // sub-chunks a chunk
constexpr int THREADS = 256;   // two warpgroups
constexpr int LA = D + 4;      // row stride of the float32 [token][channel]
                               // tiles: the A fragments' reads hit 32 banks
constexpr int TILE = C * D * 2;              // one bf16 [64][64] tile
constexpr int NPAIR = SUB * (SUB - 1) / 2;   // pairs j < i in a sub-chunk
constexpr int ITEMS = NPAIR + SUB;           // and the diagonal
constexpr int NG = NS * (NS - 1) / 2;        // pairs of sub-chunks b < a
constexpr unsigned FULL = 0xffffffffu;
static_assert(C == 64 && SUB == 8 && D == 64, "the tiles assume these");

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// item of pair (i, j), j < i, of a sub-chunk; the diagonal after the pairs
__device__ __forceinline__ int item(int i, int j) {
  return i == j ? NPAIR + j : i * (i - 1) / 2 + j;
}
// g(a, b), b < a, in the table of sub-chunk pairs
__device__ __forceinline__ int gpair(int a, int b) {
  return a * (a - 1) / 2 + b;
}
__device__ __forceinline__ float bf(const unsigned char* tile, int off) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + off));
}
// element (row, col) of a float32 value staged as NP bf16 parts
template <int NP>
__device__ __forceinline__ float parts(const unsigned char* t, int row,
                                       int col) {
  const int o = sw128(row, col);
  if constexpr (NP == 1) {
    return bf(t, o);
  } else {
    return (bf(t, o) + bf(t + TILE, o)) + bf(t + 2 * TILE, o);
  }
}
// wgmma descriptors of a [64][64] swizzled bf16 tile at addr: MN-major,
// rows [16 kk, 16 kk + 16) along K; K-major, 8 rows from `row` along N,
// columns [16 kk, 16 kk + 16) along K
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, int kk) {
  return gmma_desc(addr + kk * 16 * 128, C * 128, 8 * 128, 1);
}
__device__ __forceinline__ uint64_t k_desc(uint32_t addr, int row, int kk) {
  return gmma_desc(addr + row * 128 + kk * 32, 16, 8 * 128, 1);
}

// x (64 x 64 float32 values, as `xval(kk, v)` gives the A fragment v[8]
// of the 16-column step kk) times the NB-part tile at b read MN-major,
// added into acc, for the steps [k0, k1): per step the terms down to
// 2^-16 of hi hi (lo hi, mid hi, then with NB = 3 hi lo, mid mid, hi mid),
// hi hi last. Issued, not waited for.
template <int NB, class XVal>
__device__ __forceinline__ void product(float (&acc)[32], uint32_t b, int k0,
                                        int k1, XVal xval) {
  for (int kk = k0; kk < k1; ++kk) {
    float v[8];
    xval(kk, v);
    uint32_t a[3][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t p[3];
      split3_bf16(v[2 * r], v[2 * r + 1], p);
      a[0][r] = p[0];
      a[1][r] = p[1];
      a[2][r] = p[2];
    }
    wgmma_rs(acc, a[2], mn_desc(b, kk));
    wgmma_rs(acc, a[1], mn_desc(b, kk));
    if constexpr (NB == 3) {
      wgmma_rs(acc, a[0], mn_desc(b + 2 * TILE, kk));
      wgmma_rs(acc, a[1], mn_desc(b + TILE, kk));
      wgmma_rs(acc, a[0], mn_desc(b + TILE, kk));
    }
    wgmma_rs(acc, a[0], mn_desc(b, kk));
  }
}

// out (64 x 8) = the accumulator m (64 x 64) times the 8 rows from `row`
// of the NB-part tile at b read K-major: m^T's rows contracted with those
// rows' columns. Issued, not waited for.
template <int NB>
__device__ __forceinline__ void product8(float (&out)[4],
                                         const float (&m)[32], uint32_t b,
                                         int row) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[3][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t p[3];
      split3_bf16(m[8 * kk + 2 * r], m[8 * kk + 2 * r + 1], p);
      a[0][r] = p[0];
      a[1][r] = p[1];
      a[2][r] = p[2];
    }
    wgmma_rs8<0>(out, a[2], k_desc(b, row, kk));
    wgmma_rs8<0>(out, a[1], k_desc(b, row, kk));
    if constexpr (NB == 3) {
      wgmma_rs8<0>(out, a[0], k_desc(b + 2 * TILE, row, kk));
      wgmma_rs8<0>(out, a[1], k_desc(b + TILE, row, kk));
      wgmma_rs8<0>(out, a[0], k_desc(b + TILE, row, kk));
    }
    wgmma_rs8<0>(out, a[0], k_desc(b, row, kk));
  }
}

// The chunk's V into NV bf16 parts and dO into three, [token][column]
// tiles (rows past the sequence zero): 256 threads, every load issued
// before the first store. Returns whether one of this thread's dO values
// has a mid or lo part (a dO of bf16 values has none: the products with
// those parts are then exactly zero and are left out).
template <typename TI>
__device__ __forceinline__ bool put_tiles(unsigned char* vt, unsigned char* ot,
                                          const TI* __restrict__ v,
                                          const float* __restrict__ dout,
                                          size_t base, size_t tstride,
                                          int n) {
  constexpr int PER = C * D / 2 / THREADS;   // column pairs a thread
  float2 o[PER], x[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int t = e / (D / 2), c = (e % (D / 2)) * 2;
    const size_t g = base + t * tstride + c;
    o[q] = t < n ? ld2(dout + g) : make_float2(0.0f, 0.0f);
    x[q] = t < n ? ld2(v + g) : make_float2(0.0f, 0.0f);
  }
  uint32_t rest = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int t = e / (D / 2), c = (e % (D / 2)) * 2;
    uint32_t p[3];
    split3_bf16(o[q].x, o[q].y, p);
    rest |= p[1] | p[2];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      *reinterpret_cast<uint32_t*>(ot + m * TILE + sw128(t, c)) = p[m];
    if constexpr (sizeof(TI) == 2) {
      // a bf16 v is its own part (exact through float32)
      *reinterpret_cast<uint32_t*>(vt + sw128(t, c)) =
          pack_bf16(x[q].x, x[q].y);
    } else {
      split3_bf16(x[q].x, x[q].y, p);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        *reinterpret_cast<uint32_t*>(vt + m * TILE + sw128(t, c)) = p[m];
    }
  }
  return rest != 0;
}

// Butterfly step of a reduce-scatter across the lanes: lanes that differ
// in bit m swap halves of x[0, N) and add, the lane with the bit set
// keeping the upper half; x[0, N / 2) holds the result.
template <int N>
__device__ __forceinline__ void halve(float* x, int m) {
  const bool up = (threadIdx.x & m) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = up ? x[N / 2 + i] : x[i];
    const float send = up ? x[i] : x[N / 2 + i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// The fragment-order slot of accumulator element e of warpgroup thread
// `thread` (= 32 ww + lane) in a 64 x 64 float32 edge state, and the
// (row, column) of that element
__device__ __forceinline__ int frag(int thread, int e) {
  return thread * 32 + e;
}
__device__ __forceinline__ int frag_row(int f) {
  return 16 * (f / 1024) + (f / 32 % 32) / 4 + 8 * ((f >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int f) {
  return 8 * ((f % 32) >> 2) + 2 * (f / 32 % 4) + (f & 1);
}

// Warp s, lane l: sub-chunk s, channels 2 l and 2 l + 1. The products of
// w in the sub-chunk before (qp) and after (kp) each token, and the whole
// (returned); past the sequence w is taken as 1.
__device__ __forceinline__ float2 decays(const float2 (&wv)[SUB],
                                         float2 (&qp)[SUB],
                                         float2 (&kp)[SUB]) {
  float2 p = make_float2(1.0f, 1.0f);
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    qp[i] = p;
    p.x *= wv[i].x;
    p.y *= wv[i].y;
  }
  const float2 om = p;
  p = make_float2(1.0f, 1.0f);
#pragma unroll
  for (int i = SUB - 1; i >= 0; --i) {
    kp[i] = p;
    p.x *= wv[i].x;
    p.y *= wv[i].y;
  }
  return om;
}

// --------------------------------------------------- 1. chunk summaries

namespace sum {

template <typename TI>
struct Smem {
  static constexpr int NV = sizeof(TI) == 2 ? 1 : 3;
  static constexpr int V = 0;                        // [NV] v [t][c]
  static constexpr int O = V + NV * TILE;            // [3] do [t][c]
  static constexpr int KK = O + 3 * TILE;            // [C][LA] Kc
  static constexpr int RR = KK + C * LA * 4;         // [C][LA] Rq
  static constexpr int OM = RR + C * LA * 4;         // [NS][D] omega
  static constexpr int RHO = OM + NS * D * 4;        // [NS][D] rho
  static constexpr int KAP = RHO + NS * D * 4;       // [NS][D] kappa
  static constexpr int BYTES = 1024 + KAP + NS * D * 4;
};

template <typename TI>
__global__ void __launch_bounds__(THREADS)
wkv_bwd_sum(const TI* __restrict__ r, const TI* __restrict__ k,
            const TI* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ dout, int heads, int seq, int nc,
            float* __restrict__ ub, float* __restrict__ yb,
            float* __restrict__ dec) {
  using L = Smem<TI>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base_a = (raw0 + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base_a - raw0);
  float* kk_s = reinterpret_cast<float*>(sm + L::KK);
  float* rr_s = reinterpret_cast<float*>(sm + L::RR);
  float* om_s = reinterpret_cast<float*>(sm + L::OM);
  float* rho_s = reinterpret_cast<float*>(sm + L::RHO);
  float* kap_s = reinterpret_cast<float*>(sm + L::KAP);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / heads, h = bh % heads;
  const int t0 = ci * C, n = min(C, seq - t0);
  const size_t tstride = static_cast<size_t>(heads) * D;
  const size_t base = (static_cast<size_t>(b) * seq * heads + h) * D +
                      static_cast<size_t>(t0) * tstride;
  const bool rest = put_tiles<TI>(sm + L::V, sm + L::O, v, dout, base,
                                  tstride, n);
  {  // warp s: Rq, Kc and omega of sub-chunk s
    const int s = warp, c = 2 * lane;
    float2 rv[SUB], kv[SUB], wv[SUB], qp[SUB], kp[SUB];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = s * SUB + i;
      const size_t g = base + t * tstride + c;
      const bool in = t < n;
      rv[i] = in ? ld2(r + g) : make_float2(0.0f, 0.0f);
      kv[i] = in ? ld2(k + g) : make_float2(0.0f, 0.0f);
      wv[i] = in ? ld2(w + g) : make_float2(1.0f, 1.0f);
    }
    const float2 om = decays(wv, qp, kp);
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = s * SUB + i;
      *reinterpret_cast<float2*>(rr_s + t * LA + c) =
          make_float2(rv[i].x * qp[i].x, rv[i].y * qp[i].y);
      *reinterpret_cast<float2*>(kk_s + t * LA + c) =
          make_float2(kv[i].x * kp[i].x, kv[i].y * kp[i].y);
    }
    *reinterpret_cast<float2*>(om_s + s * D + c) = om;
  }
  const bool do3 = __syncthreads_or(rest);    // dO beyond its hi parts
  if (tid < D) {   // channel tid: the sub-chunk products before / after
    float p = 1.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      rho_s[s * D + tid] = p;
      p *= om_s[s * D + tid];
    }
    dec[(static_cast<size_t>(bh) * nc + ci) * D + tid] = p;
    p = 1.0f;
#pragma unroll
    for (int s = NS - 1; s >= 0; --s) {
      kap_s[s * D + tid] = p;
      p *= om_s[s * D + tid];
    }
  }
  fence_async_smem();
  __syncthreads();

  // warpgroup 0: U = (Kc kappa)^T V; warpgroup 1: Y = (Rq rho)^T dO; rows
  // d = 16 ww + gq (+ 8), the A fragment's columns tokens
  // the warpgroup, uniform to the compiler (wgmma in its branches)
  const int wg = __shfl_sync(FULL, warp / 4, 0);
  const int ww = warp % 4, gq = lane / 4, tq = lane % 4;
  const int d0 = 16 * ww + gq, d1 = d0 + 8;
  const float* src = wg == 0 ? kk_s : rr_s;
  const float* scale = wg == 0 ? kap_s : rho_s;
  auto xval = [&](int kk, float (&x)[8]) {
    const int t = 16 * kk + 2 * tq;
    const float* sa = scale + (2 * kk) * D;
    const float* sb = scale + (2 * kk + 1) * D;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[e] = src[(t + e) * LA + d0] * sa[d0];
      x[2 + e] = src[(t + e) * LA + d1] * sa[d1];
      x[4 + e] = src[(t + 8 + e) * LA + d0] * sb[d0];
      x[6 + e] = src[(t + 8 + e) * LA + d1] * sb[d1];
    }
  };
  float acc[32] = {};
  wgmma_fence();
  if (wg == 0)
    product<L::NV>(acc, base_a + L::V, 0, 4, xval);
  else if (do3)
    product<3>(acc, base_a + L::O, 0, 4, xval);
  else
    product<1>(acc, base_a + L::O, 0, 4, xval);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  // in fragment order: each thread's 32 values contiguous
  float4* out = reinterpret_cast<float4*>(
      (wg == 0 ? ub : yb) + (static_cast<size_t>(bh) * nc + ci) * D * D +
      frag(tid % 128, 0));
#pragma unroll
  for (int e = 0; e < 32; e += 4)
    out[e / 4] = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
}

}  // namespace sum

// ------------------------------------------------------ 2. chunk edges

namespace edges {

constexpr int EDGE_THREADS = 256;

// blockIdx.y 0: the state before each chunk, forward from s0 over ub in
// place; 1: the cotangent after each chunk, backward from ds_out over yb
// in place, and the initial state's gradient. ub and yb hold each 64 x 64
// state in fragment order (`frag`), s0, ds_out and ds0 row by row.
__global__ void __launch_bounds__(EDGE_THREADS)
wkv_bwd_edges(const float* __restrict__ s0, const float* __restrict__ ds_out,
              const float* __restrict__ dec, int bhs, int nc,
              float* __restrict__ ub, float* __restrict__ yb,
              float* __restrict__ ds0) {
  const int e = blockIdx.x * EDGE_THREADS + threadIdx.x;  // (bh, slot)
  if (e >= bhs * D * D) return;
  const int bh = e / (D * D), ij = e % (D * D);  // ij: fragment order
  const int i = frag_row(ij);
  const size_t nat = static_cast<size_t>(bh) * D * D + i * D + frag_col(ij);
  const bool rev = blockIdx.y == 1;
  const float* init = rev ? ds_out : s0;
  float x = init != nullptr ? init[nat] : 0.0f;
  float* buf = rev ? yb : ub;
  // eight chunks' loads in flight, then their stores
  for (int q0 = 0; q0 < nc; q0 += 8) {
    float p[8], dd[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int q = min(q0 + m, nc - 1);
      const size_t row =
          static_cast<size_t>(bh) * nc + (rev ? nc - 1 - q : q);
      p[m] = buf[row * D * D + ij];
      dd[m] = dec[row * D + i];
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (q0 + m >= nc) break;
      const int q = q0 + m;
      const size_t row =
          static_cast<size_t>(bh) * nc + (rev ? nc - 1 - q : q);
      buf[row * D * D + ij] = x;
      x = fmaf(dd[m], x, p[m]);
    }
  }
  if (rev && ds0 != nullptr) ds0[nat] = x;
}

}  // namespace edges

// ------------------------------------------------------ 3. the gradients

namespace grad {

template <typename TI>
struct Smem {
  static constexpr int NV = sizeof(TI) == 2 ? 1 : 3;
  static constexpr int V = 0;                        // [NV] v [t][c]
  static constexpr int O = V + NV * TILE;            // [3] do [t][c]
  static constexpr int KC = O + 3 * TILE;            // [3] Kc [t][d]
  static constexpr int GP = KC + 3 * TILE;           // [2][3] G_a [d][c]
  static constexpr int RQ = GP + 6 * TILE;           // [C][LA] Rq
  static constexpr int R = RQ + C * LA * 4;          // [C][LA] r
  static constexpr int K = R + C * LA * 4;           // [C][LA] k
  static constexpr int W = K + C * LA * 4;           // [C][LA] w
  static constexpr int OM = W + C * LA * 4;          // [NS][D] omega
  static constexpr int RHO = OM + NS * D * 4;        // [NS][D] rho
  static constexpr int KAP = RHO + NS * D * 4;       // [NS][D] kappa
  static constexpr int G = KAP + NS * D * 4;         // [NG][D] g(a, b)
  static constexpr int DA = G + NG * D * 4;          // [NS][ITEMS] dA
  static constexpr int AW = DA + NS * ITEMS * 4;     // [NS][ITEMS] A
  static constexpr int RES = AW + NS * ITEMS * 4;    // [2][3][SUB][D]
  static constexpr int X = RES + 2 * 3 * SUB * D * 4;  // [2][D]
  static constexpr int DU = X + 2 * D * 4;             // [2][D]
  static constexpr int BYTES = 1024 + DU + 2 * D * 4;
};
static_assert(Smem<float>::BYTES <= 232448, "shared memory");

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <typename TI>
__global__ void __launch_bounds__(THREADS, 1)
wkv_bwd_grad(const TI* __restrict__ r, const TI* __restrict__ k,
             const TI* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ dout,
             const float* __restrict__ sb, const float* __restrict__ gb,
             int heads, int seq, int nc, TI* __restrict__ dr,
             TI* __restrict__ dk, TI* __restrict__ dv,
             float* __restrict__ dw, float* __restrict__ du_part) {
  using L = Smem<TI>;
  constexpr int NV = L::NV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base_a = (raw0 + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base_a - raw0);
  const unsigned char* vt = sm + L::V;
  const unsigned char* ot = sm + L::O;
  unsigned char* kct = sm + L::KC;
  float* rq_s = reinterpret_cast<float*>(sm + L::RQ);
  float* r_s = reinterpret_cast<float*>(sm + L::R);
  float* k_s = reinterpret_cast<float*>(sm + L::K);
  float* w_s = reinterpret_cast<float*>(sm + L::W);
  float* om_s = reinterpret_cast<float*>(sm + L::OM);
  float* rho_s = reinterpret_cast<float*>(sm + L::RHO);
  float* kap_s = reinterpret_cast<float*>(sm + L::KAP);
  float* g_s = reinterpret_cast<float*>(sm + L::G);
  float* da_s = reinterpret_cast<float*>(sm + L::DA);
  float* aw_s = reinterpret_cast<float*>(sm + L::AW);
  float* res_s = reinterpret_cast<float*>(sm + L::RES);
  float* x_s = reinterpret_cast<float*>(sm + L::X);
  float* du_s = reinterpret_cast<float*>(sm + L::DU);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the warpgroup, uniform to the compiler (wgmma in its branches)
  const int wg = __shfl_sync(FULL, warp / 4, 0);
  const int ww = warp % 4, gq = lane / 4, tq = lane % 4;
  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / heads, h = bh % heads;
  const int t0 = ci * C, n = min(C, seq - t0);
  const size_t tstride = static_cast<size_t>(heads) * D;
  const size_t base = (static_cast<size_t>(b) * seq * heads + h) * D +
                      static_cast<size_t>(t0) * tstride;
  const float* uh = u + h * D;

  const bool rest = put_tiles<TI>(sm + L::V, sm + L::O, v, dout, base,
                                  tstride, n);
  // the state before the chunk and the cotangent after it, as wgmma
  // accumulators (rows d = 16 ww + gq (+ 8), columns 8 j + 2 tq (+ 1)),
  // stored in that fragment order
  float s0[32], gc[32];
  {
    const size_t mb = (static_cast<size_t>(bh) * nc + ci) * D * D +
                      frag(tid % 128, 0);
    const float4* a4 = reinterpret_cast<const float4*>(sb + mb);
    const float4* g4 = reinterpret_cast<const float4*>(gb + mb);
#pragma unroll
    for (int e = 0; e < 32; e += 4) {
      const float4 a = a4[e / 4], g = g4[e / 4];
      s0[e] = a.x;
      s0[e + 1] = a.y;
      s0[e + 2] = a.z;
      s0[e + 3] = a.w;
      gc[e] = g.x;
      gc[e + 1] = g.y;
      gc[e + 2] = g.z;
      gc[e + 3] = g.w;
    }
  }
  bool do3;                           // dO beyond its hi parts
  {  // warp s, lane l: sub-chunk s, channels 2 l, 2 l + 1
    const int s = warp, c = 2 * lane;
    float2 rv[SUB], kv[SUB], wv[SUB], qp[SUB], kp[SUB];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = s * SUB + i;
      const size_t g = base + t * tstride + c;
      const bool in = t < n;
      rv[i] = in ? ld2(r + g) : make_float2(0.0f, 0.0f);
      kv[i] = in ? ld2(k + g) : make_float2(0.0f, 0.0f);
      wv[i] = in ? ld2(w + g) : make_float2(1.0f, 1.0f);
      *reinterpret_cast<float2*>(r_s + t * LA + c) = rv[i];
      *reinterpret_cast<float2*>(k_s + t * LA + c) = kv[i];
      *reinterpret_cast<float2*>(w_s + t * LA + c) = wv[i];
    }
    const float2 om = decays(wv, qp, kp);
    *reinterpret_cast<float2*>(om_s + s * D + c) = om;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = s * SUB + i;
      *reinterpret_cast<float2*>(rq_s + t * LA + c) =
          make_float2(rv[i].x * qp[i].x, rv[i].y * qp[i].y);
      uint32_t p[3];
      split3_bf16(kv[i].x * kp[i].x, kv[i].y * kp[i].y, p);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint32_t*>(kct + q * TILE + sw128(t, c)) = p[q];
    }
    // the sub-chunk's weights A (r_i W(i, j) k_j summed over the channels,
    // u on the diagonal) in x[0, 36) and dA(i, j) = do_i . v_j, j <= i, in
    // x[36, 72), summed over the lanes by a reduce-scatter
    const float2 ud = ld2(uh + c);
    float x[2 * ITEMS];
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      x[NPAIR + j] = fmaf(rv[j].x * ud.x, kv[j].x, rv[j].y * ud.y * kv[j].y);
      float2 pc = kv[j];
#pragma unroll
      for (int i = j + 1; i < SUB; ++i) {
        x[i * (i - 1) / 2 + j] = fmaf(rv[i].x, pc.x, rv[i].y * pc.y);
        pc.x *= wv[i].x;
        pc.y *= wv[i].y;
      }
    }
    do3 = __syncthreads_or(rest);       // do and v staged
    float2 ov[SUB], vv[SUB];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const int t = s * SUB + i;
      ov[i] = make_float2(parts<3>(ot, t, c), parts<3>(ot, t, c + 1));
      vv[i] = make_float2(parts<NV>(vt, t, c), parts<NV>(vt, t, c + 1));
    }
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        x[ITEMS + item(i, j)] = fmaf(ov[i].x, vv[j].x, ov[i].y * vv[j].y);
    }
    halve<72>(x, 16);
    halve<36>(x, 8);
    halve<18>(x, 4);
    x[9] = 0.0f;
    halve<10>(x, 2);
    x[5] = 0.0f;
    halve<6>(x, 1);
    // x[f] is the sum of item q: undo the halvings, padding excluded
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int s2 = 3 * (lane & 1) + f;
      if (s2 >= 5) continue;
      const int s1 = 5 * ((lane >> 1) & 1) + s2;
      if (s1 >= 9) continue;
      const int q = 36 * ((lane >> 4) & 1) + 18 * ((lane >> 3) & 1) +
                    9 * ((lane >> 2) & 1) + s1;
      if (q < ITEMS)
        aw_s[s * ITEMS + q] = x[f];
      else
        da_s[s * ITEMS + q - ITEMS] = x[f];
    }
  }
  __syncthreads();
  if (tid < D) {   // channel tid: the products of whole sub-chunks
    float om[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) om[s] = om_s[s * D + tid];
    float p = 1.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      rho_s[s * D + tid] = p;
      p *= om[s];
    }
    p = 1.0f;
#pragma unroll
    for (int s = NS - 1; s >= 0; --s) {
      kap_s[s * D + tid] = p;
      p *= om[s];
    }
#pragma unroll
    for (int kb = 0; kb < NS - 1; ++kb) {
      float pg = 1.0f;
#pragma unroll
      for (int qa = kb + 1; qa < NS; ++qa) {
        g_s[gpair(qa, kb) * D + tid] = pg;
        pg *= om[qa];
      }
    }
  }
  fence_async_smem();
  __syncthreads();

  const int d0 = 16 * ww + gq, d1 = d0 + 8;
  const uint32_t gpa = base_a + L::GP + wg * 3 * TILE;
  unsigned char* gpt = sm + L::GP + wg * 3 * TILE;
  float* res = res_s + wg * 3 * SUB * D;
  const int wt = tid % 128;            // the thread in its warpgroup
  float du_acc = 0.0f;
  for (int a = wg; a < NS; a += 2) {
    // S_a = rho_a S_0 + sum_{b<a} (g(a, b) Kc_b)^T V_b; G_a = kappa_a G_C
    // + sum_{e>a} (g(e, a) Rq_e)^T dO_e
    float sa[32], ga[32];
    {
      const float r0 = rho_s[a * D + d0], r1 = rho_s[a * D + d1];
      const float k0 = kap_s[a * D + d0], k1 = kap_s[a * D + d1];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const bool hi = (e >> 1) & 1;
        sa[e] = (hi ? r1 : r0) * s0[e];
        ga[e] = (hi ? k1 : k0) * gc[e];
      }
    }
    wgmma_fence();
    product<NV>(sa, base_a + L::V, 0, (a + 1) / 2,
                [&](int kk, float (&x)[8]) {
      const int t = 16 * kk + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t + (e & 1) + 8 * (e >> 1);
        const bool in = tt < SUB * a;
        const float* gp = g_s + gpair(a, in ? tt / SUB : 0) * D;
        x[4 * (e >> 1) + (e & 1)] =
            in ? gp[d0] * parts<3>(kct, tt, d0) : 0.0f;
        x[4 * (e >> 1) + (e & 1) + 2] =
            in ? gp[d1] * parts<3>(kct, tt, d1) : 0.0f;
      }
    });
    const auto gval = [&](int kk, float (&x)[8]) {
      const int t = 16 * kk + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = t + (e & 1) + 8 * (e >> 1);
        const bool in = tt >= SUB * (a + 1);
        const float* gp = g_s + gpair(in ? tt / SUB : 1, in ? a : 0) * D;
        x[4 * (e >> 1) + (e & 1)] = in ? gp[d0] * rq_s[tt * LA + d0] : 0.0f;
        x[4 * (e >> 1) + (e & 1) + 2] =
            in ? gp[d1] * rq_s[tt * LA + d1] : 0.0f;
      }
    };
    if (do3)
      product<3>(ga, base_a + L::O, (a + 1) / 2, 4, gval);
    else
      product<1>(ga, base_a + L::O, (a + 1) / 2, 4, gval);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(ga);

    // X_a = rowsum(G_a * S_a); G_a's parts staged for G_a^T Kc
    {
      float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if ((e >> 1) & 1)
          x1 = fmaf(ga[e], sa[e], x1);
        else
          x0 = fmaf(ga[e], sa[e], x0);
      }
      x0 += __shfl_xor_sync(FULL, x0, 1);
      x0 += __shfl_xor_sync(FULL, x0, 2);
      x1 += __shfl_xor_sync(FULL, x1, 1);
      x1 += __shfl_xor_sync(FULL, x1, 2);
      if (tq == 0) {
        x_s[wg * D + d0] = x0;
        x_s[wg * D + d1] = x1;
      }
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int row = 16 * ww + gq + 8 * ((e >> 1) & 1);
        const int col = 8 * (e >> 2) + 2 * tq;
        uint32_t p[3];
        split3_bf16(ga[e], ga[e + 1], p);
#pragma unroll
        for (int q = 0; q < 3; ++q)
          *reinterpret_cast<uint32_t*>(gpt + q * TILE + sw128(row, col)) =
              p[q];
      }
      fence_async_smem();
    }
    wg_sync(wg);
    // S_a dO_a^T (A, S_a's parts, from registers), G_a V_a^T (A the
    // staged G_a, K-major) and G_a^T Kc_a (A the staged G_a read
    // transposed); rows d (c for the last), columns the sub-chunk's tokens
    float sdo[4] = {}, gv[4] = {}, dvx[4] = {};
    wgmma_fence();
    if (do3)
      product8<3>(sdo, sa, base_a + L::O, SUB * a);
    else
      product8<1>(sdo, sa, base_a + L::O, SUB * a);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t vb = base_a + L::V, kb = base_a + L::KC;
      const int ta = SUB * a;
      wgmma_ss8<0, 0>(gv, k_desc(gpa + 2 * TILE, 0, kk), k_desc(vb, ta, kk));
      wgmma_ss8<0, 0>(gv, k_desc(gpa + TILE, 0, kk), k_desc(vb, ta, kk));
      if constexpr (NV == 3) {
        wgmma_ss8<0, 0>(gv, k_desc(gpa, 0, kk),
                        k_desc(vb + 2 * TILE, ta, kk));
        wgmma_ss8<0, 0>(gv, k_desc(gpa + TILE, 0, kk),
                        k_desc(vb + TILE, ta, kk));
        wgmma_ss8<0, 0>(gv, k_desc(gpa, 0, kk), k_desc(vb + TILE, ta, kk));
      }
      wgmma_ss8<0, 0>(gv, k_desc(gpa, 0, kk), k_desc(vb, ta, kk));
      const uint64_t ad = mn_desc(gpa, kk);
      const uint64_t ad1 = mn_desc(gpa + TILE, kk);
      const uint64_t ad2 = mn_desc(gpa + 2 * TILE, kk);
      wgmma_ss8<1, 0>(dvx, ad2, k_desc(kb, ta, kk));
      wgmma_ss8<1, 0>(dvx, ad1, k_desc(kb, ta, kk));
      wgmma_ss8<1, 0>(dvx, ad, k_desc(kb + 2 * TILE, ta, kk));
      wgmma_ss8<1, 0>(dvx, ad1, k_desc(kb + TILE, ta, kk));
      wgmma_ss8<1, 0>(dvx, ad, k_desc(kb + TILE, ta, kk));
      wgmma_ss8<1, 0>(dvx, ad, k_desc(kb, ta, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sdo);
    fence_regs(gv);
    fence_regs(dvx);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * ww + gq + 8 * (e >> 1), col = 2 * tq + (e & 1);
      res[(0 * SUB + col) * D + row] = sdo[e];
      res[(1 * SUB + col) * D + row] = gv[e];
      res[(2 * SUB + col) * D + row] = dvx[e];
    }
    wg_sync(wg);

    // the sub-chunk's tokens, per element: threads 0-63 of the warpgroup
    // a channel d (dr, dk, dw), threads 64-127 a column c (dv)
    const float* da = da_s + a * ITEMS;
    const int ta = SUB * a;
    if (wt < D) {
      const int d = wt;
      float rr[SUB], kv[SUB], wv[SUB], so[SUB], gvv[SUB];
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        rr[m] = r_s[(ta + m) * LA + d];
        kv[m] = k_s[(ta + m) * LA + d];
        wv[m] = w_s[(ta + m) * LA + d];
        so[m] = res[(0 * SUB + m) * D + d];
        gvv[m] = res[(1 * SUB + m) * D + d];
      }
      const float xa = x_s[wg * D + d], ud = uh[d];
      float qp[SUB], kp[SUB];
      {
        float p = 1.0f;
#pragma unroll
        for (int m = 0; m < SUB; ++m) {
          qp[m] = p;
          p *= wv[m];
        }
        p = 1.0f;
#pragma unroll
        for (int m = SUB - 1; m >= 0; --m) {
          kp[m] = p;
          p *= wv[m];
        }
      }
      // psi[i][m] = sum_{j<m} W(m, j) k_j dA(i, j), m <= i
      float psi[SUB][SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        float p = 0.0f;
#pragma unroll
        for (int m = 0; m <= i; ++m) {
          psi[i][m] = p;
          if (m < i) p = fmaf(wv[m], p, kv[m] * da[item(i, m)]);
        }
      }
      // lam = sum_{j<m} W(m, j) k_j Gv_j; sig = sum_{i>m} W(i, m) r_i Sdo_i
      float lam[SUB], sig[SUB];
      {
        float p = 0.0f;
#pragma unroll
        for (int m = 0; m < SUB; ++m) {
          lam[m] = p;
          p = fmaf(wv[m], p, kv[m] * gvv[m]);
        }
        p = 0.0f;
#pragma unroll
        for (int m = SUB - 1; m >= 0; --m) {
          sig[m] = p;
          p = fmaf(wv[m], p, rr[m] * so[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        // the queries after m: W(i, m) r_i (dA(i, m) for dk, psi for dw)
        float phi = 0.0f, tri = 0.0f, wr = 1.0f;
#pragma unroll
        for (int i = m + 1; i < SUB; ++i) {
          const float x = wr * rr[i];
          phi = fmaf(x, da[item(i, m)], phi);
          tri = fmaf(x, psi[i][m], tri);
          wr *= wv[i];
        }
        const float dd = da[item(m, m)];
        du_acc = fmaf(rr[m] * kv[m], dd, du_acc);
        const float drv = fmaf(qp[m], so[m], psi[m][m]) + ud * kv[m] * dd;
        const float dkv = fmaf(kp[m], gvv[m], phi) + ud * rr[m] * dd;
        const float dwv =
            fmaf(kp[m] * qp[m], xa,
                 fmaf(kp[m], lam[m], fmaf(qp[m], sig[m], tri)));
        if (ta + m < n) {
          const size_t o = base + (ta + m) * tstride + d;
          st1(dr + o, drv);
          st1(dk + o, dkv);
          dw[o] = dwv;
        }
      }
    } else {
      const int c = wt - D;
      const float* aw = aw_s + a * ITEMS;
      float ov[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) ov[i] = parts<3>(ot, ta + i, c);
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        float acc = res[(2 * SUB + m) * D + c];
#pragma unroll
        for (int i = m; i < SUB; ++i) acc = fmaf(aw[item(i, m)], ov[i], acc);
        if (ta + m < n) st1(dv + base + (ta + m) * tstride + c, acc);
      }
    }
    wg_sync(wg);                       // res and the G_a parts are free
  }
  if (wt < D) du_s[wg * D + wt] = du_acc;
  __syncthreads();
  if (tid < D)
    du_part[(static_cast<size_t>(b) * nc + ci) * heads * D + h * D + tid] =
        du_s[tid] + du_s[D + tid];
}

}  // namespace grad

// ------------------------------------------------------------ 4. du

constexpr int DU_THREADS = 256;

// du[e] = sum over q of part[q][e], q = (b, chunk) in order
__global__ void __launch_bounds__(DU_THREADS)
wkv_bwd_du(const float* __restrict__ part, int rows, int hd,
           float* __restrict__ du) {
  const int e = blockIdx.x * DU_THREADS + threadIdx.x;
  if (e >= hd) return;
  float a = 0.0f;
  for (int q = 0; q < rows; ++q) a += part[static_cast<size_t>(q) * hd + e];
  du[e] = a;
}

template <typename TI>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dout, const void* s0,
           const void* ds_out, int batch, int heads, int seq, void* sb,
           void* gb, void* dec, void* du_part, void* dr, void* dk, void* dv,
           void* dw, void* du, void* ds0, cudaStream_t stream) {
  const int nc = (seq + C - 1) / C;
  const int bh = batch * heads;
  const auto* rr = static_cast<const TI*>(r);
  const auto* kk = static_cast<const TI*>(k);
  const auto* vv = static_cast<const TI*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* of = static_cast<const float*>(dout);
  auto* sbf = static_cast<float*>(sb);
  auto* gbf = static_cast<float*>(gb);
  auto* decf = static_cast<float*>(dec);
  if (static_cast<long long>(bh) * nc > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  constexpr auto k1 = sum::wkv_bwd_sum<TI>;
  constexpr auto k3 = grad::wkv_bwd_grad<TI>;
  cudaError_t err = allow_smem<k1>(sum::Smem<TI>::BYTES);
  if (err == cudaSuccess) err = allow_smem<k3>(grad::Smem<TI>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);

  k1<<<bh * nc, THREADS, sum::Smem<TI>::BYTES, stream>>>(
      rr, kk, vv, wf, of, heads, seq, nc, sbf, gbf, decf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid2((bh * D * D + edges::EDGE_THREADS - 1) /
                       edges::EDGE_THREADS,
                   2);
  edges::wkv_bwd_edges<<<grid2, edges::EDGE_THREADS, 0, stream>>>(
      static_cast<const float*>(s0), static_cast<const float*>(ds_out),
      decf, bh, nc, sbf, gbf, static_cast<float*>(ds0));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  k3<<<bh * nc, THREADS, grad::Smem<TI>::BYTES, stream>>>(
      rr, kk, vv, wf, static_cast<const float*>(u), of, sbf, gbf, heads,
      seq, nc, static_cast<TI*>(dr), static_cast<TI*>(dk),
      static_cast<TI*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int hd = heads * D;
  wkv_bwd_du<<<(hd + DU_THREADS - 1) / DU_THREADS, DU_THREADS, 0, stream>>>(
      static_cast<const float*>(du_part), batch * nc, hd,
      static_cast<float*>(du));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, 64) float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1);
// w and dout (the output's cotangent): (B, S, H, 64) float32; u: (H, 64)
// float32; s0 (the initial state) and ds_out (the final state's
// cotangent): (B, H, 64, 64) float32, or null for zeros. Scratch
// (float32): sb and gb (B, H, NC, 64, 64), dec (B, H, NC, 64) and du_part
// (B, NC, H, 64), NC = `chunks`, which must be ceil(S / C)
// (`rwkv6_wkv_bwd_chunk` gives C). Out: dr, dk, dv in r's dtype and dw
// float32, (B, S, H, 64); du (H, 64) float32; ds0 (B, H, 64, 64) float32,
// or null where no initial-state gradient is wanted. All contiguous,
// 8-byte aligned; seq >= 1.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* dout,
                             const void* s0, const void* ds_out, int batch,
                             int heads, int seq, int in_bf16, int chunks,
                             void* sb, void* gb, void* dec, void* du_part,
                             void* dr, void* dk, void* dv, void* dw,
                             void* du, void* ds0, void* stream) {
  if (batch * heads == 0) return 0;
  if (seq < 1 || chunks != (seq + C - 1) / C)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = in_bf16 ? launch<__nv_bfloat16> : launch<float>;
  return f(r, k, v, w, u, dout, s0, ds_out, batch, heads, seq, sb, gb, dec,
           du_part, dr, dk, dv, dw, du, ds0,
           static_cast<cudaStream_t>(stream));
}

// The tokens C between two stored states of the backward, with which the
// wrapper sizes its scratch. Launches nothing.
extern "C" int rwkv6_wkv_bwd_chunk() { return C; }
