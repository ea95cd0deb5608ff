// Mamba's selective scan (hymba's SSM heads), backward: the gradients of
// x, dt, b, c, a and of the initial state, given y's cotangent and the
// final state's.
//
// Replaces no TPU kernel: the JAX package differentiates its
// `jax.lax.scan` of the cell `step` under `jax.checkpoint` as XLA
// (src/repro/models/ssm.py:79-105). Per batch row b, channel d and state
// index k the forward is h_t = a_t h_{t-1} + u_t b_t, a_t = exp(dt_t a),
// y_t = sum_k c_t h_t, with u_t = dt_t x_t rounded to the compute dtype
// (see csrc/selective_scan.cu). With gamma_t the cotangent carried into
// token t from the later ones (the final state's cotangent, or 0, after
// the last), a token t in reverse:
//
//   G_t = c_t dy_t + gamma_t                 (dL/dh_t)
//   dc_t = sum_d dy_t h_t,   db_t = sum_d G_t u_t
//   du_t = sum_k G_t b_t,    dx_t = du_t dt_t
//   ddt_t = sum_k G_t h_{t-1} a_t a + du_t x_t
//   da += G_t h_{t-1} a_t dt_t               (summed over b and t)
//   gamma_{t-1} = a_t G_t,   d(initial state) = gamma_{-1}.
//
// `ref.selective_scan_bwd_ref` is the plain version (the forward's
// roundings, float32 until dx, ddt, db and dc are rounded once);
// `ref.selective_scan_bwd_scanned_ref` follows this kernel's order.
//
// The chunked forward's layout run in both directions (selective_scan.cu's
// `chunked`): chunks of CHUNK = 128 tokens, TPC = 8 threads a channel each
// owning a run of ITEMS = 16 consecutive tokens, a loop over the state
// index k. Both recurrences are affine maps, h <- a_t h + u_t b_t and
// gamma <- a_t (gamma + c_t dy_t), so a run is a pair (its decay, its
// value from zero), the decay one exponential of a times the run's summed
// dt, and pairs compose by a warp scan. Four launches:
//   1. `sum`: each chunk's pairs (its h from zero at its end, its gamma
//      from zero at its start) and its summed dt, a block a (b, chunk, 32
//      channels): the runs' pairs composed in order by shuffles.
//   2. `carry`: a thread a (b, d, k) walks the chunks: h before each
//      chunk and gamma after it, in place over the pairs (the chunk's
//      decay, one exponential of a times its summed dt), and the initial
//      state's gradient.
//   3. `grad`: a block a (b, chunk, 32 channels), two blocks an SM. Per
//      k: the run pairs
//      again, composed with the chunk's carries by a forward and a reverse
//      warp scan (the carry folded into the first / last run); each run's
//      h_t from its start, then its tokens in reverse with G_t. dx and ddt
//      are sums over k in registers across the loop; db and dc, sums over
//      channels, are reduced over a warp's 4 channels by a reduce-scatter
//      of shuffles and then over the block's 8 warps in order through
//      shared memory, into partials (B, groups, S, n); a's gradient a
//      partial a (b, chunk).
//   4. `reduce`: db and dc over the channel groups and da over (b,
//      chunk), each in a fixed order.
// Each exponential exp(dt_t a) is formed twice (launches 1 and 3), as the
// SFU's ex2.approx, as the forward forms it. No atomics: two calls give
// the same bits.
//
// Bound on an H100 at Hymba-1.5B's training call (B 1, S 4096, di 3200, n
// 16, bf16): the backward needs exp(dt a) once a (b, t, d, k), 210 M
// exponentials at 16 a clock per SM (the SFU) on 132 SMs at 1.98 GHz,
// ~50 us; the float32 operations (19 a (b, t, d, k): dt a, h's and g's
// updates, g h_{t-1} exp(dt a), and the multiply-adds of dc, db, du, ddt
// and da) 4.0 GFLOP, ~60 us at 67 TFLOP/s; the bytes (x, dt, b, c and
// the float32 dy read, dx, ddt, db, dc written, a and the states in
// float32) ~158 MB, ~47 us. The operations bound it; chip_smoke.py
// computes the bound from each call's shape. This design issues ~20
// instructions a (b, t, d, k) in launch 3 (the two recurrences each
// twice, the five gradient terms, two shuffles of the channel sums) and
// ~8 in launch 1; its scratch (the chunks' pairs and carries, 2 x 6.6 MB;
// the db / dc partials at 100 groups, 2 x 26 MB; da's, 6.6 MB) is read
// and written once.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TPC = 8;                  // threads (runs) a channel
constexpr int ITEMS = 16;               // consecutive tokens a run
constexpr int CHUNK = TPC * ITEMS;      // tokens a chunk
constexpr int WARP_CH = 32 / TPC;       // channels a warp
constexpr int GRAD_CH = 32;             // channels a block of launch 3
constexpr int SUM_CH = 32;              // channels a block of launch 1
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <typename TT>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // a float32 value rounded to bfloat16, as a bfloat16 product is
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// 2^v, the SFU's approximation (MUFU.EX2), subnormal results flushed
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Shared memory of a block of CH channels: x, dt and dy of the chunk as
// float32 [run][item][channel], each run's rows followed by 4 floats so
// that the 8 runs of a warp's channels read distinct banks; b and c as
// float32 [state][token].
template <int CH, int N>
struct Tiles {
  static constexpr int RUN = ITEMS * CH + 4;
  static constexpr int TOK = TPC * RUN;           // floats of x (or dt, dy)
  float x[TOK], dt[TOK], dy[TOK];
  float b[N * CHUNK], c[N * CHUNK];
  static __device__ __forceinline__ int at(int t, int ch) {
    return (t / ITEMS) * RUN + (t % ITEMS) * CH + ch;
  }
};

// 8 bf16 (or 4 float32) values from 16 bytes at p, as float32
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// The chunk from token t0 (nt tokens) of batch row bi and channels [c0,
// c0 + CH) into the tiles; past the sequence and past di zeros (dt 0:
// decay 1, no input). Every load is issued before the first store; with
// `vec` (di a multiple of 8, the rows 16-byte aligned) x, dt and dy by
// 16-byte loads.
template <typename TT, int CH, int N, int THREADS>
__device__ __forceinline__ void load_chunk(Tiles<CH, N>& tl,
                                           const TT* __restrict__ x,
                                           const TT* __restrict__ dt,
                                           const float* __restrict__ dy,
                                           const TT* __restrict__ b,
                                           const TT* __restrict__ c,
                                           size_t row0, int t0, int nt,
                                           int di, int c0, bool vec) {
  constexpr int PER = CHUNK * CH / THREADS;
  constexpr int PBC = (CHUNK * N + THREADS - 1) / THREADS;
  static_assert(CHUNK * CH % THREADS == 0, "whole rounds");
  float xv[PER], dv[PER], yv[PER], bv[PBC], cv[PBC];
#pragma unroll
  for (int q = 0; q < PBC; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const bool in = e < CHUNK * N && e / N < nt;
    bv[q] = in ? Num<TT>::load(b + (row0 + t0) * N + e) : 0.0f;
    cv[q] = in ? Num<TT>::load(c + (row0 + t0) * N + e) : 0.0f;
  }
  if (vec) {
    // x and dt: 8 channels a load (as float32 in xv, dv: the thread's
    // PER / 8 loads, 8 values each); dy: 4 channels a load
    constexpr int EX = 16 / static_cast<int>(sizeof(TT));
    static_assert(PER % 8 == 0 && CH % 8 == 0, "whole 16-byte loads");
#pragma unroll
    for (int q = 0; q < PER / EX; ++q) {
      const int e = threadIdx.x + q * THREADS;       // (t, channel / EX)
      const int t = e / (CH / EX), cc = (e % (CH / EX)) * EX;
      const bool in = t < nt && c0 + cc < di;
      const size_t g = (row0 + t0 + t) * di + c0 + cc;
      if (in) {
        load16(x + g, xv + q * EX);
        load16(dt + g, dv + q * EX);
      } else {
#pragma unroll
        for (int m = 0; m < EX; ++m) xv[q * EX + m] = dv[q * EX + m] = 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const int e = threadIdx.x + q * THREADS;       // (t, channel / 4)
      const int t = e / (CH / 4), cc = (e % (CH / 4)) * 4;
      const bool in = t < nt && c0 + cc < di;
      if (in)
        load16(dy + (row0 + t0 + t) * di + c0 + cc, yv + q * 4);
      else
        yv[q * 4] = yv[q * 4 + 1] = yv[q * 4 + 2] = yv[q * 4 + 3] = 0.0f;
    }
#pragma unroll
    for (int q = 0; q < PER / EX; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int t = e / (CH / EX), cc = (e % (CH / EX)) * EX;
#pragma unroll
      for (int m = 0; m < EX; ++m) {
        const int s = Tiles<CH, N>::at(t, cc + m);
        tl.x[s] = xv[q * EX + m];
        tl.dt[s] = dv[q * EX + m];
      }
    }
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int t = e / (CH / 4), cc = (e % (CH / 4)) * 4;
#pragma unroll
      for (int m = 0; m < 4; ++m) tl.dy[Tiles<CH, N>::at(t, cc + m)] =
          yv[q * 4 + m];
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int t = e / CH, cc = e % CH;
      const bool in = t < nt && c0 + cc < di;
      const size_t g = in ? (row0 + t0 + t) * di + c0 + cc : 0;
      xv[q] = in ? Num<TT>::load(x + g) : 0.0f;
      dv[q] = in ? Num<TT>::load(dt + g) : 0.0f;
      yv[q] = in ? dy[g] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = threadIdx.x + q * THREADS;
      const int s = Tiles<CH, N>::at(e / CH, e % CH);
      tl.x[s] = xv[q];
      tl.dt[s] = dv[q];
      tl.dy[s] = yv[q];
    }
  }
#pragma unroll
  for (int q = 0; q < PBC; ++q) {
    const int e = threadIdx.x + q * THREADS;
    if (e < CHUNK * N) {
      tl.b[(e % N) * CHUNK + e / N] = bv[q];
      tl.c[(e % N) * CHUNK + e / N] = cv[q];
    }
  }
}

// ITEMS consecutive float32 values, 16-byte aligned, by float4
__device__ __forceinline__ void load_items(const float* src,
                                           float (&v)[ITEMS]) {
#pragma unroll
  for (int q = 0; q < ITEMS / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(src)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// value i of a run read as float4s (i a constant after unrolling)
__device__ __forceinline__ float at(const float4* v, int i) {
  const float4 q = v[i / 4];
  return i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
}

// The thread's run: dt, u = dt x (rounded to TT) and dy of its ITEMS
// tokens and their summed dt.
template <typename TT, int CH, int N>
__device__ __forceinline__ float load_run(const Tiles<CH, N>& tl, int j,
                                          int lc, float (&dv)[ITEMS],
                                          float (&u)[ITEMS],
                                          float (&yv)[ITEMS]) {
  float sdt = 0.0f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = j * Tiles<CH, N>::RUN + i * CH + lc;
    dv[i] = tl.dt[s];
    u[i] = Num<TT>::round(__fmul_rn(dv[i], tl.x[s]));
    yv[i] = tl.dy[s];
    sdt = __fadd_rn(sdt, dv[i]);
  }
  return sdt;
}

// ------------------------------------------------------ 1. chunk pairs

namespace sum {

constexpr int THREADS = SUM_CH * TPC;   // 256

template <typename TT, int N>
__global__ void __launch_bounds__(THREADS)
scan_bwd_sum(const TT* __restrict__ x, const TT* __restrict__ dt,
             const TT* __restrict__ b, const TT* __restrict__ c,
             const float* __restrict__ dy, const float* __restrict__ a,
             int seq, int di, int nc, int vec, float* __restrict__ hb,
             float* __restrict__ gb, float* __restrict__ csdt) {
  using TL = Tiles<SUM_CH, N>;
  extern __shared__ __align__(16) unsigned char raw[];
  TL& tl = *reinterpret_cast<TL*>(raw);
  __shared__ float oh[SUM_CH * N], og[SUM_CH * N];
  const int groups = (di + SUM_CH - 1) / SUM_CH;
  const int grp = blockIdx.x % groups;
  const int ci = (blockIdx.x / groups) % nc;
  const int bi = blockIdx.x / (groups * nc);
  const int c0 = grp * SUM_CH, t0 = ci * CHUNK;
  const size_t row0 = static_cast<size_t>(bi) * seq;
  load_chunk<TT, SUM_CH, N, THREADS>(tl, x, dt, dy, b, c, row0, t0,
                                     min(CHUNK, seq - t0), di, c0, vec);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int j = lane / WARP_CH;
  const int lc = (threadIdx.x / 32) * WARP_CH + lane % WARP_CH;
  const int ch = c0 + lc;
  const bool live = ch < di;
  float dv[ITEMS], u[ITEMS], yv[ITEMS];
  float sdt = load_run<TT, SUM_CH, N>(tl, j, lc, dv, u, yv);
  float tot = sdt;                       // the chunk's summed dt
#pragma unroll
  for (int d = 1; d < TPC; d <<= 1) {
    const float o = __shfl_down_sync(FULL, tot, d * WARP_CH);
    if (j + d < TPC) tot = __fadd_rn(tot, o);
  }
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const float ak =
        live ? __fmul_rn(a[static_cast<size_t>(ch) * N + k], LOG2E) : 0.0f;
    float bc[ITEMS], cc[ITEMS], da[ITEMS];
    load_items(tl.b + k * CHUNK + j * ITEMS, bc);
    load_items(tl.c + k * CHUNK + j * ITEMS, cc);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) da[i] = ex2(__fmul_rn(dv[i], ak));
    float pa = ex2(__fmul_rn(sdt, ak));
    float ph = __fmul_rn(u[0], bc[0]), pg = 0.0f;
#pragma unroll
    for (int i = 1; i < ITEMS; ++i)
      ph = fmaf(da[i], ph, __fmul_rn(u[i], bc[i]));
#pragma unroll
    for (int i = ITEMS - 1; i >= 0; --i)
      pg = __fmul_rn(da[i], fmaf(cc[i], yv[i], pg));
    // the runs composed in order (h) and in reverse (gamma): lane j takes
    // the pair of lane j + d
    float qa = pa;
#pragma unroll
    for (int d = 1; d < TPC; d <<= 1) {
      const float oa = __shfl_down_sync(FULL, qa, d * WARP_CH);
      const float oph = __shfl_down_sync(FULL, ph, d * WARP_CH);
      const float opg = __shfl_down_sync(FULL, pg, d * WARP_CH);
      if (j + d < TPC) {
        ph = fmaf(oa, ph, oph);
        pg = fmaf(qa, opg, pg);
        qa = __fmul_rn(qa, oa);
      }
    }
    if (j == 0) {
      oh[lc * N + k] = ph;
      og[lc * N + k] = pg;
    }
  }
  __syncthreads();
  const size_t base = (static_cast<size_t>(bi) * nc + ci) * di;
  for (int e = threadIdx.x; e < SUM_CH * N; e += THREADS) {
    if (c0 + e / N < di) {
      hb[(base + c0) * N + e] = oh[e];
      gb[(base + c0) * N + e] = og[e];
    }
  }
  if (j == 0 && live) csdt[base + ch] = tot;
}

}  // namespace sum

// ------------------------------------------------- 2. the chunk carries

namespace carry {

constexpr int THREADS = 256;

// blockIdx.y 0: h before each chunk, forward from h0 over hb in place;
// 1: gamma after each chunk, backward from dh_out over gb in place, and
// the initial state's gradient
template <int N>
__global__ void __launch_bounds__(THREADS)
scan_bwd_carry(const float* __restrict__ a, const float* __restrict__ h0,
               const float* __restrict__ dh_out,
               const float* __restrict__ csdt, int batch, int di, int nc,
               float* __restrict__ hb, float* __restrict__ gb,
               float* __restrict__ dh0) {
  const int e = blockIdx.x * THREADS + threadIdx.x;   // (b, d, k)
  if (e >= batch * di * N) return;
  const int bi = e / (di * N), dk = e % (di * N), d = dk / N;
  const float ak = __fmul_rn(a[dk], LOG2E);
  const bool rev = blockIdx.y == 1;
  const float* init = rev ? dh_out : h0;
  float v = init != nullptr ? init[e] : 0.0f;
  float* buf = rev ? gb : hb;
  // eight chunks' loads in flight, then their stores
  for (int q0 = 0; q0 < nc; q0 += 8) {
    float p[8], sd[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int q = min(q0 + m, nc - 1);
      const size_t row = static_cast<size_t>(bi) * nc + (rev ? nc - 1 - q : q);
      p[m] = buf[row * di * N + dk];
      sd[m] = csdt[row * di + d];
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (q0 + m >= nc) break;
      const int q = q0 + m;
      const size_t row = static_cast<size_t>(bi) * nc + (rev ? nc - 1 - q : q);
      buf[row * di * N + dk] = v;
      v = fmaf(ex2(__fmul_rn(sd[m], ak)), v, p[m]);
    }
  }
  if (rev && dh0 != nullptr) dh0[e] = v;
}

}  // namespace carry

// ------------------------------------------------------ 3. the gradients

namespace grad {

constexpr int THREADS = GRAD_CH * TPC;  // 256
constexpr int WARPS = THREADS / 32;

template <int N>
struct Smem {
  Tiles<GRAD_CH, N> tl;
  float stage[2][2][WARPS][CHUNK];      // a warp's db, dc sums a k
  float pb[CHUNK * N], pc[CHUNK * N];   // the block's [token][state]
  float a[GRAD_CH * N];                 // a, and the carries, [ch][state]
  float hin[GRAD_CH * N], gin[GRAD_CH * N];
  float da[GRAD_CH * N];
};

// x[0, 8) summed over the 4 lanes of a warp's channels (lane bits 0 and
// 1), scattered: the lane keeps entries 4 b0 + 2 b1 + [0, 2) in x[0, 2)
__device__ __forceinline__ void channel_sum(float (&x)[8], int lane) {
  const bool up0 = lane & 1, up1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = up0 ? x[4 + i] : x[i];
    const float send = up0 ? x[i] : x[4 + i];
    x[i] = keep + __shfl_xor_sync(FULL, send, 1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = up1 ? x[2 + i] : x[i];
    const float send = up1 ? x[i] : x[2 + i];
    x[i] = keep + __shfl_xor_sync(FULL, send, 2);
  }
}

// two blocks an SM, so that one's staging overlaps the other's loop
template <typename TT, int N>
__global__ void __launch_bounds__(THREADS, 2)
scan_bwd_grad(const TT* __restrict__ x, const TT* __restrict__ dt,
              const TT* __restrict__ b, const TT* __restrict__ c,
              const float* __restrict__ dy, const float* __restrict__ a,
              const float* __restrict__ hb, const float* __restrict__ gb,
              int seq, int di, int nc, int groups, int vec,
              TT* __restrict__ dx, TT* __restrict__ ddt,
              float* __restrict__ part_db, float* __restrict__ part_dc,
              float* __restrict__ part_da) {
  using TL = Tiles<GRAD_CH, N>;
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(raw);
  const int grp = blockIdx.x % groups;
  const int ci = (blockIdx.x / groups) % nc;
  const int bi = blockIdx.x / (groups * nc);
  const int c0 = grp * GRAD_CH, t0 = ci * CHUNK;
  const int nt = min(CHUNK, seq - t0);
  const size_t row0 = static_cast<size_t>(bi) * seq;
  const size_t cbase = (static_cast<size_t>(bi) * nc + ci) * di;
  load_chunk<TT, GRAD_CH, N, THREADS>(sm.tl, x, dt, dy, b, c, row0, t0, nt,
                                      di, c0, vec);
  for (int e = threadIdx.x; e < GRAD_CH * N; e += THREADS) {
    const bool live = c0 + e / N < di;
    sm.a[e] = live ? a[static_cast<size_t>(c0) * N + e] : 0.0f;
    sm.hin[e] = live ? hb[(cbase + c0) * N + e] : 0.0f;
    sm.gin[e] = live ? gb[(cbase + c0) * N + e] : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = lane / WARP_CH;
  const int lc = warp * WARP_CH + lane % WARP_CH;
  float dv[ITEMS], u[ITEMS], yv[ITEMS], du[ITEMS], dd[ITEMS];
  const float sdt = load_run<TT, GRAD_CH, N>(sm.tl, j, lc, dv, u, yv);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) du[i] = dd[i] = 0.0f;
  // the token slots of this lane's channel sums (+ 8 for the upper half)
  const int slot = j * ITEMS + 4 * (lane & 1) + 2 * ((lane >> 1) & 1);

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    const float akn = sm.a[lc * N + k];
    const float ak = __fmul_rn(akn, LOG2E);
    const float4* bk = reinterpret_cast<const float4*>(
        sm.tl.b + k * CHUNK + j * ITEMS);
    const float4* ck = reinterpret_cast<const float4*>(
        sm.tl.c + k * CHUNK + j * ITEMS);
    float da[ITEMS], hs[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) da[i] = ex2(__fmul_rn(dv[i], ak));
    // h: the run's pair, the chunk's carry folded into run 0, an
    // inclusive scan over the runs; h_in the state before the run
    float pa = ex2(__fmul_rn(sdt, ak));
    float ph = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      ph = fmaf(da[i], ph, __fmul_rn(u[i], at(bk, i)));
    const float hin = sm.hin[lc * N + k];
    if (j == 0) ph = fmaf(pa, hin, ph);
    float qa = pa;
#pragma unroll
    for (int d = 1; d < TPC; d <<= 1) {
      const float ua = __shfl_up_sync(FULL, qa, d * WARP_CH);
      const float uh = __shfl_up_sync(FULL, ph, d * WARP_CH);
      if (j >= d) {
        ph = fmaf(qa, uh, ph);
        qa = __fmul_rn(qa, ua);
      }
    }
    float h = __shfl_up_sync(FULL, ph, WARP_CH);
    if (j == 0) h = hin;
    const float h_in = h;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      h = fmaf(da[i], h, __fmul_rn(u[i], at(bk, i)));
      hs[i] = h;
    }
    // gamma: the run's pair, the chunk's carry folded into the last run,
    // an inclusive scan over the runs in reverse; gam the carry into the
    // run's last token
    float pg = 0.0f;
#pragma unroll
    for (int i = ITEMS - 1; i >= 0; --i)
      pg = __fmul_rn(da[i], fmaf(at(ck, i), yv[i], pg));
    const float gin = sm.gin[lc * N + k];
    if (j == TPC - 1) pg = fmaf(pa, gin, pg);
    qa = pa;
#pragma unroll
    for (int d = 1; d < TPC; d <<= 1) {
      const float oa = __shfl_down_sync(FULL, qa, d * WARP_CH);
      const float og = __shfl_down_sync(FULL, pg, d * WARP_CH);
      if (j + d < TPC) {
        pg = fmaf(qa, og, pg);
        qa = __fmul_rn(qa, oa);
      }
    }
    float gam = __shfl_down_sync(FULL, pg, WARP_CH);
    if (j == TPC - 1) gam = gin;
    // the run's tokens in reverse, in halves of 8: db and dc of a half
    // summed over the warp's channels, into the stage
    float dak = 0.0f;
#pragma unroll
    for (int half = 1; half >= 0; --half) {
      float pb[8], pc[8];
#pragma unroll
      for (int m = 7; m >= 0; --m) {
        const int i = 8 * half + m;
        const float gg = fmaf(at(ck, i), yv[i], gam);
        const float hp = i > 0 ? hs[i > 0 ? i - 1 : 0] : h_in;
        pc[m] = __fmul_rn(yv[i], hs[i]);
        pb[m] = __fmul_rn(gg, u[i]);
        du[i] = fmaf(gg, at(bk, i), du[i]);
        const float q = __fmul_rn(__fmul_rn(gg, hp), da[i]);
        dd[i] = fmaf(q, akn, dd[i]);
        dak = fmaf(q, dv[i], dak);
        gam = __fmul_rn(da[i], gg);
      }
      channel_sum(pb, lane);
      channel_sum(pc, lane);
      const int t = slot + 8 * half;
      *reinterpret_cast<float2*>(&sm.stage[k & 1][0][warp][t]) =
          make_float2(pb[0], pb[1]);
      *reinterpret_cast<float2*>(&sm.stage[k & 1][1][warp][t]) =
          make_float2(pc[0], pc[1]);
    }
    // da over the channel's runs (lane bits 2-4), in a fixed order
    dak += __shfl_xor_sync(FULL, dak, WARP_CH);
    dak += __shfl_xor_sync(FULL, dak, 2 * WARP_CH);
    dak += __shfl_xor_sync(FULL, dak, 4 * WARP_CH);
    if (j == 0) sm.da[lc * N + k] = dak;
    __syncthreads();
    if (threadIdx.x < 2 * CHUNK) {
      const int q = threadIdx.x / CHUNK, t = threadIdx.x % CHUNK;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += sm.stage[k & 1][q][w][t];
      (q ? sm.pc : sm.pb)[t * N + k] = s;
    }
  }
  // dx, ddt through the x tile (read last here), then out by rows
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int s = j * TL::RUN + i * GRAD_CH + lc;
    const float xv = sm.tl.x[s];
    sm.tl.x[s] = __fmul_rn(du[i], dv[i]);
    sm.tl.dy[s] = fmaf(du[i], xv, dd[i]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nt * GRAD_CH; e += THREADS) {
    const int t = e / GRAD_CH, cc = e % GRAD_CH;
    if (c0 + cc < di) {
      const size_t g = (row0 + t0 + t) * di + c0 + cc;
      const int s = TL::at(t, cc);
      Num<TT>::store(dx + g, sm.tl.x[s]);
      Num<TT>::store(ddt + g, sm.tl.dy[s]);
    }
  }
  const size_t prow =
      ((static_cast<size_t>(bi) * groups + grp) * seq + t0) * N;
  for (int e = threadIdx.x; e < nt * N; e += THREADS) {
    part_db[prow + e] = sm.pb[e];
    part_dc[prow + e] = sm.pc[e];
  }
  for (int e = threadIdx.x; e < GRAD_CH * N; e += THREADS)
    if (c0 + e / N < di) part_da[(cbase + c0) * N + e] = sm.da[e];
}

}  // namespace grad

// ---------------------------------------------------------- 4. reduce

constexpr int RED_THREADS = 256;

// db, dc (B rows of S n) over the channel groups; da (di n) over the (b,
// chunk) partials; each sum in order
template <typename TT>
__global__ void __launch_bounds__(RED_THREADS)
scan_bwd_reduce(const float* __restrict__ part_db,
                const float* __restrict__ part_dc,
                const float* __restrict__ part_da, int batch, int sn,
                int groups, int bnc, int dn, TT* __restrict__ db,
                TT* __restrict__ dc, float* __restrict__ da) {
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  if (e < batch * sn) {
    const int bi = e / sn, r = e % sn;
    float sb = 0.0f, sc = 0.0f;
    for (int g = 0; g < groups; ++g) {
      const size_t o = (static_cast<size_t>(bi) * groups + g) * sn + r;
      sb += part_db[o];
      sc += part_dc[o];
    }
    Num<TT>::store(db + e, sb);
    Num<TT>::store(dc + e, sc);
  }
  if (e < dn) {
    float s = 0.0f;
    for (int q = 0; q < bnc; ++q)
      s += part_da[static_cast<size_t>(q) * dn + e];
    da[e] = s;
  }
}

template <typename TT, int N>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* dy, const void* h0,
           const void* dh_out, int batch, int seq, int di, void* hb,
           void* gb, void* csdt, void* part_db, void* part_dc,
           void* part_da, void* dx, void* ddt, void* db, void* dc, void* da,
           void* dh0, cudaStream_t stream) {
  const int nc = (seq + CHUNK - 1) / CHUNK;
  const auto* xx = static_cast<const TT*>(x);
  const auto* dtt = static_cast<const TT*>(dt);
  const auto* bb = static_cast<const TT*>(b);
  const auto* cc = static_cast<const TT*>(c);
  const auto* af = static_cast<const float*>(a);
  const auto* dyf = static_cast<const float*>(dy);
  auto* hbf = static_cast<float*>(hb);
  auto* gbf = static_cast<float*>(gb);
  auto* sdt = static_cast<float*>(csdt);

  const long long blocks1 = static_cast<long long>(batch) * nc *
                            ((di + SUM_CH - 1) / SUM_CH);
  const int groups = (di + GRAD_CH - 1) / GRAD_CH;
  const long long blocks3 = static_cast<long long>(batch) * nc * groups;
  if (blocks1 > 0x7fffffffLL || blocks3 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  constexpr auto k1 = sum::scan_bwd_sum<TT, N>;
  constexpr int smem1 = sizeof(Tiles<SUM_CH, N>);
  constexpr auto k3 = grad::scan_bwd_grad<TT, N>;
  constexpr int smem3 = sizeof(grad::Smem<N>);
  // above 48 KB a kernel needs an attribute, set at its first launch
  // (the port drives one card a process)
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        k3, cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);

  // 16-byte loads of x, dt and dy where every row allows them
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = di % 8 == 0 && aligned(x) && aligned(dt) && aligned(dy);
  k1<<<static_cast<unsigned>(blocks1), sum::THREADS, smem1, stream>>>(
      xx, dtt, bb, cc, dyf, af, seq, di, nc, vec, hbf, gbf, sdt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid2((batch * di * N + carry::THREADS - 1) / carry::THREADS,
                   2);
  carry::scan_bwd_carry<N><<<grid2, carry::THREADS, 0, stream>>>(
      af, static_cast<const float*>(h0), static_cast<const float*>(dh_out),
      sdt, batch, di, nc, hbf, gbf, static_cast<float*>(dh0));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  k3<<<static_cast<unsigned>(blocks3), grad::THREADS, smem3, stream>>>(
      xx, dtt, bb, cc, dyf, af, hbf, gbf, seq, di, nc, groups, vec,
      static_cast<TT*>(dx), static_cast<TT*>(ddt),
      static_cast<float*>(part_db), static_cast<float*>(part_dc),
      static_cast<float*>(part_da));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int sn = seq * N;
  const int dn = di * N;
  const int total = batch * sn > dn ? batch * sn : dn;
  scan_bwd_reduce<TT><<<(total + RED_THREADS - 1) / RED_THREADS, RED_THREADS,
                        0, stream>>>(
      static_cast<const float*>(part_db), static_cast<const float*>(part_dc),
      static_cast<const float*>(part_da), batch, sn, groups, batch * nc, dn,
      static_cast<TT*>(db), static_cast<TT*>(dc), static_cast<float*>(da));
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, const void*,
                       int, int, int, void*, void*, void*, void*, void*,
                       void*, void*, void*, void*, void*, void*, void*,
                       cudaStream_t);

}  // namespace

// x, dt: (batch, seq, channels) and b, c: (batch, seq, state), float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); a: (channels, state) float32;
// dy (y's cotangent): (batch, seq, channels) float32; h0 (the initial
// state) and dh_out (the final state's cotangent): (batch, channels,
// state) float32, or null for zeros. Scratch (float32): hb, gb and part_da
// (batch, NC, channels, state), csdt (batch, NC, channels), part_db and
// part_dc (batch, groups, seq, state), NC = `chunks` and groups =
// `groups`, which must be ceil(seq / CHUNK) and ceil(channels / GRAD_CH)
// (`selective_scan_bwd_tiles` gives both). Out: dx, ddt in x's dtype,
// (batch, seq, channels); db, dc in x's dtype, (batch, seq, state); da
// (channels, state) float32; dh0 (batch, channels, state) float32, or
// null where no initial-state gradient is wanted. All contiguous; seq >=
// 1; state 8 or 16.
extern "C" int selective_scan_bwd(const void* x, const void* dt,
                                  const void* b, const void* c,
                                  const void* a, const void* dy,
                                  const void* h0, const void* dh_out,
                                  int batch, int seq, int channels,
                                  int state, int is_bf16, int chunks,
                                  int groups, void* hb, void* gb,
                                  void* csdt, void* part_db, void* part_dc,
                                  void* part_da, void* dx, void* ddt,
                                  void* db, void* dc, void* da, void* dh0,
                                  void* stream) {
  if (batch == 0 || channels == 0) return 0;
  if (seq < 1 || chunks != (seq + CHUNK - 1) / CHUNK ||
      groups != (channels + GRAD_CH - 1) / GRAD_CH)
    return static_cast<int>(cudaErrorInvalidValue);
  using BF = __nv_bfloat16;
  Launch fn = nullptr;
  if (state == 16) fn = is_bf16 ? launch<BF, 16> : launch<float, 16>;
  if (state == 8) fn = is_bf16 ? launch<BF, 8> : launch<float, 8>;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(x, dt, b, c, a, dy, h0, dh_out, batch, seq, channels, hb, gb,
            csdt, part_db, part_dc, part_da, dx, ddt, db, dc, da, dh0,
            static_cast<cudaStream_t>(stream));
}

// The backward's tiles, with which the wrapper sizes its scratch: *chunk
// tokens CHUNK between two stored carries, *group channels a block of the
// gradients' launch. Launches nothing.
extern "C" void selective_scan_bwd_tiles(int* chunk, int* group) {
  *chunk = CHUNK;
  *group = GRAD_CH;
}
