// Mamba's selective scan (hymba's SSM heads), backward: the gradients of
// x, dt, b, c, a and of the initial state, given y's cotangent and the
// final state's.
//
// Replaces no TPU kernel: the JAX package differentiates its
// `jax.lax.scan` of the cell `step` under `jax.checkpoint` as XLA
// (src/repro/models/ssm.py:79-105). Per batch row b, channel d and state
// index k the forward is h_t = exp(dt_t a) h_{t-1} + u_t b_t, y_t =
// sum_k c_t h_t, with u_t = dt_t x_t rounded to the compute dtype (see
// csrc/selective_scan.cu). With g = dL/dh, carried from the final state's
// cotangent (or 0), a token t in reverse:
//
//   g <- g + c_t dy_t
//   dc_t = sum_d dy_t h_t,   db_t = sum_d g u_t
//   du_t = sum_k g b_t,      dx_t = du_t dt_t
//   ddt_t = sum_k g h_{t-1} exp(dt_t a) a + du_t x_t
//   da += g h_{t-1} exp(dt_t a) dt_t   (summed over b and t)
//   g <- exp(dt_t a) g,      d(initial state) = g after token 0.
//
// `ref.selective_scan_bwd_ref` is the plain version: the forward's
// roundings, then float32 until dx, ddt, db and dc are rounded once to the
// compute dtype. u's rounding is taken to have derivative 1 (the gradient
// of the exact product), formed in float32; autograd through the plain
// forward in bfloat16 rounds du, du dt and ddt's two terms to bfloat16
// instead, which parts the two by up to three bfloat16 roundings.
//
// Three launches:
//   1. `bounds`: h before each chunk of T = 32 tokens (forward from h0)
//      and g's carry into each chunk's last token (backward from the
//      final state's cotangent), into scratch (B, NC, di, n) float32: a
//      thread a (b, d, k), every token in turn, 64-token tiles staged in
//      shared memory as in the forward's per-state form; blockIdx.y picks
//      the pass.
//   2. `chunk`: a block a (b, chunk, 64 channels), 256 threads, a thread
//      a (channel, state index), the 64 channels in passes of 256 / n. A
//      forward walk from the chunk's h keeps h_t and exp(dt_t a) of its 32
//      tokens in registers; the reverse walk forms the gradients: sums
//      over k (dx, ddt) by shuffles within the channel's n lanes, sums over
//      the channels (db, dc) by shuffles within a warp and then over the
//      warps and passes in order in shared memory, into per-block partials
//      (B, S, groups, n); a's gradient as a per-chunk partial (B, NC, di,
//      n).
//   3. `reduce`: db and dc over the channel groups and da over (b, chunk),
//      each in a fixed order.
// No atomics: two calls give the same bits.
//
// Bound on an H100 at Hymba-1.5B's training call (B 1, S 4096, di 3200, n
// 16, bf16): the backward needs exp(dt a) once a (b, t, d, k), 210 M
// exponentials at 16 a clock per SM (the SFU) on 132 SMs at 1.98 GHz,
// ~50 us; the float32 operations (19 a (b, t, d, k): dt a, h's and g's
// updates, g h_{t-1} exp(dt a), and the multiply-adds of dc, db, du, ddt
// and da) 4.0 GFLOP, ~60 us at 67 TFLOP/s; the bytes (x, dt, b, c and
// the float32 dy read, dx, ddt, db, dc written, a and the states in
// float32) ~158 MB, ~47 us. The operations bound it; chip_smoke.py
// computes the bound from each call's shape. The kernel forms each
// exponential three times (launch 1's two passes and launch 2) and h
// twice.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int T = 32;                   // tokens a chunk of the backward
constexpr unsigned FULL = 0xffffffffu;

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

// ------------------------------------------------------ 1. chunk bounds

namespace bounds {

constexpr int THREADS = 128;
constexpr int TILE = 64;                // tokens staged a round

template <typename TT, int N>
__global__ void __launch_bounds__(THREADS)
scan_bwd_bounds(const TT* __restrict__ x, const TT* __restrict__ dt,
              const TT* __restrict__ b, const TT* __restrict__ c,
              const float* __restrict__ dy, const float* __restrict__ a,
              const float* __restrict__ h0, const float* __restrict__ dh_out,
              int seq, int di, int nc, float* __restrict__ hb,
              float* __restrict__ gb) {
  constexpr int CH = THREADS / N;       // channels a block
  __shared__ float sx[TILE * CH];       // x (state pass), dy (cotangent)
  __shared__ float sdt[TILE * CH];
  __shared__ float sbc[TILE * N];       // b (state pass), c (cotangent)

  const bool rev = blockIdx.y == 1;
  const int groups = (di + CH - 1) / CH;
  const int bi = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * CH;
  const int tid = threadIdx.x;
  const int lc = tid / N, kk = tid % N;
  const int ch = c0 + lc;
  const bool live = ch < di;
  const float ak = live ? a[static_cast<size_t>(ch) * N + kk] : 0.0f;
  const float* init = rev ? dh_out : h0;
  float hh = (live && init != nullptr)
                 ? init[(static_cast<size_t>(bi) * di + ch) * N + kk]
                 : 0.0f;
  float* out = rev ? gb : hb;

  const size_t row0 = static_cast<size_t>(bi) * seq;   // token (bi, 0)
  const int ntiles = (seq + TILE - 1) / TILE;
  for (int q = 0; q < ntiles; ++q) {
    const int t0 = (rev ? ntiles - 1 - q : q) * TILE;
    const int nt = min(TILE, seq - t0);
    __syncthreads();                    // the previous tile is consumed
    for (int e = tid; e < nt * CH; e += THREADS) {
      const int tt = e / CH, cc = e % CH;
      float xv = 0.0f, dv = 0.0f;
      if (c0 + cc < di) {
        const size_t g = (row0 + t0 + tt) * di + c0 + cc;
        xv = rev ? dy[g] : Num<TT>::load(x + g);
        dv = Num<TT>::load(dt + g);
      }
      sx[e] = xv;
      sdt[e] = dv;
    }
    for (int e = tid; e < nt * N; e += THREADS) {
      const size_t g = (row0 + t0) * N + e;
      sbc[e] = Num<TT>::load((rev ? c : b) + g);
    }
    __syncthreads();
    for (int p = 0; p < nt; ++p) {
      const int tt = rev ? nt - 1 - p : p;
      const int t = t0 + tt;
      const float dv = sdt[tt * CH + lc];
      const float da = expf(__fmul_rn(dv, ak));
      const size_t o =
          ((static_cast<size_t>(bi) * nc + t / T) * di + ch) * N + kk;
      if (!rev) {               // h before each chunk's first token
        if (t % T == 0 && live) out[o] = hh;
        const float u = Num<TT>::round(__fmul_rn(dv, sx[tt * CH + lc]));
        hh = __fadd_rn(__fmul_rn(da, hh), __fmul_rn(u, sbc[tt * N + kk]));
      } else {                  // g's carry into each chunk's last token
        if ((t == seq - 1 || (t + 1) % T == 0) && live) out[o] = hh;
        hh = __fmul_rn(da, __fadd_rn(hh, __fmul_rn(sbc[tt * N + kk],
                                                   sx[tt * CH + lc])));
      }
    }
  }
}

}  // namespace bounds

// ------------------------------------------------- 2. the reverse walk

namespace chunk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHB = 64;                 // channels a block

template <int N>
struct Smem {
  float x[T][CHB], dt[T][CHB], dy[T][CHB];
  float b[T][N], c[T][N];
  float dx[T][CHB], ddt[T][CHB];
  float db[T][WARPS][N], dc[T][WARPS][N];   // a pass's warp sums
  float accb[T][N], accc[T][N];             // the block's, over passes
};

template <typename TT, int N>
__global__ void __launch_bounds__(THREADS)
scan_bwd_chunk(const TT* __restrict__ x, const TT* __restrict__ dt,
             const TT* __restrict__ b, const TT* __restrict__ c,
             const float* __restrict__ dy, const float* __restrict__ a,
             const float* __restrict__ hb, const float* __restrict__ gb,
             int seq, int di, int nc, int groups, TT* __restrict__ dx,
             TT* __restrict__ ddt, float* __restrict__ part_db,
             float* __restrict__ part_dc, float* __restrict__ part_da,
             float* __restrict__ dh0) {
  constexpr int P = THREADS / N;        // channels a pass
  static_assert(CHB % P == 0, "whole passes");
  extern __shared__ __align__(16) unsigned char raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(raw);
  const int grp = blockIdx.x % groups;
  const int cidx = (blockIdx.x / groups) % nc;
  const int bi = blockIdx.x / (groups * nc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = grp * CHB;
  const int t0 = cidx * T;
  const int n = min(T, seq - t0);
  const size_t row0 = static_cast<size_t>(bi) * seq + t0;

  // the chunk's tokens; past the sequence (and past di) zeros, which
  // leave h and g as they are (dt 0: decay 1)
  for (int e = tid; e < T * CHB; e += THREADS) {
    const int tt = e / CHB, cc = e % CHB;
    float xv = 0.0f, dv = 0.0f, yv = 0.0f;
    if (tt < n && c0 + cc < di) {
      const size_t g = (row0 + tt) * di + c0 + cc;
      xv = Num<TT>::load(x + g);
      dv = Num<TT>::load(dt + g);
      yv = dy[g];
    }
    sm.x[tt][cc] = xv;
    sm.dt[tt][cc] = dv;
    sm.dy[tt][cc] = yv;
  }
  for (int e = tid; e < T * N; e += THREADS) {
    const int tt = e / N, kk = e % N;
    float bv = 0.0f, cv = 0.0f;
    if (tt < n) {
      const size_t g = (row0 + tt) * N + kk;
      bv = Num<TT>::load(b + g);
      cv = Num<TT>::load(c + g);
    }
    sm.b[tt][kk] = bv;
    sm.c[tt][kk] = cv;
    sm.accb[tt][kk] = 0.0f;
    sm.accc[tt][kk] = 0.0f;
  }
  __syncthreads();

  const int kk = tid % N;
  for (int pass = 0; pass < CHB / P; ++pass) {
    const int lc = pass * P + tid / N;  // the block's channel
    const int ch = c0 + lc;
    const bool live = ch < di;
    const float ak = live ? a[static_cast<size_t>(ch) * N + kk] : 0.0f;
    const size_t si =
        ((static_cast<size_t>(bi) * nc + cidx) * di + ch) * N + kk;
    const float hstart = live ? hb[si] : 0.0f;
    float g = live ? gb[si] : 0.0f;
    float hs[T], ds[T];                 // h_t and exp(dt_t a) of the chunk
    float h = hstart;
#pragma unroll
    for (int m = 0; m < T; ++m) {
      const float dv = sm.dt[m][lc];
      ds[m] = expf(__fmul_rn(dv, ak));
      const float u = Num<TT>::round(__fmul_rn(dv, sm.x[m][lc]));
      h = __fadd_rn(__fmul_rn(ds[m], h), __fmul_rn(u, sm.b[m][kk]));
      hs[m] = h;
    }
    float dacc = 0.0f;
#pragma unroll
    for (int m = T - 1; m >= 0; --m) {
      const float dv = sm.dt[m][lc], xv = sm.x[m][lc], yv = sm.dy[m][lc];
      const float u = Num<TT>::round(__fmul_rn(dv, xv));
      g = __fadd_rn(g, __fmul_rn(sm.c[m][kk], yv));
      float pc = __fmul_rn(yv, hs[m]);
      float pb = __fmul_rn(g, u);
      float pu = __fmul_rn(g, sm.b[m][kk]);
      const float hp = m > 0 ? hs[m > 0 ? m - 1 : 0] : hstart;
      const float dda = __fmul_rn(__fmul_rn(g, hp), ds[m]);
      float pt = __fmul_rn(dda, ak);
      dacc = __fadd_rn(dacc, __fmul_rn(dda, dv));
      g = __fmul_rn(ds[m], g);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {   // over the n states
        pu += __shfl_xor_sync(FULL, pu, off);
        pt += __shfl_xor_sync(FULL, pt, off);
      }
      if (kk == 0) {
        sm.dx[m][lc] = __fmul_rn(pu, dv);
        sm.ddt[m][lc] = pt + __fmul_rn(pu, xv);
      }
#pragma unroll
      for (int off = N; off < 32; off <<= 1) {      // over the warp's channels
        pb += __shfl_xor_sync(FULL, pb, off);
        pc += __shfl_xor_sync(FULL, pc, off);
      }
      if (lane < N) {
        sm.db[m][warp][kk] = pb;
        sm.dc[m][warp][kk] = pc;
      }
    }
    if (live) {
      part_da[si] = dacc;
      if (dh0 != nullptr && cidx == 0)
        dh0[(static_cast<size_t>(bi) * di + ch) * N + kk] = g;
    }
    __syncthreads();
    for (int e = tid; e < T * N; e += THREADS) {   // the warps, in order
      const int m = e / N, q = e % N;
      float sb = sm.accb[m][q], sc = sm.accc[m][q];
#pragma unroll
      for (int wv = 0; wv < WARPS; ++wv) {
        sb += sm.db[m][wv][q];
        sc += sm.dc[m][wv][q];
      }
      sm.accb[m][q] = sb;
      sm.accc[m][q] = sc;
    }
    __syncthreads();                    // before the next pass's sums
  }
  for (int e = tid; e < n * CHB; e += THREADS) {
    const int tt = e / CHB, cc = e % CHB;
    if (c0 + cc < di) {
      const size_t g = (row0 + tt) * di + c0 + cc;
      Num<TT>::store(dx + g, sm.dx[tt][cc]);
      Num<TT>::store(ddt + g, sm.ddt[tt][cc]);
    }
  }
  for (int e = tid; e < n * N; e += THREADS) {
    const int tt = e / N, q = e % N;
    const size_t o = ((row0 + tt) * groups + grp) * N + q;
    part_db[o] = sm.accb[tt][q];
    part_dc[o] = sm.accc[tt][q];
  }
}

}  // namespace chunk

// ---------------------------------------------------------- 3. reduce

constexpr int RED_THREADS = 256;

// db, dc (rows = B S, n each) over the channel groups; da (di n) over the
// (b, chunk) partials; each sum in order
template <typename TT>
__global__ void __launch_bounds__(RED_THREADS)
scan_bwd_reduce(const float* __restrict__ part_db,
              const float* __restrict__ part_dc,
              const float* __restrict__ part_da, int rows, int groups, int n,
              int bnc, int dn, TT* __restrict__ db, TT* __restrict__ dc,
              float* __restrict__ da) {
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  if (e < rows * n) {
    const int row = e / n, q = e % n;
    float sb = 0.0f, sc = 0.0f;
    for (int g = 0; g < groups; ++g) {
      const size_t o = (static_cast<size_t>(row) * groups + g) * n + q;
      sb += part_db[o];
      sc += part_dc[o];
    }
    Num<TT>::store(db + e, sb);
    Num<TT>::store(dc + e, sc);
  }
  if (e < dn) {
    float s = 0.0f;
    for (int q = 0; q < bnc; ++q) s += part_da[static_cast<size_t>(q) * dn + e];
    da[e] = s;
  }
}

template <typename TT, int N>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* dy, const void* h0,
           const void* dh_out, int batch, int seq, int di, void* hb,
           void* gb, void* part_db, void* part_dc, void* part_da, void* dx,
           void* ddt, void* db, void* dc, void* da, void* dh0,
           cudaStream_t stream) {
  const int nc = (seq + T - 1) / T;
  constexpr int CH1 = bounds::THREADS / N;
  const dim3 grid1(batch * ((di + CH1 - 1) / CH1), 2);
  bounds::scan_bwd_bounds<TT, N><<<grid1, bounds::THREADS, 0, stream>>>(
      static_cast<const TT*>(x), static_cast<const TT*>(dt),
      static_cast<const TT*>(b), static_cast<const TT*>(c),
      static_cast<const float*>(dy), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<const float*>(dh_out), seq,
      di, nc, static_cast<float*>(hb), static_cast<float*>(gb));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int groups = (di + chunk::CHB - 1) / chunk::CHB;
  constexpr auto kernel = chunk::scan_bwd_chunk<TT, N>;
  constexpr int smem = sizeof(chunk::Smem<N>);
  // above 48 KB the kernel needs an attribute, set at its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = static_cast<long long>(batch) * nc * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), chunk::THREADS, smem, stream>>>(
      static_cast<const TT*>(x), static_cast<const TT*>(dt),
      static_cast<const TT*>(b), static_cast<const TT*>(c),
      static_cast<const float*>(dy), static_cast<const float*>(a),
      static_cast<const float*>(hb), static_cast<const float*>(gb), seq, di,
      nc, groups, static_cast<TT*>(dx), static_cast<TT*>(ddt),
      static_cast<float*>(part_db), static_cast<float*>(part_dc),
      static_cast<float*>(part_da), static_cast<float*>(dh0));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = batch * seq;
  const int dn = di * N;
  const int total = rows * N > dn ? rows * N : dn;
  scan_bwd_reduce<TT><<<(total + RED_THREADS - 1) / RED_THREADS, RED_THREADS,
                      0, stream>>>(
      static_cast<const float*>(part_db), static_cast<const float*>(part_dc),
      static_cast<const float*>(part_da), rows, groups, N, batch * nc, dn,
      static_cast<TT*>(db), static_cast<TT*>(dc), static_cast<float*>(da));
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, const void*,
                       int, int, int, void*, void*, void*, void*, void*,
                       void*, void*, void*, void*, void*, void*,
                       cudaStream_t);

}  // namespace

// x, dt: (batch, seq, channels) and b, c: (batch, seq, state), float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); a: (channels, state) float32;
// dy (y's cotangent): (batch, seq, channels) float32; h0 (the initial
// state) and dh_out (the final state's cotangent): (batch, channels,
// state) float32, or null for zeros. Scratch (float32): hb, gb and part_da
// (batch, NC, channels, state), part_db and part_dc (batch, seq, groups,
// state), NC = `chunks` and groups = `groups`, which must be ceil(seq /
// T) and ceil(channels / chunk::CHB) (`selective_scan_bwd_tiles` gives
// both). Out: dx, ddt in x's dtype, (batch, seq, channels); db, dc in x's
// dtype, (batch, seq, state); da (channels, state) float32; dh0 (batch,
// channels, state) float32, or null where no initial-state gradient is
// wanted. All contiguous; seq >= 1; state 8 or 16.
extern "C" int selective_scan_bwd(const void* x, const void* dt,
                                  const void* b, const void* c,
                                  const void* a, const void* dy,
                                  const void* h0, const void* dh_out,
                                  int batch, int seq, int channels,
                                  int state, int is_bf16, int chunks,
                                  int groups, void* hb, void* gb,
                                  void* part_db, void* part_dc,
                                  void* part_da, void* dx, void* ddt,
                                  void* db, void* dc, void* da, void* dh0,
                                  void* stream) {
  if (batch == 0 || channels == 0) return 0;
  if (seq < 1 || chunks != (seq + T - 1) / T ||
      groups != (channels + chunk::CHB - 1) / chunk::CHB)
    return static_cast<int>(cudaErrorInvalidValue);
  using BF = __nv_bfloat16;
  Launch fn = nullptr;
  if (state == 16) fn = is_bf16 ? launch<BF, 16> : launch<float, 16>;
  if (state == 8) fn = is_bf16 ? launch<BF, 8> : launch<float, 8>;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(x, dt, b, c, a, dy, h0, dh_out, batch, seq, channels, hb, gb,
            part_db, part_dc, part_da, dx, ddt, db, dc, da, dh0,
            static_cast<cudaStream_t>(stream));
}

// The backward's tiles, with which the wrapper sizes its scratch: *chunk
// tokens T between two stored states, *group channels a block of the
// reverse walk. Launches nothing.
extern "C" void selective_scan_bwd_tiles(int* chunk, int* group) {
  *chunk = T;
  *group = chunk::CHB;
}
