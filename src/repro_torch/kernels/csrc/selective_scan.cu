// Mamba's selective scan (hymba's SSM heads), forward: a chunked form for
// prompts (S >= one chunk of 128 tokens) and a per-state form for short S
// (decode).
//
// Replaces no TPU kernel. The JAX package runs this recurrence as a
// `jax.lax.scan` over tokens of the cell `step` in `mamba_apply`
// (src/repro/models/ssm.py:79), which XLA compiles into one loop program.
// Eager PyTorch would run the same loop as about 8 launches a token and
// layer: about 1.05 M launches in one full-width hymba-1.5B `forward` (B 2,
// S 4096, 32 layers). So the port runs it as one kernel a layer. Per batch
// row b, channel d and state index k, with a = -exp(a_log):
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t,    y_t = sum_k c_t h_t
//
// rounded where the JAX package rounds: dt_t x_t in the compute dtype (in
// bfloat16 one rounding of the exact product), exp(dt_t a) in float32 from
// the compute-dtype dt, h and y in float32 until y is cast to x's dtype.
// `ref.selective_scan_ref` is the plain version. The D skip and the silu(z)
// gate stay outside, in `models/ssm.py`.
//
// Bound on an H100 at hymba-1.5B's forward (B 2, S 4096, di 3200, n 16,
// bf16): 2 * 4096 * 3200 * 16 = 419 M exponentials at 16 a clock per SM
// (the SFU) on 132 SMs at 1.98 GHz take ~100 us; the bytes (x, dt, b, c
// read and y written in bf16, a and the states in float32; ~158 MB) ~47 us
// at 3.35 TB/s. So the SFU bounds it.
//
// The per-state form (`state_form`), the first design: one thread per (b,
// d, k), h in a register, the n lanes of a channel in one warp, 128 / n
// channels of one batch row a block, 64-token tiles of x, dt, b and c
// staged in shared memory, y_t summed over the n lanes by __shfl_xor_sync.
// It took 856.78 us at the forward shape (NVIDIA H100 80GB HBM3, 700 W),
// 8.5x the bound, held by three things:
//   1. ~30 issued instructions a token and state where ~10 are needed:
//      every lane repeats its channel's work (two shared loads, dt x and
//      its rounding), and y costs 4 shuffles and 4 adds a token and lane;
//   2. only B di n = 102,400 threads, ~24 warps an SM, each waiting at
//      every tile's __syncthreads for its own loads;
//   3. half-sector loads: 8 bf16 channels (16 bytes) a token row.
// It stays the form for S < 128, where it is near a launch's latency
// (3.78 us at decode, B 4, S 1).
//
// The chunked form (`chunked`), after the public mamba selective-scan
// kernel (Gu & Dao, selective_scan_fwd_kernel.cuh), on the (B, S, di)
// layout. A block holds one batch row and CH = 16 channels; TPC = 8
// threads own a channel, each a run of ITEMS = 16 consecutive tokens, so a
// chunk is 128 tokens. Per chunk and state k, in a loop over k, each thread
//   * forms da_t = exp(dt_t a_k) and u_t b_t for its 16 tokens and scans
//     them locally into a pair (A, H) = (the run's decay product, its state
//     from zero), A as one exponential of a_k times the run's summed dt;
//   * composes the pairs of the channel's 8 threads by a warp scan
//     (A1, H1) o (A2, H2) = (A2 A1, A2 H1 + H2), with the carry from the
//     chunks before folded into the first thread's pair, so that each
//     thread ends with the state at the end of its run and the one before
//     it starts from;
//   * runs its 16 tokens again from that state and adds c_t[k] h_t into a
//     per-token y held in registers.
// The last thread's state is the carry into the next chunk; after the last
// chunk it is the final state. A ragged tail is zero-filled: dt 0 and x 0
// make the identity pair (decay 1, input 0). Against the three points:
//   1. dt x and its rounding are formed once a (channel, token), not once a
//      lane, and y needs no reduction across lanes: per token and state, dt
//      a, its exponential, u b, two FMAs of the state, one of y and half a
//      vector shared load for b and c; the warp scan's ~25 instructions a
//      state are shared by a thread's 16 tokens. The loop issues 143
//      instructions a state and run (its SASS), ~9 a token and state, where
//      the per-state form issued ~30;
//   2. the block's loads of the next chunk (cp.async, 16 bytes a copy) are
//      in flight while the current chunk computes; B di / 16 blocks of 128
//      threads, four resident an SM (at most 128 registers a thread, ~50 KB
//      of shared memory in bf16), 16 warps an SM where the per-state form
//      had ~24, and the states loop's 16 independent tokens are the ILP;
//   3. x and dt are staged, and y written back, by 16-byte copies of whole
//      32-byte token rows (16 bf16 channels), transposed through shared
//      memory; b and c are staged once a block and read back as float4.
// The exponentials are the SFU's ex2.approx of dt (a log2 e): the accurate
// expf took 8 instructions a token and state, and the phase 17 limits of
// chip_smoke.py hold at every shape with ex2.approx (its controls still
// failing). h's updates are explicit fmaf and __fmul_rn, in a fixed order:
// no atomics, so two calls are bitwise equal. The form needs channels a
// multiple of 8 and 16-byte aligned x, dt, b, c and y.
//
// What holds it (studies/selective_scan.py, NVIDIA H100 80GB HBM3, 700 W):
// ~293 us at the forward shape, 2.9x its SFU bound. The 400 blocks fill
// 132 SMs 3 or 4 deep, so the SMs with a fourth block set the end; there
// the loop issues at ~59% of the rate, and the exponentials and the b / c
// shared loads cost ~74 us together but ~25-30 each alone (diagnostic
// variants without them). The accurate expf's 7 more instructions a token
// and state add ~110 us; more warps (8 threads x 8 tokens) or a
// software-pipelined loop that forms the next state's exponentials among
// this state's FMAs did not take time off.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

template <typename T>
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

namespace state_form {

constexpr int THREADS = 128;
constexpr int TILE = 64;        // tokens staged a round

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ b, const T* __restrict__ c,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, int seq, int di,
                      T* __restrict__ y, float* __restrict__ h_out) {
  constexpr int CH = THREADS / N;      // channels a block
  __shared__ float sx[TILE * CH];
  __shared__ float sdt[TILE * CH];
  __shared__ float sy[TILE * CH];
  __shared__ float sb[TILE * N];
  __shared__ float sc[TILE * N];

  const int groups = (di + CH - 1) / CH;
  const int bi = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * CH;
  const int tid = threadIdx.x;
  const int lc = tid / N;              // the block's channel
  const int k = tid % N;               // state index
  const int ch = c0 + lc;
  const bool live = ch < di;
  const size_t hi = (static_cast<size_t>(bi) * di + ch) * N + k;
  const float ak = live ? a[static_cast<size_t>(ch) * N + k] : 0.0f;
  float h = (live && h0 != nullptr) ? h0[hi] : 0.0f;

  const size_t row0 = static_cast<size_t>(bi) * seq;   // token (bi, 0)
  for (int t0 = 0; t0 < seq; t0 += TILE) {
    const int nt = min(TILE, seq - t0);
    __syncthreads();                   // the previous tile's y is written
    for (int e = tid; e < nt * CH; e += THREADS) {
      const int tt = e / CH, cc = e % CH;
      float xv = 0.0f, dv = 0.0f;
      if (c0 + cc < di) {
        const size_t g = (row0 + t0 + tt) * di + c0 + cc;
        xv = Num<T>::load(x + g);
        dv = Num<T>::load(dt + g);
      }
      sx[e] = xv;
      sdt[e] = dv;
    }
    // b and c of the tile's tokens are one contiguous run of nt * N
    for (int e = tid; e < nt * N; e += THREADS) {
      const size_t g = (row0 + t0) * N + e;
      sb[e] = Num<T>::load(b + g);
      sc[e] = Num<T>::load(c + g);
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const float dv = sdt[tt * CH + lc];
      const float u = Num<T>::round(__fmul_rn(dv, sx[tt * CH + lc]));
      const float da = expf(__fmul_rn(dv, ak));
      h = __fadd_rn(__fmul_rn(da, h), __fmul_rn(u, sb[tt * N + k]));
      float p = __fmul_rn(h, sc[tt * N + k]);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (k == 0) sy[tt * CH + lc] = p;
    }
    __syncthreads();
    for (int e = tid; e < nt * CH; e += THREADS) {
      const int tt = e / CH, cc = e % CH;
      if (c0 + cc < di)
        Num<T>::store(y + (row0 + t0 + tt) * di + c0 + cc, sy[e]);
    }
  }
  if (live) h_out[hi] = h;
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* h0, int batch, int seq, int di,
           void* y, void* h_out, cudaStream_t stream) {
  constexpr int CH = THREADS / N;
  const long long blocks =
      static_cast<long long>(batch) * ((di + CH - 1) / CH);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  selective_scan_kernel<T, N>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dt),
          static_cast<const T*>(b), static_cast<const T*>(c),
          static_cast<const float*>(a), static_cast<const float*>(h0), seq,
          di, static_cast<T*>(y), static_cast<float*>(h_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace state_form

namespace chunked {

constexpr int CH = 16;                 // channels a block, one batch row
constexpr int TPC = 8;                 // threads a channel
constexpr int ITEMS = 16;              // consecutive tokens a thread
constexpr int CHUNK = TPC * ITEMS;     // tokens a chunk
constexpr int THREADS = CH * TPC;
constexpr int WARP_CH = 32 / TPC;      // channels a warp
constexpr int MIN_BLOCKS = 4;          // resident an SM: <= 128 registers
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory, in bytes: two stages of raw x, dt, b and c as
// cp.async leaves them; b and c of the current chunk as float32 [state]
// [token]; a log2(e) and the carry as [channel][state]. A stage's x and dt
// rows are CH channels, with 16 bytes after each thread's ITEMS rows, so
// that the TPC threads of a channel read them in distinct banks. y is
// written back through the current stage's x rows once x is read.
template <typename T, int N>
struct Smem {
  static constexpr int ROW = CH * static_cast<int>(sizeof(T));
  static constexpr int RUN = ITEMS * ROW + 16;      // a thread's rows
  static constexpr int X = TPC * RUN;
  static constexpr int BC = CHUNK * N * static_cast<int>(sizeof(T));
  static constexpr int DT = X, B = 2 * X, C = 2 * X + BC;
  static constexpr int STAGE = 2 * X + 2 * BC;
  static constexpr int BT = 2 * STAGE;
  static constexpr int CT = BT + N * CHUNK * 4;
  static constexpr int A = CT + N * CHUNK * 4;
  static constexpr int CARRY = A + CH * N * 4;
  static constexpr int BYTES = CARRY + CH * N * 4;
  static_assert(ROW % 16 == 0 && X % 16 == 0 && BC % 16 == 0, "16 bytes");
  // byte offset of token r's row in a stage's x (or dt, or y)
  static __device__ __forceinline__ unsigned row(unsigned r) {
    return (r / ITEMS) * RUN + (r % ITEMS) * ROW;
  }
};

__device__ __forceinline__ void cp_async16(char* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// 2^v, the SFU's approximation (MUFU.EX2), subnormal results flushed
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// fn(e) for e = threadIdx.x, + THREADS, ... below COUNT, unrolled
template <int COUNT, typename F>
__device__ __forceinline__ void block_for(F fn) {
#pragma unroll
  for (int q = 0; q < (COUNT + THREADS - 1) / THREADS; ++q) {
    const unsigned e = threadIdx.x + q * THREADS;
    if (COUNT % THREADS == 0 || e < COUNT) fn(e);
  }
}

// Issue the copies of the chunk from token t0 into stage `st`: x and dt
// rows of the block's channels, the contiguous run of b and c. Rows past
// the sequence and channels past di are zero-filled.
template <typename T, int N>
__device__ __forceinline__ void load_chunk(
    char* st, const T* x, const T* dt, const T* b, const T* c, size_t row0,
    int t0, int seq, int di, int c0) {
  using S = Smem<T, N>;
  constexpr unsigned XP = S::ROW / 16;                     // copies a row
  constexpr unsigned EP = 16 / static_cast<unsigned>(sizeof(T));
  const unsigned nt = min(CHUNK, seq - t0);
  block_for<CHUNK * XP>([&](unsigned e) {
    const unsigned r = e / XP, p = e % XP;
    const bool ok = r < nt && c0 + static_cast<int>(p * EP) < di;
    const size_t g = ok ? (row0 + t0 + r) * di + c0 + p * EP : 0;
    const unsigned off = S::row(r) + p * 16;
    cp_async16(st + off, x + g, ok ? 16 : 0);
    cp_async16(st + S::DT + off, dt + g, ok ? 16 : 0);
  });
  const unsigned valid = nt * N * sizeof(T);
  const char* bg = reinterpret_cast<const char*>(b + (row0 + t0) * N);
  const char* cg = reinterpret_cast<const char*>(c + (row0 + t0) * N);
  block_for<S::BC / 16>([&](unsigned e) {
    const bool ok = e * 16 < valid;
    cp_async16(st + S::B + e * 16, ok ? bg + e * 16 : bg, ok ? 16 : 0);
    cp_async16(st + S::C + e * 16, ok ? cg + e * 16 : cg, ok ? 16 : 0);
  });
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// N values of type T (16-byte aligned in shared memory) as float32
template <typename T, int N>
__device__ __forceinline__ void row_to_float(const char* src,
                                             float (&v)[N]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(src)[q];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        v[q * 8 + 2 * e] = f.x;
        v[q * 8 + 2 * e + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(src)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
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

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
chunked_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const T* __restrict__ b, const T* __restrict__ c,
               const float* __restrict__ a, const float* __restrict__ h0,
               int seq, int di, T* __restrict__ y,
               float* __restrict__ h_out) {
  using S = Smem<T, N>;
  constexpr unsigned XP = S::ROW / 16;
  constexpr unsigned EP = 16 / static_cast<unsigned>(sizeof(T));
  extern __shared__ __align__(16) char smem[];
  float* bt = reinterpret_cast<float*>(smem + S::BT);       // [N][CHUNK]
  float* ct = reinterpret_cast<float*>(smem + S::CT);
  float* sa = reinterpret_cast<float*>(smem + S::A);        // [CH][N]
  float* carry = reinterpret_cast<float*>(smem + S::CARRY);

  const int groups = (di + CH - 1) / CH;
  const int bi = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * CH;
  const unsigned tid = threadIdx.x;
  const unsigned lane = tid % 32;
  const unsigned j = lane / WARP_CH;                 // the thread's run
  const unsigned lc = (tid / 32) * WARP_CH + lane % WARP_CH;  // channel
  const size_t row0 = static_cast<size_t>(bi) * seq;
  const unsigned mine = j * S::RUN + lc * sizeof(T);  // its x, dt, y rows

  block_for<CH * N>([&](unsigned e) {
    const int ch = c0 + static_cast<int>(e / N);
    const bool live = ch < di;
    sa[e] = live ? __fmul_rn(a[static_cast<size_t>(ch) * N + e % N], LOG2E)
                 : 0.0f;
    carry[e] = (live && h0 != nullptr)
                   ? h0[(static_cast<size_t>(bi) * di + ch) * N + e % N]
                   : 0.0f;
  });
  const int chunks = (seq + CHUNK - 1) / CHUNK;
  load_chunk<T, N>(smem, x, dt, b, c, row0, 0, seq, di, c0);
  for (int ci = 0; ci < chunks; ++ci) {
    char* st = smem + (ci & 1) * S::STAGE;
    const int t0 = ci * CHUNK;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();       // the chunk has landed; the other stage is free
    if (ci + 1 < chunks)
      load_chunk<T, N>(smem + ((ci + 1) & 1) * S::STAGE, x, dt, b, c, row0,
                       t0 + CHUNK, seq, di, c0);
    block_for<CHUNK>([&](unsigned r) {
      // b and c of token r into [state][token] float32
      float v[N];
      row_to_float<T, N>(st + S::B + r * N * sizeof(T), v);
#pragma unroll
      for (int k = 0; k < N; ++k) bt[k * CHUNK + r] = v[k];
      row_to_float<T, N>(st + S::C + r * N * sizeof(T), v);
#pragma unroll
      for (int k = 0; k < N; ++k) ct[k * CHUNK + r] = v[k];
    });
    // the thread's dt, dt x (rounded to T) and the run's summed dt
    float dv[ITEMS], u[ITEMS], yv[ITEMS];
    float sdt = 0.0f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const char* r = st + mine + i * S::ROW;
      dv[i] = Num<T>::load(reinterpret_cast<const T*>(r + S::DT));
      u[i] = Num<T>::round(
          __fmul_rn(dv[i], Num<T>::load(reinterpret_cast<const T*>(r))));
      sdt = __fadd_rn(sdt, dv[i]);
      yv[i] = 0.0f;
    }
    __syncthreads();       // b and c transposed; x and dt read
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      const float ak = sa[lc * N + k];               // a_k log2(e)
      float da[ITEMS], ub[ITEMS], bc[ITEMS];
      load_items(bt + k * CHUNK + j * ITEMS, bc);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        da[i] = ex2(__fmul_rn(dv[i], ak));
        ub[i] = __fmul_rn(u[i], bc[i]);
      }
      // the run's pair from a zero state: the decay product is one
      // exponential of a_k times the run's summed dt
      float pa = ex2(__fmul_rn(sdt, ak)), ph = ub[0];
#pragma unroll
      for (int i = 1; i < ITEMS; ++i) ph = fmaf(da[i], ph, ub[i]);
      // the carry into the first run; then the channel's inclusive scan
      const float cin = j == 0 ? carry[lc * N + k] : 0.0f;
      if (j == 0) ph = fmaf(pa, cin, ph);
#pragma unroll
      for (int d = 1; d < TPC; d <<= 1) {
        const float ua = __shfl_up_sync(FULL, pa, d * WARP_CH);
        const float uh = __shfl_up_sync(FULL, ph, d * WARP_CH);
        if (j >= d) {
          ph = fmaf(pa, uh, ph);
          pa = __fmul_rn(pa, ua);
        }
      }
      // ph: the state at the end of the run; h: the one before it
      float h = __shfl_up_sync(FULL, ph, WARP_CH);
      if (j == 0) h = cin;
      if (j == TPC - 1) carry[lc * N + k] = ph;
      load_items(ct + k * CHUNK + j * ITEMS, bc);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        h = fmaf(da[i], h, ub[i]);
        yv[i] = fmaf(bc[i], h, yv[i]);
      }
    }
    // y through the stage's x rows, then out in 16-byte copies
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      Num<T>::store(reinterpret_cast<T*>(st + mine + i * S::ROW), yv[i]);
    __syncthreads();
    const unsigned nt = min(CHUNK, seq - t0);
    block_for<CHUNK * XP>([&](unsigned e) {
      const unsigned r = e / XP, p = e % XP;
      if (r < nt && c0 + static_cast<int>(p * EP) < di)
        *reinterpret_cast<uint4*>(y + (row0 + t0 + r) * di + c0 + p * EP) =
            *reinterpret_cast<const uint4*>(st + S::row(r) + p * 16);
    });
  }
  __syncthreads();         // the last chunk's carries are written
  block_for<CH * N>([&](unsigned e) {
    const int ch = c0 + static_cast<int>(e / N);
    if (ch < di)
      h_out[(static_cast<size_t>(bi) * di + ch) * N + e % N] = carry[e];
  });
}

// Above 48 KB the kernel needs an attribute, set at its first launch (the
// port drives one card a process), and the largest shared-memory carveout,
// so that four blocks fit an SM.
template <typename T, int N>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        chunked_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<T, N>::BYTES);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        chunked_kernel<T, N>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

// blocks of the kernel resident an SM, as the runtime computes them
template <typename T, int N>
int resident() {
  int blocks = 0;
  if (prepare<T, N>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, chunked_kernel<T, N>, THREADS, Smem<T, N>::BYTES) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const void* a, const void* h0, int batch, int seq, int di,
           void* y, void* h_out, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (di % 8 != 0 || !aligned(x) || !aligned(dt) || !aligned(b) ||
      !aligned(c) || !aligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(batch) * ((di + CH - 1) / CH);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel = chunked_kernel<T, N>;
  constexpr int smem = Smem<T, N>::BYTES;
  const cudaError_t attr = prepare<T, N>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0), seq, di,
      static_cast<T*>(y), static_cast<float*>(h_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, int, int, int, void*, void*,
                       cudaStream_t);

template <typename T, int N>
Launch pick(int form) {
  return form ? chunked::launch<T, N> : state_form::launch<T, N>;
}

}  // namespace

// x, dt: (batch, seq, channels) and b, c: (batch, seq, state), float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); a: (channels, state) float32;
// h0: (batch, channels, state) float32, or null for a zero state; y:
// (batch, seq, channels) in x's dtype; h_out: (batch, channels, state)
// float32. All contiguous; seq >= 1; state 8 or 16. form 0: the per-state
// kernel; form 1: the chunked one (channels a multiple of 8, x, dt, b, c
// and y 16-byte aligned).
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* b, const void* c,
                                  const void* a, const void* h0, int batch,
                                  int seq, int channels, int state,
                                  int is_bf16, int form, void* y,
                                  void* h_out, void* stream) {
  if (batch == 0 || channels == 0) return 0;
  if (seq < 1 || (form != 0 && form != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  using BF = __nv_bfloat16;
  Launch fn = nullptr;
  if (state == 16) fn = is_bf16 ? pick<BF, 16>(form) : pick<float, 16>(form);
  if (state == 8) fn = is_bf16 ? pick<BF, 8>(form) : pick<float, 8>(form);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(x, dt, b, c, a, h0, batch, seq, channels, y, h_out,
            static_cast<cudaStream_t>(stream));
}

// Blocks of the chunked form resident an SM for state 8 or 16 and float32
// (is_bf16 = 0) or bfloat16, or -1.
extern "C" int selective_scan_chunked_resident(int state, int is_bf16) {
  using BF = __nv_bfloat16;
  if (state == 16)
    return is_bf16 ? chunked::resident<BF, 16>()
                   : chunked::resident<float, 16>();
  if (state == 8)
    return is_bf16 ? chunked::resident<BF, 8>()
                   : chunked::resident<float, 8>();
  return -1;
}
