// Mamba's selective scan (hymba's SSM heads), forward.
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
// Design (a first, simple one): one thread per (b, d, k), h in a register,
// the N = n lanes of a channel in one warp, THREADS / N channels of one
// batch row a block. The block stages TILE tokens of its channels' x and dt
// and of b and c in shared memory as float32; the lanes loop over the tile;
// y_t is summed over a channel's N lanes by __shfl_xor_sync into shared
// memory and written out for the whole tile at once. h's update is two
// products and a sum each rounded (__fmul_rn, __fadd_rn, no contraction),
// as the plain version forms it. Parallelism is only B * di * n threads
// (102,400 at B 2); cutting S into chunks (a two-pass scan) is later work.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 64;        // tokens staged a round

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

}  // namespace

// x, dt: (batch, seq, channels) and b, c: (batch, seq, state), float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); a: (channels, state) float32;
// h0: (batch, channels, state) float32, or null for a zero state; y:
// (batch, seq, channels) in x's dtype; h_out: (batch, channels, state)
// float32. All contiguous; seq >= 1; state 8 or 16.
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* b, const void* c,
                                  const void* a, const void* h0, int batch,
                                  int seq, int channels, int state,
                                  int is_bf16, void* y, void* h_out,
                                  void* stream) {
  if (batch == 0 || channels == 0) return 0;
  if (seq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (state == 16)
    return is_bf16 ? launch<BF, 16>(x, dt, b, c, a, h0, batch, seq,
                                    channels, y, h_out, s)
                   : launch<float, 16>(x, dt, b, c, a, h0, batch, seq,
                                       channels, y, h_out, s);
  if (state == 8)
    return is_bf16 ? launch<BF, 8>(x, dt, b, c, a, h0, batch, seq,
                                   channels, y, h_out, s)
                   : launch<float, 8>(x, dt, b, c, a, h0, batch, seq,
                                      channels, y, h_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
