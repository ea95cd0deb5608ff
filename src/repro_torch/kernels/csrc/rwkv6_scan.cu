// RWKV6 (Finch) WKV recurrence with state carry, forward.
//
// Replaces the TPU kernel `_wkv_kernel` of src/repro/kernels/rwkv6_scan.py
// (entry `rwkv6_chunked`). For any S >= 1, per (batch b, head h), with the
// head dim Dk = Dv = 64:
//
//   o_t = r_t^T S_{t-1} + (r_t . (u (.) k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// which is `rwkv6_ref`'s o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T) with the
// bonus term's scalar r_t . (u (.) k_t) taken once per token. The state
// starts from `s0` (or zeros) and the final state is written out of place.
// r, k, v, w and o are in the model's (B, S, H, 64) layout, as the linears
// produce them, so the caller makes no head-major copies.
//
// Design: the TPU kernel turns the recurrence into (C, C) matmuls per chunk
// so its matrix unit has work; here the token loop stays sequential, which
// is exactly the scan's math and has no exponent-range limit. One block of
// 256 threads per (b, h); thread (j, q) owns column j of the 64 x 64 state
// and its rows [16q, 16q + 16), in registers. Every TILE tokens the block
// stages r, k, w (float32, each row padded so the four row groups of a warp
// hit distinct banks) and v in shared memory, and one warp per token forms
// the bonus scalar. Per token and thread: 16 multiplies and 32 fused
// multiply-adds, then a two-step shuffle sums the four row groups' partial
// outputs. No atomics: the result does not depend on scheduling. The next
// tile's loads are issued into registers before the current tile's token
// loop, so device-memory latency is paid once per call, not once per tile.
// (One thread per column with all 64 rows would leave 2 warps per SM; four
// row groups give each SM 8. Eight row groups of 8 rows, 512 threads, ran
// 23% slower on the H100; a third dependent shuffle per token is the likely
// cost, unconfirmed without a kernel profiler.)
//
// Bound on an H100: at the prompt-scoring shape (B 4, H 32, S 2048) the
// arithmetic, 5 float32 operations per state element per token (5.4 GFLOP,
// 80 us at 67 TFLOP/s), is above the bytes (205 MB, 61 us at 3.35 TB/s).
// The design does three instructions per state element per token, all in
// registers, and reads every input once; with 128 (b, h) blocks it fills
// one block per SM. Measured, it runs at about 7x that bound, ~470 cycles
// per token against ~150 of issue: the token loop most likely waits on its
// own latency (shared loads, the accumulate chain, two dependent shuffles)
// with 2 warps per scheduler. The chunked tensor-core
// form of the TPU kernel is the way past it (it must keep a guard for the
// |log w| * chunk range limit that the sequential form does not have).
// At decode (S 1) the 4 MB state read and write dominates.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int D = 64;                 // head dim (Dk = Dv)
constexpr int KSPLIT = 4;             // row groups per state column
constexpr int ROWS = D / KSPLIT;      // 16 state rows per thread
constexpr int THREADS = D * KSPLIT;   // 256
constexpr int TILE = 32;              // tokens staged per round
constexpr int PAD_ROW = ROWS + 4;     // 20: row groups start on distinct banks
constexpr int STRIDE = KSPLIT * PAD_ROW;  // 80 floats per staged token
constexpr int PER = TILE * D / THREADS;   // 8 elements per thread per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
wkv_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
           const TI* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           int heads, int seq, TO* __restrict__ o,
           float* __restrict__ s_out) {
  __shared__ __align__(16) float sr[TILE * STRIDE];
  __shared__ __align__(16) float sk[TILE * STRIDE];
  __shared__ __align__(16) float sw[TILE * STRIDE];
  __shared__ float sv[TILE * D];
  __shared__ float su[D];
  __shared__ float sbonus[TILE];

  const int bh = blockIdx.x;             // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x;
  const int j = tid / KSPLIT;            // state column (v index)
  const int q = tid % KSPLIT;            // row group
  const int lane = tid % 32;
  const int warp = tid / 32;

  if (tid < D) su[tid] = u[h * D + tid];

  float st[ROWS];
  const size_t sbase = static_cast<size_t>(bh) * D * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    st[i] = s0 ? s0[sbase + (q * ROWS + i) * D + j] : 0.0f;

  // Tile staging, software-pipelined: each thread holds its PER elements
  // of the next tile of r, k, v, w in registers, loaded while the block
  // works through the current tile, so the device-memory latency of a
  // tile is paid once per call and not once per tile. Token t of (b, h)
  // starts at base + t * tstride.
  const size_t tstride = static_cast<size_t>(heads) * D;
  const size_t base = (static_cast<size_t>(b) * seq * heads + h) * D;
  TI rn[PER], kn[PER], vn[PER];
  float wn[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS;
    if (e < min(TILE, seq) * D) {
      const size_t g = base + (e / D) * tstride + e % D;
      rn[m] = r[g]; kn[m] = k[g]; vn[m] = v[g]; wn[m] = w[g];
    }
  }
  for (int t0 = 0; t0 < seq; t0 += TILE) {
    const int n = min(TILE, seq - t0);
    __syncthreads();                     // the previous tile is consumed
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + m * THREADS;
      if (e < n * D) {
        const int tt = e / D, c = e % D;
        const int s = tt * STRIDE + (c / ROWS) * PAD_ROW + c % ROWS;
        sr[s] = to_f32(rn[m]);
        sk[s] = to_f32(kn[m]);
        sw[s] = wn[m];
        sv[tt * D + c] = to_f32(vn[m]);
      }
    }
    const int t1 = t0 + TILE;            // prefetch the next tile
    const int n1 = min(TILE, seq - t1);
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + m * THREADS;
      if (e < n1 * D) {
        const size_t g = base + (t1 + e / D) * tstride + e % D;
        rn[m] = r[g]; kn[m] = k[g]; vn[m] = v[g]; wn[m] = w[g];
      }
    }
    __syncthreads();
    for (int tt = warp; tt < n; tt += THREADS / 32) {
      float part = 0.0f;
#pragma unroll
      for (int c = lane; c < D; c += 32) {
        const int s = tt * STRIDE + (c / ROWS) * PAD_ROW + c % ROWS;
        part += sr[s] * su[c] * sk[s];
      }
      part = warp_sum(part);
      if (lane == 0) sbonus[tt] = part;
    }
    __syncthreads();

#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt * D + j];
      const float4* r4 =
          reinterpret_cast<const float4*>(sr + tt * STRIDE + q * PAD_ROW);
      const float4* k4 =
          reinterpret_cast<const float4*>(sk + tt * STRIDE + q * PAD_ROW);
      const float4* w4 =
          reinterpret_cast<const float4*>(sw + tt * STRIDE + q * PAD_ROW);
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
      for (int m = 0; m < ROWS / 4; ++m) {
        const float4 rv = r4[m], kv = k4[m], wv = w4[m];
        acc0 = fmaf(rv.x, st[4 * m], acc0);
        acc1 = fmaf(rv.y, st[4 * m + 1], acc1);
        acc0 = fmaf(rv.z, st[4 * m + 2], acc0);
        acc1 = fmaf(rv.w, st[4 * m + 3], acc1);
        st[4 * m] = fmaf(wv.x, st[4 * m], kv.x * vj);
        st[4 * m + 1] = fmaf(wv.y, st[4 * m + 1], kv.y * vj);
        st[4 * m + 2] = fmaf(wv.z, st[4 * m + 2], kv.z * vj);
        st[4 * m + 3] = fmaf(wv.w, st[4 * m + 3], kv.w * vj);
      }
      float acc = acc0 + acc1;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0)
        store_f32(o + base + (t0 + tt) * tstride + j,
                  acc + sbonus[tt] * vj);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) s_out[sbase + (q * ROWS + i) * D + j] = st[i];
}

template <typename TI, typename TO>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, int bh, int heads, int seq,
           void* o, void* s_out, cudaStream_t stream) {
  wkv_kernel<TI, TO><<<bh, THREADS, 0, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0), heads,
      seq, static_cast<TO*>(o), static_cast<float*>(s_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, 64) float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1);
// w: (B, S, H, 64) float32; u: (H, 64) float32; s0: (B, H, 64, 64) float32
// or null for a zero state; o: (B, S, H, 64) float32 (out_bf16 = 0) or
// bfloat16 (out_bf16 = 1, only with in_bf16 = 1); s_out: (B, H, 64, 64)
// float32. All contiguous; seq >= 1.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         int batch, int heads, int seq, int in_bf16,
                         int out_bf16, void* o, void* s_out, void* stream) {
  const int bh = batch * heads;
  if (bh == 0) return 0;
  if (seq < 1 || (out_bf16 && !in_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16)
    return launch<float, float>(r, k, v, w, u, s0, bh, heads, seq, o, s_out,
                                st);
  if (!out_bf16)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, bh, heads, seq, o,
                                        s_out, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, bh, heads,
                                              seq, o, s_out, st);
}
