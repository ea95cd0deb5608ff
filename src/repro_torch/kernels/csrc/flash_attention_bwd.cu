// Causal / sliding-window flash attention, backward: dq, dk, dv.
//
// Replaces no TPU kernel. The JAX package differentiates its LM attention
// as XLA (`chunked_attention`, src/repro/models/layers.py:173; the TPU
// flash kernel `_fa_kernel` has no backward), but the port's forward is
// the hand-written kernel of `flash_attention.cu`, so its gradient needs
// a kernel beside it: FlashAttention-2's backward, in float32.
//
// With P_ij = exp(scale q_i . k_j - lse_i) over the keys the forward lets
// row i see (j <= i causal, i - window < j, j < Sk) and 0 elsewhere,
// lse from the forward, and D_i = dO_i . O_i:
//
//   dV_j = sum_i P_ij dO_i,   dS_ij = P_ij (dO_i . v_j - D_i),
//   dK_j = scale sum_i dS_ij q_i,   dQ_i = scale sum_j dS_ij k_j,
//
// where the sums over i run over every query head of k_j's KV group (GQA:
// dk and dv come back per KV head). Three launches on the caller's stream:
//   1. `bwd_delta`: D, one warp a (batch, row, head);
//   2. `bwd_dkdv`: a block per (key tile, KV head, batch row) holds its K
//      and V tiles and the dK and dV accumulators, and walks the query
//      heads of the group and, for each, the query tiles that see a key
//      of the tile, in a fixed order;
//   3. `bwd_dq`: a block per (query tile, head, batch row) holds its Q and
//      dO tiles and the dQ accumulator, and walks the key tiles its rows
//      see, in order.
// Both recompute S and dP = dO V^T tile by tile; no atomics, so two calls
// agree bit for bit. Two forms of the last two steps:
//   * bf16 at D 32, 64 and 128 (StarCoder2-3B, OLMoE-1B-7B, hymba, the
//     REDUCED configs): `bwd_dkdv_tc` / `bwd_dq_tc`, every product on the
//     tensor cores (`mma.sync`, bf16 in, float32 sums), P and dS entering
//     theirs as bf16 hi + lo parts (see the section below);
//   * float32, and bf16 at D 256 (Gemma-7B): `bwd_dkdv` / `bwd_dq` on
//     the CUDA cores. Every tile lives in shared memory as float32 (bf16
//     inputs widened on the way in), rows padded to an odd stride so the
//     16 rows a half warp reads fall in 16 banks; each of 256 threads owns
//     a 4 x 4 (rows x keys) patch of S and dP and 4 (or 2) x NC patches of
//     the accumulators, all in float32 FMA. Tiles: 64 queries x 64 keys to
//     D 128 (165,888 bytes of shared memory at D 128), 64 x 32 at D 256
//     (214,784 of the 232,448 a block may have).
//
// Bound on an H100 at StarCoder2-3B's training shape (B 1, S 8192, H 24,
// Hkv 2, D 128, window 4096): 25.2 M (query, key) pairs a head; the
// function's work is 2.5x the forward's 4 D FLOP a pair, 0.77 TFLOP at
// 989 TFLOP/s of dense bf16 = 0.78 ms, against 219 MB of inputs and
// outputs (65 us at 3.35 TB/s): operations. The CUDA-core form runs 14 D
// float32 FMA a pair (S and dP twice, dV, dK, dQ), at most 67 TFLOP/s:
// 1.08 T FMA, 32 ms at that peak (88.56 ms as it ran, on an H100 at 700
// W). The tensor-core form runs 20 D products a pair (S, dP twice; dV,
// dK, dQ twice each, hi and lo) on `mma.sync`, a form below `wgmma`'s
// rate; `wgmma` and a warp-specialised pipeline, as in the forward, are
// later work.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int MAX_SMEM = 232448;
// the CUDA-core form's tiles: CC_BQ queries by cc_block_kv(NC) keys at
// head dims up to NC * 16 (nc_of), for shared memory at D 256
constexpr int CC_BQ = 64;
__host__ __device__ constexpr int cc_block_kv(int nc) {
  return nc > 8 ? 32 : 64;
}
constexpr int nc_of(int d) {
  return d <= 32 ? 2 : d <= 64 ? 4 : d <= 128 ? 8 : 16;
}
// whether the tensor-core form takes a call: bf16 at D 32, 64 and 128
constexpr bool takes_tc(int is_bf16, int d) {
  return is_bf16 && (d == 32 || d == 64 || d == 128);
}

struct Params {
  int seq, seq_k, heads, kv_heads, causal, window, d;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  return row < p.seq && key < p.seq_k && (!p.causal || key <= row) &&
         (p.window <= 0 || key > row - p.window);
}

// D[b, h, i] = dO[b, i, h, :] . O[b, i, h, :]; one warp a row of the
// (B, Sq, H) layout
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, int rows, Params p) {
  const int r = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t off = static_cast<size_t>(r) * p.d;
  float s = 0.0f;
  for (int c = lane; c < p.d; c += 32)
    s = fmaf(to_f(dout[off + c]), to_f(o[off + c]), s);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = r % p.heads, i = (r / p.heads) % p.seq;
    const int b = r / (p.heads * p.seq);
    delta[(static_cast<size_t>(b) * p.heads + h) * p.seq + i] = s;
  }
}

// `rows` rows from row r0 of g (row stride gld elements, d columns) into
// s as float32 (row stride ld), zeros from row lim on
template <typename T>
__device__ __forceinline__ void stage(float* s, int ld, const T* g,
                                      size_t gld, int r0, int lim, int rows,
                                      int d) {
  for (int e = threadIdx.x; e < rows * d; e += THREADS) {
    const int row = e / d, col = e - row * d;
    s[row * ld + col] =
        r0 + row < lim ? to_f(g[static_cast<size_t>(r0 + row) * gld + col])
                       : 0.0f;
  }
}

// The tile's P and dS (BQ x BK, row stride BK + 1) from the staged Q, dO
// (BQ rows) and K, V (BK rows) and the rows' lse and D: thread (ty, tx)
// computes rows ty + 16 r and keys tx + 16 c
template <int BQ, int BK>
__device__ __forceinline__ void p_and_ds(const Params& p, const float* qs,
                                         const float* dos, const float* ks,
                                         const float* vs, const float* ls,
                                         const float* dls, float* ps,
                                         float* dss, int ld, int q0, int k0) {
  constexpr int RQ = BQ / 16, RK = BK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RQ][RK] = {}, dp[RQ][RK] = {};
#pragma unroll 2
  for (int dd = 0; dd < p.d; ++dd) {
    float qv[RQ], ov[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      qv[r] = qs[(ty + 16 * r) * ld + dd];
      ov[r] = dos[(ty + 16 * r) * ld + dd];
    }
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      const float kv = ks[(tx + 16 * c) * ld + dd];
      const float vv = vs[(tx + 16 * c) * ld + dd];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        s[r][c] = fmaf(qv[r], kv, s[r][c]);
        dp[r][c] = fmaf(ov[r], vv, dp[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      const int j = tx + 16 * c;
      const float pij = visible(p, q0 + i, k0 + j)
                            ? expf(s[r][c] * p.scale - ls[i])
                            : 0.0f;
      ps[i * (BK + 1) + j] = pij;
      dss[i * (BK + 1) + j] = pij * (dp[r][c] - dls[i]);
    }
  }
}

// floats of shared memory: Q, dO (BQ rows), K, V (BK rows), P, dS, lse, D
template <int BQ, int BK>
__host__ __device__ constexpr int smem_floats(int ld) {
  return 2 * (BQ + BK) * ld + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int BQ, int BK, int NC>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int RK = BK / 16;
  extern __shared__ float sm[];
  const int d = p.d, ld = d | 1;
  float* qs = sm;
  float* dos = qs + BQ * ld;
  float* ks = dos + BQ * ld;
  float* vs = ks + BK * ld;
  float* ps = vs + BK * ld;
  float* dss = ps + BQ * (BK + 1);
  float* ls = dss + BQ * (BK + 1);
  float* dls = ls + BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // the first key tiles see the most queries: they start first
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * d;
  const size_t q_ld = static_cast<size_t>(p.heads) * d;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * d;
  stage(ks, ld, k + kv_off, kv_ld, k0, p.seq_k, BK, d);
  stage(vs, ld, v + kv_off, kv_ld, k0, p.seq_k, BK, d);

  // the query rows that see a key of the tile: [i_lo, i_hi)
  const int i_lo = p.causal ? k0 : 0;
  const int i_hi =
      p.window > 0 ? min(p.seq, k0 + BK - 1 + p.window) : p.seq;
  const int t_lo = i_lo / BQ, t_hi = (i_hi + BQ - 1) / BQ;

  float acc_k[RK][NC] = {}, acc_v[RK][NC] = {};
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t q_off = (static_cast<size_t>(b) * p.seq * p.heads + h) * d;
    const size_t row_off = (static_cast<size_t>(b) * p.heads + h) * p.seq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the last tile's readers are done
      stage(qs, ld, q + q_off, q_ld, q0, p.seq, BQ, d);
      stage(dos, ld, dout + q_off, q_ld, q0, p.seq, BQ, d);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool ok = q0 + i < p.seq;
        ls[i] = ok ? lse[row_off + q0 + i] : 0.0f;
        dls[i] = ok ? delta[row_off + q0 + i] : 0.0f;
      }
      __syncthreads();
      p_and_ds<BQ, BK>(p, qs, dos, ks, vs, ls, dls, ps, dss, ld, q0, k0);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ty + 16 r, columns tx + 16 c
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[RK], sv[RK];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          pv[r] = ps[i * (BK + 1) + ty + 16 * r];
          sv[r] = dss[i * (BK + 1) + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx + 16 * c;
          if (col < d) {
            const float o = dos[i * ld + col], x = qs[i * ld + col];
#pragma unroll
            for (int r = 0; r < RK; ++r) {
              acc_v[r][c] = fmaf(pv[r], o, acc_v[r][c]);
              acc_k[r][c] = fmaf(sv[r], x, acc_k[r][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int key = k0 + ty + 16 * r;
    if (key >= p.seq_k) continue;
    const size_t off = kv_off + static_cast<size_t>(key) * kv_ld;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[off + col] = from_f<T>(acc_k[r][c] * p.scale);
        dv[off + col] = from_f<T>(acc_v[r][c]);
      }
    }
  }
}

template <typename T, int BQ, int BK, int NC>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, Params p) {
  constexpr int RQ = BQ / 16;
  extern __shared__ float sm[];
  const int d = p.d, ld = d | 1;
  float* qs = sm;
  float* dos = qs + BQ * ld;
  float* ks = dos + BQ * ld;
  float* vs = ks + BK * ld;
  float* ps = vs + BK * ld;
  float* dss = ps + BQ * (BK + 1);
  float* ls = dss + BQ * (BK + 1);
  float* dls = ls + BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // causal: the last query tiles see the most keys, and start first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * d;
  const size_t q_ld = static_cast<size_t>(p.heads) * d;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * d;
  const size_t q_off = (static_cast<size_t>(b) * p.seq * p.heads + h) * d;
  const size_t row_off = (static_cast<size_t>(b) * p.heads + h) * p.seq;
  stage(qs, ld, q + q_off, q_ld, q0, p.seq, BQ, d);
  stage(dos, ld, dout + q_off, q_ld, q0, p.seq, BQ, d);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool ok = q0 + i < p.seq;
    ls[i] = ok ? lse[row_off + q0 + i] : 0.0f;
    dls[i] = ok ? delta[row_off + q0 + i] : 0.0f;
  }

  // the key tiles the rows see
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(q0 + BQ, p.seq_k) : p.seq_k;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  float acc[RQ][NC] = {};
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's readers are done
    stage(ks, ld, k + kv_off, kv_ld, k0, p.seq_k, BK, d);
    stage(vs, ld, v + kv_off, kv_ld, k0, p.seq_k, BK, d);
    __syncthreads();
    p_and_ds<BQ, BK>(p, qs, dos, ks, vs, ls, dls, ps, dss, ld, q0, k0);
    __syncthreads();
    // dQ += dS K: rows ty + 16 r, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float sv[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) sv[r] = dss[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float x = ks[j * ld + col];
#pragma unroll
          for (int r = 0; r < RQ; ++r) acc[r][c] = fmaf(sv[r], x, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= p.seq) continue;
    const size_t off = q_off + static_cast<size_t>(row) * q_ld;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dq[off + col] = from_f<T>(acc[r][c] * p.scale);
    }
  }
}

// ------------------------------------------ bf16 on the tensor cores

// The bf16 kernels at D 32, 64 and 128: the same two walks as above, with
// every product on `mma.sync` m16n8k16 (bf16 in, float32 sums). A block
// is four warps (16 keys or queries a warp: 64-row tiles; the dK / dV
// walk takes its queries 32 at a time, for registers),
// staged as bf16 by 16-byte `cp.async` in rows padded by 16 bytes (so the
// eight rows an `ldmatrix` reads fall in eight bank groups), the next
// tile in flight while the block works on this one. The products whose A
// operand is a float32 tile of P or dS (dV, dK, dQ) take it as two bf16
// parts, hi + lo (two products), so P and dS keep ~2^-17 of their value,
// as in the forward; those of the inputs (S, dP) are exact products.
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t; A (16 x 16)
// a0..7 at rows g, g + 8 and columns 2t, 2t + 1, 2t + 8, 2t + 9; B (16 x
// 8) at rows 2t, 2t + 1, 2t + 8, 2t + 9 and column g; C (16 x 8) at rows
// g, g + 8 and columns 2t, 2t + 1. A C tile of P becomes, pair by pair,
// the A fragment of the next product (`split_a`).
constexpr int TC_THREADS = 128;
constexpr int TC_ROWS = 64;    // keys of a dK / dV block, queries of dQ's
constexpr int TC_QROWS = 32;   // queries a step of the dK / dV walk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a b, m16n8k16, bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// (a, b) = hi + lo, each a packed bf16 pair
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(a - __low2float(h), b - __high2float(h));
}
// the A fragments (hi, lo) of 16 columns [16 kk, 16 kk + 16) of a 16-row
// float32 C tile held as n8 tiles c[2 kk], c[2 kk + 1]
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// ROWS rows from row r0 of g (row stride gld elements, D columns) into
// shared memory at s (row stride D + 8), zero-filled from row lim on; one
// cp.async group is left to the caller to commit
template <int D, int ROWS>
__device__ __forceinline__ void stage_tc(uint32_t s, const __nv_bfloat16* g,
                                         size_t gld, int r0, int lim) {
  constexpr int CH = D / 8, LD = D + 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += TC_THREADS) {
    const int row = e / CH, c = e % CH;
    const bool ok = r0 + row < lim;
    const __nv_bfloat16* src =
        g + static_cast<size_t>(ok ? r0 + row : 0) * gld + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     s + (row * LD + c * 8) * 2),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc_a (16 x NR) += A_w B^T and acc_b += C_w E^T over D: A_w, C_w the
// warp's 16 rows of two staged tiles a, c (row-major, row stride LD), B,
// E the NR rows of tiles b, e (so the products' columns are their rows)
template <int D, int NR>
__device__ __forceinline__ void two_products(float (&acc_a)[NR / 8][4],
                                             float (&acc_b)[NR / 8][4],
                                             uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t e,
                                             int warp, int lane) {
  constexpr int LD = D + 8;
  const int ar = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
  const int br = lane % 8 + 8 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4], fc[4];
    const int ac = 16 * kk + 8 * (lane / 16);
    ldsm_x4(fa, a + (ar * LD + ac) * 2);
    ldsm_x4(fc, c + (ar * LD + ac) * 2);
    const int bc = 16 * kk + 8 * ((lane / 8) % 2);
#pragma unroll
    for (int jj = 0; jj < NR / 16; ++jj) {
      uint32_t fb[4], fe[4];
      ldsm_x4(fb, b + ((16 * jj + br) * LD + bc) * 2);
      ldsm_x4(fe, e + ((16 * jj + br) * LD + bc) * 2);
      mma_bf16(acc_a[2 * jj], fa, fb[0], fb[1]);
      mma_bf16(acc_a[2 * jj + 1], fa, fb[2], fb[3]);
      mma_bf16(acc_b[2 * jj], fc, fe[0], fe[1]);
      mma_bf16(acc_b[2 * jj + 1], fc, fe[2], fe[3]);
    }
  }
}

// out (16 x D) += X (16 x 16 KS, float32 C tiles, as hi + lo) T, T the
// 16 KS rows of a staged tile t (row-major [k][n], row stride LD) read
// transposed. Up to 64 columns at a time are summed into a zeroed partial
// that is then added to out: the tensor cores' accumulation (which does
// not round to nearest) then runs 2 KS products deep, and the long sum
// over tiles runs in float32 adds.
template <int D, int KS>
__device__ __forceinline__ void product_t(float (&out)[D / 8][4],
                                          const float (&x)[2 * KS][4],
                                          uint32_t t, int lane) {
  constexpr int LD = D + 8, NT = D / 8, CH = NT < 8 ? NT : 8;
  const int tr = lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += CH) {
    float part[CH][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(x[2 * kk], x[2 * kk + 1], hi, lo);
#pragma unroll
      for (int nn = 0; nn < CH / 2; ++nn) {
        uint32_t f[4];
        ldsm_x4_t(f, t + ((16 * kk + tr) * LD + 8 * c0 + 16 * nn +
                          8 * (lane / 16)) *
                             2);
        mma_bf16(part[2 * nn], hi, f[0], f[1]);
        mma_bf16(part[2 * nn], lo, f[0], f[1]);
        mma_bf16(part[2 * nn + 1], hi, f[2], f[3]);
        mma_bf16(part[2 * nn + 1], lo, f[2], f[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < CH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[c0 + n][e] += part[n][e];
  }
}

// rows (16 r + g + 8 (e >> 1) of the warp's C tile) as bf16 pairs into
// out (row stride ld elements) from row r0, scaled, up to row lim
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, size_t ld,
                                           const float (&acc)[D / 8][4],
                                           int r0, int lim, float scale,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= lim) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * ld +
                                   8 * n + 2 * t) =
          pack2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// dK, dV: a block per (64-key tile, KV head, batch row), a warp 16 keys,
// 32 queries a step. Shared memory: K, V (64 x (D + 8) each), then two
// buffers of (Q, dO) (32 x (D + 8) each).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, Params p) {
  constexpr int TILE = TC_ROWS * (D + 8) * 2;    // bytes: K or V
  constexpr int QTILE = TC_QROWS * (D + 8) * 2;  // bytes: Q or dO
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t base = smem_u32(tc_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * TC_ROWS, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * D;
  const size_t q_ld = static_cast<size_t>(p.heads) * D;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * D;
  stage_tc<D, TC_ROWS>(base, k + kv_off, kv_ld, k0, p.seq_k);
  stage_tc<D, TC_ROWS>(base + TILE, v + kv_off, kv_ld, k0, p.seq_k);
  cp_commit();

  const int i_lo = p.causal ? k0 : 0;
  const int i_hi =
      p.window > 0 ? min(p.seq, k0 + TC_ROWS - 1 + p.window) : p.seq;
  const int t_lo = i_lo / TC_QROWS;
  const int n_t = max(0, (i_hi + TC_QROWS - 1) / TC_QROWS - t_lo);
  const int total = group * n_t;
  auto buffer = [&](int it) {
    return base + 2 * TILE + 2 * QTILE * (it & 1);
  };
  auto prefetch = [&](int it) {
    const int h = hk * group + it / n_t;
    const int q0 = (t_lo + it % n_t) * TC_QROWS;
    const size_t q_off = (static_cast<size_t>(b) * p.seq * p.heads + h) * D;
    stage_tc<D, TC_QROWS>(buffer(it), q + q_off, q_ld, q0, p.seq);
    stage_tc<D, TC_QROWS>(buffer(it) + QTILE, dout + q_off, q_ld, q0,
                          p.seq);
    cp_commit();
  };

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  if (total > 0) prefetch(0);
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      prefetch(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int h = hk * group + it / n_t;
    const int q0 = (t_lo + it % n_t) * TC_QROWS;
    const size_t row_off = (static_cast<size_t>(b) * p.heads + h) * p.seq;
    const uint32_t qs = buffer(it), os = qs + QTILE;
    // S^T = K_w Q^T and dP^T = V_w dO^T: the warp's 16 keys x 32 queries
    float sa[4][4] = {}, pa[4][4] = {};
    two_products<D, TC_QROWS>(sa, pa, base, qs, base + TILE, os, warp,
                              lane);
    // P^T and dS^T in place
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 16 * warp + g + 8 * (e >> 1);
        const int qi = q0 + 8 * j + 2 * t + (e & 1);
        float pv = 0.0f, dsv = 0.0f;
        if (visible(p, qi, key)) {
          pv = expf(sa[j][e] * p.scale - lse[row_off + qi]);
          dsv = pv * (pa[j][e] - delta[row_off + qi]);
        }
        sa[j][e] = pv;
        pa[j][e] = dsv;
      }
    }
    // dV += P^T dO and dK += dS^T Q over the 32 queries
    product_t<D, 2>(dva, sa, os, lane);
    product_t<D, 2>(dka, pa, qs, lane);
    __syncthreads();  // the buffer is free for the tile after next
  }
  store_rows<D>(dk + kv_off, kv_ld, dka, k0 + 16 * warp, p.seq_k, p.scale,
                lane);
  store_rows<D>(dv + kv_off, kv_ld, dva, k0 + 16 * warp, p.seq_k, 1.0f,
                lane);
}

// dQ: a block per (64-query tile, head, batch row), a warp 16 queries.
// Shared memory: Q, dO, then two buffers of (K, V).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, Params p) {
  constexpr int TILE = TC_ROWS * (D + 8) * 2;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t base = smem_u32(tc_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * TC_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * D;
  const size_t q_ld = static_cast<size_t>(p.heads) * D;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * D;
  const size_t q_off = (static_cast<size_t>(b) * p.seq * p.heads + h) * D;
  const size_t row_off = (static_cast<size_t>(b) * p.heads + h) * p.seq;
  stage_tc<D, TC_ROWS>(base, q + q_off, q_ld, q0, p.seq);
  stage_tc<D, TC_ROWS>(base + TILE, dout + q_off, q_ld, q0, p.seq);
  cp_commit();

  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(q0 + TC_ROWS, p.seq_k) : p.seq_k;
  const int t_lo = k_lo / TC_ROWS;
  const int total = max(0, (k_hi + TC_ROWS - 1) / TC_ROWS - t_lo);
  auto prefetch = [&](int it) {
    const uint32_t buf = base + (2 + 2 * (it & 1)) * TILE;
    const int k0 = (t_lo + it) * TC_ROWS;
    stage_tc<D, TC_ROWS>(buf, k + kv_off, kv_ld, k0, p.seq_k);
    stage_tc<D, TC_ROWS>(buf + TILE, v + kv_off, kv_ld, k0, p.seq_k);
    cp_commit();
  };
  // the thread's two rows' lse and D
  float lr[2], dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + g + 8 * half;
    lr[half] = row < p.seq ? lse[row_off + row] : 0.0f;
    dr[half] = row < p.seq ? delta[row_off + row] : 0.0f;
  }

  float dqa[D / 8][4] = {};
  if (total > 0) prefetch(0);
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      prefetch(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = (t_lo + it) * TC_ROWS;
    const uint32_t ks = base + (2 + 2 * (it & 1)) * TILE, vs = ks + TILE;
    // S = Q_w K^T and dP = dO_w V^T: the warp's 16 queries x 64 keys
    float sa[8][4] = {}, pa[8][4] = {};
    two_products<D, TC_ROWS>(sa, pa, base, ks, base + TILE, vs, warp,
                             lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + 16 * warp + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        pa[j][e] = visible(p, row, key)
                       ? expf(sa[j][e] * p.scale - lr[e >> 1]) *
                             (pa[j][e] - dr[e >> 1])
                       : 0.0f;
      }
    }
    // dQ += dS K over the 64 keys
    product_t<D, 4>(dqa, pa, ks, lane);
    __syncthreads();
  }
  store_rows<D>(dq + q_off, q_ld, dqa, q0 + 16 * warp, p.seq, p.scale,
                lane);
}

// the dynamic shared-memory limit of `Kernel`, raised once per device
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, int batch,
                         const Params& p, float* delta, cudaStream_t st) {
  const int rows = batch * p.seq * p.heads;
  bwd_delta<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                 st>>>(static_cast<const T*>(o),
                       static_cast<const T*>(dout), delta, rows, p);
  return cudaGetLastError();
}

// bf16 at head dim D (32, 64 or 128) on the tensor cores
template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, int batch, const Params& p,
              float* delta, void* dq, void* dk, void* dv, cudaStream_t st) {
  using bf = __nv_bfloat16;
  constexpr int ROW = (D + 8) * 2;
  constexpr int SMEM_KV = (2 * TC_ROWS + 4 * TC_QROWS) * ROW;
  constexpr int SMEM_Q = 6 * TC_ROWS * ROW;
  cudaError_t err = allow_smem<bwd_dkdv_tc<D>>(SMEM_KV);
  if (err == cudaSuccess) err = allow_smem<bwd_dq_tc<D>>(SMEM_Q);
  if (err == cudaSuccess) err = launch_delta<bf>(o, dout, batch, p, delta,
                                                 st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf* tq = static_cast<const bf*>(q);
  const bf* tk = static_cast<const bf*>(k);
  const bf* tv = static_cast<const bf*>(v);
  const bf* tdo = static_cast<const bf*>(dout);
  const float* tl = static_cast<const float*>(lse);
  bwd_dkdv_tc<D><<<dim3((p.seq_k + TC_ROWS - 1) / TC_ROWS, p.kv_heads,
                        batch),
                   TC_THREADS, SMEM_KV, st>>>(tq, tk, tv, tdo, tl, delta,
                                              static_cast<bf*>(dk),
                                              static_cast<bf*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_tc<D><<<dim3((p.seq + TC_ROWS - 1) / TC_ROWS, p.heads, batch),
                 TC_THREADS, SMEM_Q, st>>>(tq, tk, tv, tdo, tl, delta,
                                           static_cast<bf*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

// head dims up to NC * 16 with BQ x BK tiles, float32 on the CUDA cores
template <typename T, int BQ, int BK, int NC>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, int batch, const Params& p,
           float* delta, void* dq, void* dk, void* dv, cudaStream_t st) {
  static_assert(4 * smem_floats<BQ, BK>(NC * 16 + 1) <= MAX_SMEM, "smem");
  const int smem = 4 * smem_floats<BQ, BK>(p.d | 1);
  const int max_smem = 4 * smem_floats<BQ, BK>(NC * 16 + 1);
  cudaError_t err = allow_smem<bwd_dkdv<T, BQ, BK, NC>>(max_smem);
  if (err == cudaSuccess) err = allow_smem<bwd_dq<T, BQ, BK, NC>>(max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  err = launch_delta<T>(o, dout, batch, p, delta, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<T, BQ, BK, NC>
      <<<dim3((p.seq_k + BK - 1) / BK, p.kv_heads, batch), THREADS, smem,
         st>>>(tq, tk, tv, tdo, tl, delta, static_cast<T*>(dk),
               static_cast<T*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, BQ, BK, NC><<<dim3((p.seq + BQ - 1) / BQ, p.heads, batch),
                          THREADS, smem, st>>>(tq, tk, tv, tdo, tl, delta,
                                               static_cast<T*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, int batch, const Params& p,
             float* delta, void* dq, void* dk, void* dv, cudaStream_t st) {
  switch (nc_of(p.d)) {
    case 2: return launch<T, CC_BQ, cc_block_kv(2), 2>(
        q, k, v, o, lse, dout, batch, p, delta, dq, dk, dv, st);
    case 4: return launch<T, CC_BQ, cc_block_kv(4), 4>(
        q, k, v, o, lse, dout, batch, p, delta, dq, dk, dv, st);
    case 8: return launch<T, CC_BQ, cc_block_kv(8), 8>(
        q, k, v, o, lse, dout, batch, p, delta, dq, dk, dv, st);
    default: return launch<T, CC_BQ, cc_block_kv(16), 16>(
        q, k, v, o, lse, dout, batch, p, delta, dq, dk, dv, st);
  }
}

}  // namespace

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D); all
// bfloat16 (is_bf16 = 1) or all float32, D <= 256, contiguous; lse (B, H,
// Sq) float32 from `flash_attention_fwd`; delta: (B, H, Sq) float32
// scratch. H a multiple of Hkv; window <= 0 for none; Sk >= 1, and Sk =
// Sq where the call is causal or has a window. The tensor cores where
// they take the call (bf16 at D 32, 64, 128), else the CUDA cores. Three
// launches on `stream`; returns the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   int batch, int seq_q, int seq_k,
                                   int heads, int kv_heads, int head_dim,
                                   int causal, int window, int is_bf16,
                                   void* delta, void* dq, void* dk,
                                   void* dv, void* stream) {
  if (batch == 0 || heads == 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || head_dim <= 0 ||
      head_dim > 256 || seq_k <= 0 || seq_q <= 0 ||
      ((causal || window > 0) && seq_k != seq_q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{seq_q,  seq_k,  heads,    kv_heads,
                 causal, window, head_dim,
                 1.0f / sqrtf(static_cast<float>(head_dim))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  if (takes_tc(is_bf16, head_dim)) {
    switch (head_dim) {
      case 32: return launch_tc<32>(q, k, v, o, lse, dout, batch, p, dl, dq,
                                    dk, dv, st);
      case 64: return launch_tc<64>(q, k, v, o, lse, dout, batch, p, dl, dq,
                                    dk, dv, st);
      default: return launch_tc<128>(q, k, v, o, lse, dout, batch, p, dl,
                                     dq, dk, dv, st);
    }
  }
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, dout, batch, p,
                                           dl, dq, dk, dv, st)
                 : dispatch<float>(q, k, v, o, lse, dout, batch, p, dl, dq,
                                   dk, dv, st);
}

// The dQ walk's tile in the form that takes a call at (head_dim,
// is_bf16): *rows queries by *keys keys, key tiles starting at multiples
// of *keys. Launches nothing.
extern "C" void flash_attention_bwd_dq_tile(int head_dim, int is_bf16,
                                            int* rows, int* keys) {
  const bool tc = takes_tc(is_bf16, head_dim);
  *rows = tc ? TC_ROWS : CC_BQ;
  *keys = tc ? TC_ROWS : cc_block_kv(nc_of(head_dim));
}
