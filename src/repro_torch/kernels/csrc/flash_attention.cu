// Causal / sliding-window flash attention, forward.
//
// Replaces the TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention.py (entry `flash_attention`).
//
//   o_i = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j over the keys j with
//   j <= i (causal), i - window < j (sliding window) and j < S,
//
// scores, softmax and sums in float32, output in q's dtype. Unlike the TPU
// kernel, keys past S (the ragged last tile) are masked: `ref.py`'s dense
// attention is the semantics.
//
// Layout is the model's: q, o (B, S, H, D); k, v (B, S, Hkv, D), head h
// reading KV head h / (H / Hkv) (the JAX package's kv-major GQA order), so
// the call site neither transposes nor repeats K and V.
//
// bfloat16 (`fa_bf16_kernel`, D 128 for StarCoder2-3B, 32 for its
// REDUCED config): one block of 4 warps per
// (64 queries, head, batch row); each warp owns 16 query rows, keeps its Q
// fragments in registers and works through 64-key tiles of K and V that
// the block stages in shared memory with cp.async, double buffered (the
// next tile's copy overlaps this tile's products). S = Q K^T and O += P V
// run on the tensor cores as mma.sync m16n8k16 bf16 with float32
// accumulators (ldmatrix reads the fragments; V through its transposing
// form). The online softmax keeps the running max and sum of each row in
// registers; P enters the P V product as the sum of two bf16 parts, so it
// keeps float32 precision (2^-17) as in the TPU kernel. A key tile wholly
// outside [q_start - window + 1, q_end] is never loaded, so the cost is
// O(S * window): the point of the TPU kernel. Masked scores are -inf and
// the running max starts at the finite -1e30, so a row whose first tiles
// are all masked gets weight exactly 0 from them (no NaN, no stale sum).
// Blocks start with the last query tiles, which have the most keys.
//
// float32 (`fa_f32_kernel`, D <= 256): one warp per query row, float32 FMA
// throughout, 32 keys at a time (one per lane); the REDUCED configs and
// the float32 parity checks run it. It is not on the bf16 serving path.
//
// Bound on an H100 at StarCoder2-3B's prompt shape (B 2, S 8192, H 24,
// Hkv 2, D 128, window 4096): 25.2 M (query, key) pairs per (b, h), 4 D
// FLOP each, 618.6 GFLOP per call: 0.63 ms at 989 TFLOP/s of dense bf16,
// against 218 MB of q, k, v and o (65 us at 3.35 TB/s): operations. This
// first version runs mma.sync (Hopper's full rate needs wgmma and TMA),
// spends ALU time on the softmax between the products and runs the P V
// product twice (hi and lo parts of P).
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // queries per block, 16 per warp
constexpr int BKV = 64;         // keys per staged tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float kNegInit = -1e30f;  // finite start of the running max

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int seq, heads, kv_heads, causal, window;  // window <= 0: none
  float scale;                               // 1 / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with ok == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = hi + lo with hi, lo packed bf16 pairs: hi the rounded values,
// lo the rounded remainders (exact in float32), to 2^-17 relative
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

template <int D>
__global__ void __launch_bounds__(THREADS) fa_bf16_kernel(Params p) {
  constexpr int LD = D + 8;  // padded smem row: ldmatrix rows hit all banks
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BKV][LD]
  __nv_bfloat16* vs = ks + 2 * BKV * LD;                       // [2][BKV][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = qt * BQ, qw = q0 + warp * 16;
  const size_t q_stride = static_cast<size_t>(p.heads) * D;
  const size_t kv_stride = static_cast<size_t>(p.kv_heads) * D;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            (static_cast<size_t>(b) * p.seq * p.heads + h) * D;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq * p.kv_heads + hk) * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + kv_off;

  // key range of the block: [k_begin, k_end)
  const int q_last = min(q0 + BQ, p.seq) - 1;
  const int k_end = p.causal ? q_last + 1 : p.seq;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / BKV, t_end = (k_end + BKV - 1) / BKV;

  auto load_tile = [&](int t, int stage) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int e = threadIdx.x; e < BKV * CH; e += THREADS) {
      const int row = e / CH, col = (e % CH) * 8;
      const int key = t * BKV + row;
      const bool ok = key < p.seq;
      const size_t src = static_cast<size_t>(ok ? key : 0) * kv_stride + col;
      const int dst = (stage * BKV + row) * LD + col;
      cp_async16(ks + dst, kb + src, ok);
      cp_async16(vs + dst, vb + src, ok);
    }
    cp_async_commit();
  };
  if (t_begin < t_end) load_tile(t_begin, 0);

  // Q fragments of this warp's 16 rows (rows past S read as zeros)
  uint32_t qf[D / 16][4];
  {
    const int r0 = qw + gid, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * tig;
      auto ld = [&](int r, int col) -> uint32_t {
        return r < p.seq ? *reinterpret_cast<const uint32_t*>(
                               qb + static_cast<size_t>(r) * q_stride + col)
                         : 0u;
      };
      qf[kk][0] = ld(r0, c);
      qf[kk][1] = ld(r1, c);
      qf[kk][2] = ld(r0, c + 8);
      qf[kk][3] = ld(r1, c + 8);
    }
  }

  const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units
  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.0f;
  float mrow[2] = {kNegInit, kNegInit}, lrow[2] = {0.0f, 0.0f};

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * BKV * LD;
    const __nv_bfloat16* vst = vs + stage * BKV * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sacc[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
      sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t bf[4];
        const int key = np * 16 + (lane / 16) * 8 + lane % 8;
        const int d = kk * 16 + ((lane / 8) % 2) * 8;
        ldsm_x4(bf, kst + key * LD + d);
        mma_bf16(sacc[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(sacc[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // mask (only where the tile crosses a boundary of this warp's rows)
    const int kt = t * BKV;
    const bool edge = kt + BKV > p.seq || (p.causal && kt + BKV - 1 > qw) ||
                      (p.window > 0 && kt <= qw + 15 - p.window);
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[nt][e] * sl2;
        if (edge) {
          const int row = qw + gid + (e >= 2 ? 8 : 0);
          const int key = kt + nt * 8 + 2 * tig + (e & 1);
          const bool ok = key < p.seq && (!p.causal || key <= row) &&
                          (p.window <= 0 || key > row - p.window);
          if (!ok) s = -INFINITY;
        }
        sacc[nt][e] = s;
      }
    }

    // online softmax: rows gid (e = 0, 1) and gid + 8 (e = 2, 3); the four
    // lanes of a quad share a row
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = kNegInit;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
        mx = fmaxf(mx, fmaxf(sacc[nt][2 * rh], sacc[nt][2 * rh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[rh], mx);
      const float corr = exp2f(mrow[rh] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        const float p0 = exp2f(sacc[nt][2 * rh] - m_new);
        const float p1 = exp2f(sacc[nt][2 * rh + 1] - m_new);
        sacc[nt][2 * rh] = p0;
        sacc[nt][2 * rh + 1] = p1;
        sum += p0 + p1;
      }
      lrow[rh] = lrow[rh] * corr + sum;  // this lane's share of the row
      mrow[rh] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        oacc[dt][2 * rh] *= corr;
        oacc[dt][2 * rh + 1] *= corr;
      }
    }

    // O += P V: P's accumulator layout is the A fragment of the next mma.
    // P = hi + lo, both bf16 (hi = P rounded, lo = the remainder rounded),
    // so the products keep P to 2^-17 relative: float32 probabilities, as
    // the TPU kernel has, at twice the P V tensor-core work.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* c = sacc[2 * kk + i / 2] + 2 * (i % 2);
        split_bf16(c[0], c[1], hi[i], lo[i]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        const int key = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
        const int d = dp * 16 + (lane / 16) * 8;
        ldsm_x4_trans(bf, vst + key * LD + d);
        mma_bf16(oacc[2 * dp], hi, bf[0], bf[1]);
        mma_bf16(oacc[2 * dp + 1], hi, bf[2], bf[3]);
        mma_bf16(oacc[2 * dp], lo, bf[0], bf[1]);
        mma_bf16(oacc[2 * dp + 1], lo, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other stage
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) +
                      (static_cast<size_t>(b) * p.seq * p.heads + h) * D;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float l = lrow[rh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = qw + gid + 8 * rh;
    if (row >= p.seq) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row) * q_stride +
                                   dt * 8 + 2 * tig) =
          pack_bf16(oacc[dt][2 * rh] / den, oacc[dt][2 * rh + 1] / den);
    }
  }
}

constexpr int F32_WARPS = 8;
constexpr int F32_MAX_D = 256;
constexpr int F32_PER_LANE = F32_MAX_D / 32;

__global__ void __launch_bounds__(32 * F32_WARPS)
fa_f32_kernel(Params p, int dh) {
  extern __shared__ float qs[];  // [F32_WARPS][dh]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * F32_WARPS + warp;
  if (row >= p.seq) return;  // warp-uniform; only warp syncs follow
  const int hk = h / (p.heads / p.kv_heads);
  const size_t q_stride = static_cast<size_t>(p.heads) * dh;
  const size_t kv_stride = static_cast<size_t>(p.kv_heads) * dh;
  const size_t qo = (static_cast<size_t>(b) * p.seq + row) * q_stride +
                    static_cast<size_t>(h) * dh;
  const size_t kv_off =
      static_cast<size_t>(b) * p.seq * kv_stride + static_cast<size_t>(hk) * dh;
  const float* kb = static_cast<const float*>(p.k) + kv_off;
  const float* vb = static_cast<const float*>(p.v) + kv_off;
  float* q = qs + warp * dh;
  for (int d = lane; d < dh; d += 32) q[d] = static_cast<const float*>(p.q)[qo + d];
  __syncwarp();

  const int lo = p.window > 0 ? max(0, row - p.window + 1) : 0;
  const int hi = p.causal ? row + 1 : p.seq;
  float m = kNegInit, l = 0.0f, acc[F32_PER_LANE];
#pragma unroll
  for (int i = 0; i < F32_PER_LANE; ++i) acc[i] = 0.0f;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    float s = -INFINITY;
    if (j < hi) {
      const float* kr = kb + static_cast<size_t>(j) * kv_stride;
      float dot = 0.0f;
      for (int d = 0; d < dh; ++d) dot = fmaf(q[d], kr[d], dot);
      s = dot * p.scale;
    }
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    const float pj = expf(s - m_new);  // 0 for keys past hi
    l = l * corr + warp_sum(pj);
    m = m_new;
#pragma unroll
    for (int i = 0; i < F32_PER_LANE; ++i) acc[i] *= corr;
    const int n = min(32, hi - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float w = __shfl_sync(0xffffffffu, pj, jj);
      const float* vr = vb + static_cast<size_t>(j0 + jj) * kv_stride;
#pragma unroll
      for (int i = 0; i < F32_PER_LANE; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) acc[i] = fmaf(w, vr[d], acc[i]);
      }
    }
  }
  const float den = fmaxf(l, 1e-30f);
  float* o = static_cast<float*>(p.o) + qo;
#pragma unroll
  for (int i = 0; i < F32_PER_LANE; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) o[d] = acc[i] / den;
  }
}

template <int D>
int launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = 4 * BKV * (D + 8) * 2;  // K and V, two stages each
  // above 48 KB for D 128; set on every launch, for whichever device is
  // current
  const cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + BQ - 1) / BQ, p.heads, batch);
  fa_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k and v (B, S, Hkv, D), o (B, S, H, D); all bfloat16
// (is_bf16 = 1, D 32 or 128) or all float32 (is_bf16 = 0, D <= 256),
// contiguous, 16-byte aligned; H a multiple of Hkv; window <= 0 for none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, int batch, int seq,
                                   int heads, int kv_heads, int head_dim,
                                   int causal, int window, int is_bf16,
                                   void* o, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,        k,      v,      o,
                 seq,      heads,  kv_heads, causal,
                 window,   1.0f / sqrtf(static_cast<float>(head_dim))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (head_dim) {
      case 32: return launch_bf16<32>(p, batch, st);
      case 128: return launch_bf16<128>(p, batch, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (head_dim > F32_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((seq + F32_WARPS - 1) / F32_WARPS, heads, batch);
  fa_f32_kernel<<<grid, 32 * F32_WARPS, F32_WARPS * head_dim * sizeof(float),
                  st>>>(p, head_dim);
  return static_cast<int>(cudaGetLastError());
}
