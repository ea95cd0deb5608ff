// Causal / sliding-window flash attention, forward.
//
// Replaces the TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention.py (entry `flash_attention`).
//
//   o_i = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j over the keys j with
//   j <= i (causal), i - window < j (sliding window) and j < Sk,
//
// scores, softmax and sums in float32, output in q's dtype. Unlike the TPU
// kernel, keys past Sk (the ragged last tile) are masked: `ref.py`'s dense
// attention is the semantics. Layout is the model's: q, o (B, Sq, H, D);
// k, v (B, Sk, Hkv, D), head h reading KV head h / (H / Hkv) (the JAX
// package's kv-major GQA order), so the call site neither transposes nor
// repeats K and V. The key length Sk is the query length Sq but in
// non-causal calls without a window (an encoder-decoder's cross-attention:
// decoder rows against the encoder memory), past the TPU kernel, which
// takes one S. Masked scores are -inf and the running max starts at
// the finite -1e30, so a row whose first tiles are all masked gets weight
// exactly 0 from them. A key tile wholly outside [q_start - window + 1,
// q_end] is never loaded: the cost is O(S * window), the point of the TPU
// kernel. Blocks start with the last query tiles, which have the most
// keys. No atomics: every sum runs in a fixed order. Given a pointer, both
// kernels also write each row's log-sum-exp of its scaled scores, float32
// (B, H, Sq), which the backward (`flash_attention_bwd.cu`) reads; serving
// passes none.
//
// bfloat16 (`fa_bf16_kernel<D>`: D 128 for StarCoder2-3B and OLMoE-1B-7B,
// 256 for Gemma-7B, 64 for hymba-1.5B, 32 for the REDUCED configs). At D
// 256 a K / V tile holds 64 keys, not 128: the two consumers' Q tiles
// (64 KB) and a 2-stage ring of 128-key K and V tiles (256 KB) would not
// fit the 227 KB a block may have; with 64 keys it takes 193 KB. A
// consumer's O accumulator is then 128 registers a thread (P V as one
// wgmma m64n256k16 a 16-key slice and part), S 32. Bound at Gemma-7B's
// prompt shape (B 2, S 4096, H 16, Hkv 16, D 256, causal): 8.39 M pairs
// per (b, h), 275 GFLOP, 278 us at 989 TFLOP/s; OLMoE-1B-7B's (D 128, the
// same B, S and heads) 137 GFLOP, 139 us. Both have one query head a KV
// head, so a block is 2 x 64 rows of one head (`pair` false).
// Bound on an H100 at StarCoder2-3B's prompt shape (B 2,
// S 8192, H 24, Hkv 2, D 128, window 4096): 25.2 M (query, key) pairs per
// (b, h), 4 D FLOP each, 618.6 GFLOP: 625 us at 989 TFLOP/s of dense bf16
// against 218 MB of q, k, v and o (65 us at 3.35 TB/s): operations. P
// enters P V as two bf16 parts (hi = P rounded, lo = the rest rounded), so
// P keeps float32 precision (2^-17) as in the TPU kernel; the tensor work
// is then 6 D FLOP a pair, 938 us at peak.
//
// A block is three warpgroups and two slots of 64 query rows. With an
// even number of query heads per KV head the slots are two heads of one
// KV group on the same rows (else rows [0, 64) and [64, 128) of one
// head); either way every K / V tile the block loads serves 128 rows.
//   * The producer warpgroup gives up its registers (`setmaxnreg.dec`);
//     one of its threads issues every TMA load: the two Q tiles once, then
//     128-key K and V tiles through a 2-stage ring of full / empty
//     mbarriers.
//   * Each consumer warpgroup (`setmaxnreg.inc`, 240 registers) owns a
//     slot: S = Q K^T as wgmma m64n128k16 with both operands in shared
//     memory (K is K-major as stored); the online softmax on the
//     accumulator; O += P V as wgmma with P from registers (for 16-bit
//     types the S accumulator is, pair by pair, the A fragment) and V
//     MN-major through the transpose bit, two products per 16-key slice
//     (hi, lo). It masks only tiles that cross the causal diagonal, the
//     window's lower edge or S, and passes over tiles with no key for its
//     rows.
//   * TMA reads the model's layout through 4-D tensor maps over (D, heads,
//     S, B), boxes of (64 columns, 1, rows, 1) with 128-byte swizzle (D 32:
//     one 64-byte box, 64-byte swizzle; D 256: four boxes side by side),
//     which the wgmma descriptors name;
//     keys past S arrive zero-filled and are masked to -inf. The maps are
//     encoded on every call (the pointers change); the shared-memory limit
//     is raised once per kernel and device.
//   * The epilogue writes O / l in bf16 into the slot's Q tile in the O
//     map's swizzled layout; a TMA store writes it, clipped at S.
// What it does about the causes of the first version's time (mma.sync,
// 4 warps on 64 queries of one head):
//   * mma.sync's rate: warpgroup wgmma;
//   * K / V tiles streamed from L2 once per 64 queries (9.8 GB a call at
//     the path shape): once per 128 query rows (4.9 GB);
//   * every thread issuing cp.async and two __syncthreads a tile: one
//     thread issues TMA; consumers wait on mbarriers only;
//   * the softmax between one warp's two products: the other consumer's
//     products run meanwhile. The softmax's instructions, not the tensor
//     cores, set the time (folding the scale into the exponent's FMA cut
//     it by a fifth), so the masks are left off interior tiles. Overlapping
//     a warpgroup's softmax with its own previous P V did not pay: `ptxas`
//     hoists the wait on that P V above the exponentials.
//
// float32 (`fa_f32_kernel`, any D <= 256; the REDUCED configs and the
// float32 parity checks run it). Bound at the REDUCED ragged shape (B 2,
// S 300, H 8, Hkv 2, D 64, causal): 185 MFLOP at 67 TFLOP/s = 2.76 us.
// The first version gave each query row a warp whose lanes read 32
// different key rows (32 sectors a load) and walked the keys in series.
// Now one block of 128 threads per (32 queries, head, batch row) stages
// Q and 32-key K and V tiles in shared memory by cp.async, coalesced and
// double buffered, 16 bytes a copy where D is a multiple of 4, else 4
// bytes (a path chosen at launch); each thread computes 2 rows x 4 keys
// of S and 2 rows x ceil(D / 8) columns of O in float32 FMA, reusing each
// staged value across rows, with the online softmax per row across the 8
// threads that share it.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInit = -1e30f;  // finite start of the running max

struct Params {
  int seq, seq_k;                            // query and key lengths
  int heads, kv_heads, causal, window;       // window <= 0: none
  float scale;                               // 1 / sqrt(D)
  int pair;  // bf16: the two slots of a block are two heads (see below)
  float* lse;  // null, or (B, H, Sq) float32: each row's log-sum-exp
};

// ---------------------------------------------------------- bfloat16

constexpr int ROWS_WG = 64;                 // query rows per consumer
constexpr int CONSUMERS = 2;                // consumer warpgroups
constexpr int STAGES = 2;                   // the K / V ring
constexpr int MAX_SMEM = 232448;            // a block's opt-in limit
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// A D-wide tile is NCH boxes of CH columns side by side, each ROW bytes a
// row, swizzled over ROW bytes (SWZ: the wgmma descriptor's layout type).
// BKV keys a staged K / V tile: 128, but 64 at D 256, where a ring of
// 128-key tiles would need 328,744 bytes of shared memory.
template <int D>
struct Tile {
  static constexpr int CH = D < 64 ? D : 64;
  static constexpr int NCH = D / CH;
  static constexpr int ROW = 2 * CH;
  static constexpr uint64_t SWZ = ROW == 128 ? 1 : 2;  // 128 / 64-byte
  static constexpr int BKV = D > 128 ? 64 : 128;
  static constexpr int Q_BYTES = ROWS_WG * D * 2;      // one consumer's Q
  static constexpr int KV_BYTES = BKV * D * 2;         // one K or V tile
  static constexpr int BARS = 8 * (2 * STAGES + 1);
  static constexpr int SMEM = 1024 + CONSUMERS * Q_BYTES +
                              2 * STAGES * KV_BYTES + BARS;
  static_assert(D % CH == 0 && (ROW == 128 || ROW == 64), "head dim");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

// One block: two slots of 64 query rows, one per consumer warpgroup. With
// `pair` (an even number of query heads per KV head), the slots are heads
// 2 y and 2 y + 1 of one KV group on the same 64 rows; else they are rows
// [0, 64) and [64, 128) of one head. Either way the two share every K / V
// tile the block loads.
//
// The wgmma accumulator of a 64 x N tile: element e of n8 block j of a
// thread (warp w of the warpgroup, lane = 4 gid + tig) is row 16 w + gid +
// 8 (e >> 1), column 8 j + 2 tig + (e & 1), at index 4 j + e.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fa_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, Params p) {
  using T = Tile<D>;
  constexpr int BKV = T::BKV;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle atoms of TMA and wgmma
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;                          // [CONSUMERS] Q / O
  const uint32_t k_s = q_s + CONSUMERS * T::Q_BYTES;  // [STAGES] K
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;    // [STAGES] V
  const uint32_t bars = v_s + STAGES * T::KV_BYTES;
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [&](int i) { return bars + 8 * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i % STAGES); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int rows = p.pair ? ROWS_WG : CONSUMERS * ROWS_WG;
  const int q0 = qt * rows, b = blockIdx.z;
  const int h0 = p.pair ? CONSUMERS * blockIdx.y : blockIdx.y;
  const int hk = h0 / (p.heads / p.kv_heads);
  auto slot_head = [&](int g) { return h0 + (p.pair ? g : 0); };
  auto slot_row = [&](int g) { return q0 + (p.pair ? 0 : g * ROWS_WG); };
  // key tiles of the block: [t_begin, t_begin + n_tiles)
  const int k_end = p.causal ? min(q0 + rows, p.seq_k) : p.seq_k;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / BKV;
  const int n_tiles = (k_end + BKV - 1) / BKV - t_begin;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);  // one arrival per warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, CONSUMERS * T::Q_BYTES);
      for (int g = 0; g < CONSUMERS; ++g)
        for (int c = 0; c < T::NCH; ++c)
          tma_load(q_s + g * T::Q_BYTES + c * ROWS_WG * T::ROW, &qmap, qbar,
                   c * T::CH, slot_head(g), slot_row(g), b);
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(empty(i), ((i / STAGES) & 1) ^ 1);  // first pass: free
        mbar_expect_tx(full(i), 2 * T::KV_BYTES);
        const int key = (t_begin + i) * BKV;
        for (int c = 0; c < T::NCH; ++c) {
          const int off = (i % STAGES) * T::KV_BYTES + c * BKV * T::ROW;
          tma_load(k_s + off, &kmap, full(i), c * T::CH, hk, key, b);
          tma_load(v_s + off, &vmap, full(i), c * T::CH, hk, key, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = warp / 4 - 1;  // consumer warpgroup = slot
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int r0 = slot_row(g);                 // the slot's rows
  const int r_last = min(r0 + ROWS_WG, p.seq) - 1;
  const int row0 = r0 + 16 * w + gid;         // the thread's rows: +0, +8
  const uint32_t qa = q_s + g * T::Q_BYTES;
  const float sl2 = p.scale * 1.4426950408889634f;  // log2 units
  // the slot's tiles [i_lo, i_hi): those with a key for one of its rows
  int i_lo = 0, i_hi = n_tiles;
  if (p.window > 0) i_lo = max(0, r0 - p.window + 1) / BKV - t_begin;
  if (p.causal) i_hi = min(n_tiles, r_last / BKV + 1 - t_begin);
  if (r0 > r_last) i_hi = i_lo;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float mrow[2] = {kNegInit, kNegInit}, lrow[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(full(i), (i / STAGES) & 1);
    if (i >= i_lo && i < i_hi) {
      const int kt = (t_begin + i) * BKV;
      const uint32_t ka = k_s + (i % STAGES) * T::KV_BYTES;
      const uint32_t va = v_s + (i % STAGES) * T::KV_BYTES;

      // S = Q K^T
      float sc[BKV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / T::CH, off = (kk * 16 % T::CH) * 2;
        wgmma_ss(sc,
                 gmma_desc(qa + c * ROWS_WG * T::ROW + off, 16, 8 * T::ROW,
                           T::SWZ),
                 gmma_desc(ka + c * BKV * T::ROW + off, 16, 8 * T::ROW,
                           T::SWZ),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask where the tile crosses a boundary of the slot's rows
      if (kt + BKV > p.seq_k || (p.causal && kt + BKV - 1 > r0) ||
          (p.window > 0 && kt <= r_last - p.window)) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            const int key = kt + 8 * j + 2 * tig + (e & 1);
            if (key >= p.seq_k || (p.causal && key > row) ||
                (p.window > 0 && key <= row - p.window))
              sc[4 * j + e] = -INFINITY;
          }
        }
      }

      // online softmax in log2 units (the scale folded into the
      // exponent); the four lanes of a quad share a row
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rh], sc[4 * j + 2 * rh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mrow[rh], mx * sl2);
        const float corr = exp2f(mrow[rh] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          const float p0 = exp2f(fmaf(sc[4 * j + 2 * rh], sl2, -m_new));
          const float p1 = exp2f(fmaf(sc[4 * j + 2 * rh + 1], sl2, -m_new));
          sc[4 * j + 2 * rh] = p0;
          sc[4 * j + 2 * rh + 1] = p1;
          sum += p0 + p1;
        }
        lrow[rh] = lrow[rh] * corr + sum;  // this lane's share of the row
        mrow[rh] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * rh] *= corr;
          o[4 * j + 2 * rh + 1] *= corr;
        }
      }

      // O += P V, P = hi + lo: the S accumulator of keys [16 kk, 16 kk +
      // 16) is, pair by pair, the A fragment of the 16-key slice
      uint32_t hi[BKV / 16][4], lo[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r],
                     lo[kk][r]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        // V MN-major: 8-key groups 8 ROW bytes apart, 64-column boxes
        // BKV ROW bytes apart
        const uint64_t dv = gmma_desc(va + kk * 16 * T::ROW, BKV * T::ROW,
                                      8 * T::ROW, T::SWZ);
        wgmma_rs(o, hi[kk], dv);
        wgmma_rs(o, lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i));  // the slot is done with tile i
  }
  if (r0 > r_last) return;

  // epilogue: O / l in bf16 into the slot's Q tile (its last reader, the
  // final S product, is done), in the swizzled layout of the O map; one
  // TMA store per box, clipped at S
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float l = lrow[rh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int row = 16 * w + gid + 8 * rh;
    // the row's log-sum-exp in natural units (m is in log2 units)
    if (p.lse != nullptr && tig == 0 && r0 + row < p.seq)
      p.lse[(static_cast<size_t>(b) * p.heads + slot_head(g)) * p.seq + r0 +
            row] = (mrow[rh] + log2f(fmaxf(l, 1e-30f))) *
                   0.6931471805599453f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      uint32_t off = (col / T::CH) * ROWS_WG * T::ROW + row * T::ROW +
                     (col % T::CH) * 2;
      off ^= ((off >> 7) & (T::ROW / 16 - 1)) << 4;
      *reinterpret_cast<uint32_t*>(smem + (qa - base) + off) =
          pack_bf16(o[4 * j + 2 * rh] * inv, o[4 * j + 2 * rh + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
  if (tid == 0) {
    for (int c = 0; c < T::NCH; ++c)
      tma_store(&omap, qa + c * ROWS_WG * T::ROW, c * T::CH, slot_head(g),
                r0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------- float32

constexpr int F_BQ = 32;  // queries per block: 16 thread rows x 2
constexpr int F_BK = 32;  // keys per staged tile: 8 thread columns x 4
constexpr int F_THREADS = 128;
constexpr int F_MAX_D = 256;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// R rows from row r0 of g (row stride ld floats, d columns) into s (row
// stride lds), zero-filled from row lim on; VEC: 16-byte copies (d, ld
// multiples of 4, g 16-byte aligned), else 4 bytes a copy
template <int R, bool VEC>
__device__ __forceinline__ void stage_rows(float* s, int lds, const float* g,
                                           size_t ld, int r0, int lim,
                                           int d) {
  const int per = VEC ? d / 4 : d, width = VEC ? 4 : 1;
  for (int e = threadIdx.x; e < R * per; e += F_THREADS) {
    const int row = e / per, col = (e % per) * width;
    const bool ok = r0 + row < lim;
    const float* src = g + static_cast<size_t>(ok ? r0 + row : 0) * ld + col;
    if (VEC)
      cp_async16(s + row * lds + col, src, ok ? 16 : 0);
    else
      cp_async4(s + row * lds + col, src, ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the shared row stride: 16-byte aligned and 4 banks apart (VEC), or odd
__host__ __device__ constexpr int f32_ld(int d, bool vec) {
  return vec ? d + 4 : (d | 1);
}

// NC = ceil(D / 8) output columns per thread: thread (ty, tx) = (tid / 8,
// tid % 8) owns rows ty and ty + 16 of the block, keys tx + 8 c of a tile
// and output columns tx + 8 c
template <int NC, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
    fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, Params p,
                  int d) {
  extern __shared__ __align__(16) float fs[];
  const int ld = f32_ld(d, VEC);
  float* qs = fs;                    // [F_BQ][ld]
  float* ks = qs + F_BQ * ld;        // [2][F_BK][ld]
  float* vs = ks + 2 * F_BK * ld;    // [2][F_BK][ld]
  float* ps = vs + 2 * F_BK * ld;    // [F_BQ][F_BK + 1]
  constexpr int LDP = F_BK + 1;

  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int q0 = qt * F_BQ;
  const size_t q_ld = static_cast<size_t>(p.heads) * d;
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * d;
  const size_t q_off = (static_cast<size_t>(b) * p.seq * p.heads + h) * d;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * d;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  const int k_end = p.causal ? min(q0 + F_BQ, p.seq_k) : p.seq_k;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / F_BK, t_end = (k_end + F_BK - 1) / F_BK;

  stage_rows<F_BQ, VEC>(qs, ld, q + q_off, q_ld, q0, p.seq, d);
  stage_rows<F_BK, VEC>(ks, ld, kb, kv_ld, t_begin * F_BK, p.seq_k, d);
  stage_rows<F_BK, VEC>(vs, ld, vb, kv_ld, t_begin * F_BK, p.seq_k, d);

  float acc[2][NC] = {};
  float mrow[2] = {kNegInit, kNegInit}, lrow[2] = {0.0f, 0.0f};
  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      const int nxt = (stage ^ 1) * F_BK * ld;
      stage_rows<F_BK, VEC>(ks + nxt, ld, kb, kv_ld, (t + 1) * F_BK,
                            p.seq_k, d);
      stage_rows<F_BK, VEC>(vs + nxt, ld, vb, kv_ld, (t + 1) * F_BK,
                            p.seq_k, d);
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* kst = ks + stage * F_BK * ld;
    const float* vst = vs + stage * F_BK * ld;

    float sc[2][4] = {};
    const float* qa = qs + ty * ld;
    const float* qb = qs + (ty + 16) * ld;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      const float x0 = qa[dd], x1 = qb[dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kv = kst[(tx + 8 * c) * ld + dd];
        sc[0][c] = fmaf(x0, kv, sc[0][c]);
        sc[1][c] = fmaf(x1, kv, sc[1][c]);
      }
    }

    const int kt = t * F_BK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + ty + 16 * r;
      float mx = kNegInit;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kt + tx + 8 * c;
        const bool ok = key < p.seq_k && (!p.causal || key <= row) &&
                        (p.window <= 0 || key > row - p.window);
        sc[r][c] = ok ? sc[r][c] * p.scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      // the 8 lanes of a row: tx = lane % 8
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(mrow[r], mx);
      const float corr = expf(mrow[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pj = expf(sc[r][c] - m_new);  // 0 where masked
        ps[(ty + 16 * r) * LDP + tx + 8 * c] = pj;
        sum += pj;
      }
      lrow[r] = lrow[r] * corr + sum;  // this thread's share of the row
      mrow[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncwarp();  // a row's P is written and read by one warp

    const float* pa = ps + ty * LDP;
    const float* pb = ps + (ty + 16) * LDP;
#pragma unroll 4
    for (int kk = 0; kk < F_BK; ++kk) {
      const float w0 = pa[kk], w1 = pb[kk];
      const float* vr = vst + kk * ld;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 8 * c;
        if (col < d) {
          const float x = vr[col];
          acc[0][c] = fmaf(w0, x, acc[0][c]);
          acc[1][c] = fmaf(w1, x, acc[1][c]);
        }
      }
    }
    __syncthreads();  // the next tile refills the other stage and P
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lrow[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const float den = fmaxf(l, 1e-30f);
    const int row = q0 + ty + 16 * r;
    if (row >= p.seq) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<size_t>(b) * p.heads + h) * p.seq + row] =
          mrow[r] + logf(den);
    float* orow = o + q_off + static_cast<size_t>(row) * q_ld;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 8 * c;
      if (col < d) orow[col] = acc[r][c] / den;
    }
  }
}

// ---------------------------------------------------------- launch

// (batch, seq, heads, D) bf16 at ptr as a map of Tile<D>'s boxes of
// `rows` rows (hopper.cuh)
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                int heads, int rows) {
  return tensor_map_bf16(map, ptr, batch, seq, heads, D, Tile<D>::CH, rows);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, const Params& p, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  if (!tensor_map<D>(&qm, q, batch, p.seq, p.heads, ROWS_WG) ||
      !tensor_map<D>(&km, k, batch, p.seq_k, p.kv_heads, Tile<D>::BKV) ||
      !tensor_map<D>(&vm, v, batch, p.seq_k, p.kv_heads, Tile<D>::BKV) ||
      !tensor_map<D>(&om, o, batch, p.seq, p.heads, ROWS_WG))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<fa_bf16_kernel<D>>(Tile<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = p.pair ? ROWS_WG : CONSUMERS * ROWS_WG;
  const dim3 grid((p.seq + rows - 1) / rows,
                  p.pair ? p.heads / CONSUMERS : p.heads, batch);
  fa_bf16_kernel<D><<<grid, THREADS, Tile<D>::SMEM, stream>>>(qm, km, vm, om,
                                                              p);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool VEC>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, const Params& p, int d, cudaStream_t stream) {
  auto smem = [](int dd) {
    const int ld = f32_ld(dd, VEC);
    return static_cast<int>(sizeof(float)) *
           (F_BQ * ld + 4 * F_BK * ld + F_BQ * (F_BK + 1));
  };
  const cudaError_t err = allow_smem<fa_f32_kernel<NC, VEC>>(smem(8 * NC));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.seq + F_BQ - 1) / F_BQ, p.heads, batch);
  fa_f32_kernel<NC, VEC><<<grid, F_THREADS, smem(d), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p, d);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 int batch, const Params& p, int d, cudaStream_t stream) {
  if (d <= 32) return launch_f32<4, VEC>(q, k, v, o, batch, p, d, stream);
  if (d <= 64) return launch_f32<8, VEC>(q, k, v, o, batch, p, d, stream);
  if (d <= 128) return launch_f32<16, VEC>(q, k, v, o, batch, p, d, stream);
  return launch_f32<32, VEC>(q, k, v, o, batch, p, d, stream);
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, Hkv, D), o (B, Sq, H, D); all
// bfloat16 (is_bf16 = 1, D 32, 64, 128 or 256) or all float32 (is_bf16 =
// 0, D <= 256), contiguous, 16-byte aligned; H a multiple of Hkv; window
// <= 0 for none; Sk >= 1, and Sk = Sq where the call is causal or has a
// window. lse: null, or (B, H, Sq) float32 for each row's log-sum-exp of
// its scaled scores (the backward's input; serving passes null and
// writes nothing there).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, int batch, int seq_q,
                                   int seq_k, int heads, int kv_heads,
                                   int head_dim, int causal, int window,
                                   int is_bf16, void* o, void* lse,
                                   void* stream) {
  if (batch == 0 || seq_q == 0 || heads == 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || head_dim <= 0 || seq_k <= 0 ||
      ((causal || window > 0) && seq_k != seq_q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{seq_q,  seq_k,  heads,  kv_heads,
                 causal, window, 1.0f / sqrtf(static_cast<float>(head_dim)),
                 (heads / kv_heads) % CONSUMERS == 0,
                 static_cast<float*>(lse)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (head_dim) {
      case 32: return launch_bf16<32>(q, k, v, o, batch, p, st);
      case 64: return launch_bf16<64>(q, k, v, o, batch, p, st);
      case 128: return launch_bf16<128>(q, k, v, o, batch, p, st);
      case 256: return launch_bf16<256>(q, k, v, o, batch, p, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (head_dim > F_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  return head_dim % 4 == 0
             ? dispatch_f32<true>(q, k, v, o, batch, p, head_dim, st)
             : dispatch_f32<false>(q, k, v, o, batch, p, head_dim, st);
}
