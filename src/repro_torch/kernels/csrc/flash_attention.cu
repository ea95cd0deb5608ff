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
// float32 (`fa_f32_tc_kernel`, any D <= 256: StarCoder2-3B's float32
// training, the REDUCED configs and the float32 parity checks), on the
// tensor cores as 3xTF32 with `mma.sync` m16n8k8 (`gru_tile.cuh`): each
// float32 operand is split into a tf32 hi (rounded on its bits) and lo =
// x - hi, which the tensor cores read truncated to tf32, and a b is summed
// as a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, ~2^-22 of a b, is
// dropped). Bound on an H100 at StarCoder2-3B's float32 training call (B
// 1, S 8192, H 24, Hkv 2, D 128, window 4096): 25.2 M pairs a head, 309.3
// GFLOP, three times at 495 TFLOP/s of dense tf32 = 1.87 ms (4.62 ms at
// 67 TFLOP/s of float32 FMA), against 218 MB of q, k, v and o (65 us at
// 3.35 TB/s): operations. The first version ran every product as float32
// FMA on the CUDA cores, its thread reading ~0.5-0.75 floats from shared
// memory an FMA (the SM feeds 0.25), through P staged in shared memory,
// and staged each K / V tile again for every 32 queries of every query
// head (19 GB from L2 a call at the training call). This one:
//   * S = Q K^T and O += P V as 3xTF32 mma.sync (tf32 `wgmma` reads K-major
//     operands only, and V, P V's B, is MN-major), A and K fragments by
//     `ldmatrix`, split in registers (staging lo parts beside a tile cost
//     the backward more than the splits), the passes issued n8 block by n8
//     block so that consecutive mmas do not wait on each other;
//   * the tensor cores' float32 accumulate truncates, so chains are short:
//     S sums each F_CHAIN k-steps (64 head-dim columns) from zero, P V each
//     tile's keys for 64 columns from zero, and each partial is added in
//     float32 (one chain over a block's walk fails the 1e-5 limit). S's
//     chains of 4 k-steps spilled at D 128 and ran 8% slower; 16 gained
//     nothing, nor did 16-block P V groups; 32-key tiles lost 1-2%;
//   * P stays in registers: with the key index permuted within each 8-key
//     group (2 t for t, 2 t + 1 for t + 4), S's accumulator is P V's A
//     fragment, and V's rows are read in the same order, two n8 blocks'
//     columns as one float2; the online softmax runs on the accumulator
//     with quad shuffles, the scale folded into an exp2f FMA, masks on
//     edge tiles only;
//   * a block is 8 warps of 16 rows, two slots of 64 rows (4 warps, two
//     slots of 32 at D 256): two heads of one KV group on the same rows
//     where the group is even, as the bf16 form's `pair`, else 128 rows of
//     one head, so each staged K / V tile serves 128 rows (64 at D 256);
//     tiles outside the window are never loaded, heavy tiles go first;
//   * `cp.async` stages Q once and 64-key K and V tiles (32 at D 256)
//     through a 2-stage ring, one barrier a tile, 16 bytes a copy where D
//     is a multiple of 4, else 4 bytes (a path chosen at launch), rows
//     holding D padded with zeros to 8 NK columns (NK: its k-steps rounded
//     up to 4, 8, 16 or 32) + 4 floats.
// At the training call it runs ~2.8x its bound, held by mma.sync issue:
// the two lo passes are over half of its time (one tf32 pass, wrong by
// design, ran 2.55 of 5.6 ms), so 2x needs `wgmma` and K / V lo parts
// staged beside the tiles.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gru_tile.cuh"
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

// The float32 form on the tensor cores as 3xTF32 with `mma.sync`
// m16n8k8 (see the note at the top). F32Tile<NK>: the head dim padded
// with zeros to 8 NK columns (NK 4, 8, 16, 32: D to 32, 64, 128, 256);
// W warps of 16 query rows, two slots of SLOT rows; key tiles of BK
// keys; shared rows of LD = 8 NK + 4 floats (16-byte aligned, and 4 banks
// apart, so that `ldmatrix` rows and P V's float2 reads of V fall in
// distinct banks). At D 256 a block is 4 warps over 32-key tiles: 128
// rows of Q and a 2-stage ring of 32-key tiles would need 266 KB of
// shared memory, and the O accumulator alone is 128 registers a thread.
constexpr int F_CHAIN = 8;  // k-steps of S summed in one tensor-core chain
constexpr int F_MAX_D = 256;

template <int NK>
struct F32Tile {
  static constexpr int W = NK > 16 ? 4 : 8;      // warps
  static constexpr int THREADS = 32 * W;
  static constexpr int SLOT = 8 * W;             // query rows a slot
  static constexpr int ROWS = 2 * SLOT;          // Q rows staged
  static constexpr int BK = NK > 16 ? 32 : 64;   // keys a tile
  static constexpr int NT = BK / 8;              // S's n8 blocks
  static constexpr int CHAIN = NK < F_CHAIN ? NK : F_CHAIN;
  static constexpr int CG = NK < 8 ? NK : 8;     // P V's n8 blocks a group
  static constexpr int LD = 8 * NK + 4;
  static constexpr int SMEM = 4 * LD * (ROWS + 4 * BK);  // Q, K / V ring
  static_assert(NK % CHAIN == 0 && NK % CG == 0 && CG % 2 == 0, "NK");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

// four 8 x 4 float32 tiles from shared memory (`ldmatrix` of 8 x 8 b16
// matrices): lane l gives the address of row l % 8 of tile l / 8 and
// gets element (l / 4, l % 4) of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// N rows from row r0 of g (row stride gld floats) into s (row stride
// 8 NK + 4), the head dim's padding [d, 8 NK) and rows from lim on
// zero-filled; VEC: 16-byte copies (d a multiple of 4, g 16-byte
// aligned), else 4 bytes. Issues the copies only.
template <int NK, int N, int NTHR, bool VEC>
__device__ __forceinline__ void f32_stage(float* s, const float* g,
                                          size_t gld, int r0, int lim,
                                          int d) {
  constexpr int WIDTH = VEC ? 4 : 1, PER = 8 * NK / WIDTH, LD = 8 * NK + 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < N * PER; e += NTHR) {
    const int row = e / PER, col = (e % PER) * WIDTH;
    const bool ok = r0 + row < lim && col < d;
    const float* src = ok ? g + static_cast<size_t>(r0 + row) * gld + col : g;
    if constexpr (VEC)
      gru::cp_async16(s + row * LD + col, src, ok ? 16 : 0);
    else
      gru::cp_async4(s + row * LD + col, src, ok ? 4 : 0);
  }
}

// One block: two slots of SLOT query rows (with `pair`, heads 2 y and 2 y
// + 1 of one KV group on the same rows; else rows [0, SLOT) and [SLOT, 2
// SLOT) of one head), a warp 16 rows of a slot. Every K / V tile the
// block stages serves all 2 SLOT rows.
//
// An m16n8k8 accumulator c[j][e] of a warp (lane = 4 gid + tig) is row
// gid + 8 (e >> 1), column 8 j + 2 tig + (e & 1). S's is, with the key
// index permuted within each 8-key group (2 t for t, 2 t + 1 for t + 4),
// P V's A fragment {c0, c2, c1, c3}; V's rows 8 j + 2 tig and 8 j + 2 tig
// + 1 are read in the same order, two n8 blocks' columns as a float2: O's
// c[n][e] is column 16 (n >> 1) + 4 tig + 2 (e & 1) + (n & 1).
template <int NK, bool VEC>
__global__ void __launch_bounds__(F32Tile<NK>::THREADS, 1)
    fa_f32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Params p, int d) {
  using T = F32Tile<NK>;
  constexpr int LD = T::LD, BK = T::BK, NT = T::NT, CG = T::CG;
  constexpr int CHAIN = T::CHAIN;
  extern __shared__ __align__(16) float fs[];
  float* qs = fs;                    // [ROWS][LD]
  float* ks = qs + T::ROWS * LD;     // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;      // [2][BK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int rows = p.pair ? T::SLOT : T::ROWS;
  const int q0 = qt * rows, b = blockIdx.z;
  const int h0 = p.pair ? 2 * blockIdx.y : blockIdx.y;
  const int hk = h0 / (p.heads / p.kv_heads);
  const size_t q_ld = static_cast<size_t>(p.heads) * d;
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * d;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * d;
  auto slot_head = [&](int g) { return h0 + (p.pair ? g : 0); };
  auto slot_row = [&](int g) { return q0 + (p.pair ? 0 : g * T::SLOT); };
  auto q_base = [&](int g) {
    return q + (static_cast<size_t>(b) * p.seq * p.heads + slot_head(g)) * d;
  };
  // key tiles of the block: [t_begin, t_begin + n_tiles)
  const int k_end = p.causal ? min(q0 + rows, p.seq_k) : p.seq_k;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int n_tiles = (k_end + BK - 1) / BK - t_begin;
  auto stage_tile = [&](int i) {
    const int key = (t_begin + i) * BK, off = (i & 1) * BK * LD;
    f32_stage<NK, BK, T::THREADS, VEC>(ks + off, k + kv_off, kv_ld, key,
                                       p.seq_k, d);
    f32_stage<NK, BK, T::THREADS, VEC>(vs + off, v + kv_off, kv_ld, key,
                                       p.seq_k, d);
  };
  for (int g = 0; g < 2; ++g)
    f32_stage<NK, T::SLOT, T::THREADS, VEC>(qs + g * T::SLOT * LD,
                                            q_base(g), q_ld, slot_row(g),
                                            p.seq, d);
  if (n_tiles > 0) stage_tile(0);
  gru::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int g = warp / (T::W / 2);                    // the warp's slot
  const int r0 = slot_row(g) + 16 * (warp % (T::W / 2));  // its rows
  const int r_last = min(r0 + 15, p.seq - 1);
  // the warp's tiles [i_lo, i_hi): those with a key for one of its rows
  int i_lo = 0, i_hi = n_tiles;
  if (p.window > 0) i_lo = max(0, r0 - p.window + 1) / BK - t_begin;
  if (p.causal) i_hi = min(n_tiles, r_last / BK + 1 - t_begin);
  if (r0 > r_last) i_hi = i_lo;
  // `ldmatrix` addresses: the warp's Q rows (A), a tile's K rows (B;
  // n8 block pairs 16 rows apart)
  const uint32_t qa = smem_addr(
      qs + (16 * warp + lane % 8 + 8 * (lane / 8 % 2)) * LD + 4 * (lane / 16));
  const uint32_t kb =
      smem_addr(ks + (lane % 8 + 8 * (lane / 16)) * LD + 4 * (lane / 8 % 2));
  const float sl2 = p.scale * 1.4426950408889634f;  // log2 units

  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float mrow[2] = {kNegInit, kNegInit}, lrow[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    gru::cp_async_wait<0>();  // tile i (and Q) has landed, for this thread
    __syncthreads();          // ... for all; tile i - 1 is used up
    if (i + 1 < n_tiles) stage_tile(i + 1);
    gru::cp_async_commit();
    if (i < i_lo || i >= i_hi) continue;
    const int kt = (t_begin + i) * BK, st = i & 1;

    // S = Q K^T: each CHAIN k-steps summed from zero (the passes lo hi,
    // hi lo, hi hi in one accumulator), then added in float32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int c0 = 0; c0 < NK; c0 += CHAIN) {
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
      for (int kk = c0; kk < c0 + CHAIN; ++kk) {
        uint32_t x[4], ah[4], al[4];
        ldsm4(x, qa + 32 * kk);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gru::Tf32x3::split(__uint_as_float(x[e]), ah[e], al[e]);
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int m = 0; m < NT / 2; ++m) {
          uint32_t y[4];
          ldsm4(y, kb + 4 * (st * BK * LD + 16 * m * LD) + 32 * kk);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gru::Tf32x3::split(__uint_as_float(y[e]), bh[2 * m + e / 2][e % 2],
                               bl[2 * m + e / 2][e % 2]);
        }
        // pass by pass over the n8 blocks, so that consecutive mmas do
        // not wait on each other
#pragma unroll
        for (int j = 0; j < NT; ++j)
          gru::mma_tf32(part[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          gru::mma_tf32(part[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          gru::mma_tf32(part[j], ah, bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    }

    // mask where the tile crosses a boundary of the warp's rows
    if (kt + BK > p.seq_k || (p.causal && kt + BK - 1 > r0) ||
        (p.window > 0 && kt <= r_last - p.window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + gid + 8 * (e >> 1);
          const int key = kt + 8 * j + 2 * tig + (e & 1);
          if (key >= p.seq_k || (p.causal && key > row) ||
              (p.window > 0 && key <= row - p.window))
            s[j][e] = -INFINITY;
        }
    }

    // online softmax in log2 units (the scale folded into the exponent);
    // the four lanes of a quad share a row
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rh], s[j][2 * rh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[rh], mx * sl2);
      const float corr = exp2f(mrow[rh] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = exp2f(fmaf(s[j][2 * rh], sl2, -m_new));
        const float p1 = exp2f(fmaf(s[j][2 * rh + 1], sl2, -m_new));
        s[j][2 * rh] = p0;
        s[j][2 * rh + 1] = p1;
        sum += p0 + p1;
      }
      lrow[rh] = lrow[rh] * corr + sum;  // this lane's share of the row
      mrow[rh] = m_new;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        acc[n][2 * rh] *= corr;
        acc[n][2 * rh + 1] *= corr;
      }
    }

    // O += P V: for each group of CG n8 blocks (8 CG columns), the tile's
    // keys summed from zero, then added in float32
    const float* vt = vs + st * BK * LD + 2 * tig * LD + 2 * gid;
#pragma unroll
    for (int c = 0; c < NK / CG; ++c) {
      float part[CG][4];
#pragma unroll
      for (int n = 0; n < CG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        const gru::Tf32x3::A a = gru::Tf32x3::split_a(pa);
        uint32_t bh[CG][2], bl[CG][2];
#pragma unroll
        for (int m = 0; m < CG / 2; ++m) {
          const float* y = vt + 8 * j * LD + 8 * CG * c + 16 * m;
          const float2 u = *reinterpret_cast<const float2*>(y);
          const float2 w = *reinterpret_cast<const float2*>(y + LD);
          gru::Tf32x3::split(u.x, bh[2 * m][0], bl[2 * m][0]);
          gru::Tf32x3::split(w.x, bh[2 * m][1], bl[2 * m][1]);
          gru::Tf32x3::split(u.y, bh[2 * m + 1][0], bl[2 * m + 1][0]);
          gru::Tf32x3::split(w.y, bh[2 * m + 1][1], bl[2 * m + 1][1]);
        }
#pragma unroll
        for (int n = 0; n < CG; ++n)
          gru::mma_tf32(part[n], a.lo, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < CG; ++n)
          gru::mma_tf32(part[n], a.hi, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < CG; ++n)
          gru::mma_tf32(part[n], a.hi, bh[n][0], bh[n][1]);
      }
#pragma unroll
      for (int n = 0; n < CG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[CG * c + n][e] += part[n][e];
    }
  }
  if (r0 > r_last) return;

  // epilogue: O / l; a thread's columns of a row are 4 adjacent floats
  // per pair of n8 blocks
  const int h = slot_head(g);
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float l = lrow[rh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = r0 + gid + 8 * rh;
    if (row >= p.seq) continue;
    // the row's log-sum-exp in natural units (m is in log2 units)
    if (p.lse != nullptr && tig == 0)
      p.lse[(static_cast<size_t>(b) * p.heads + h) * p.seq + row] =
          (mrow[rh] + log2f(den)) * 0.6931471805599453f;
    float* orow =
        o + ((static_cast<size_t>(b) * p.seq + row) * p.heads + h) * d;
#pragma unroll
    for (int m = 0; m < NK / 2; ++m) {
      const int col = 16 * m + 4 * tig;
      const float x[4] = {acc[2 * m][2 * rh] / den,
                          acc[2 * m + 1][2 * rh] / den,
                          acc[2 * m][2 * rh + 1] / den,
                          acc[2 * m + 1][2 * rh + 1] / den};
      if (VEC) {
        if (col < d)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) orow[col + e] = x[e];
      }
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

template <int NK, bool VEC>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, const Params& p, int d, cudaStream_t stream) {
  using T = F32Tile<NK>;
  const cudaError_t err = allow_smem<fa_f32_tc_kernel<NK, VEC>>(T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = p.pair ? T::SLOT : T::ROWS;
  const dim3 grid((p.seq + rows - 1) / rows, p.pair ? p.heads / 2 : p.heads,
                  batch);
  fa_f32_tc_kernel<NK, VEC><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p, d);
  return static_cast<int>(cudaGetLastError());
}

// NK of head dim d: its 8-column k-steps rounded up to 4, 8, 16 or 32
constexpr int f32_nk(int d) {
  return d <= 32 ? 4 : d <= 64 ? 8 : d <= 128 ? 16 : 32;
}

template <bool VEC>
int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 int batch, const Params& p, int d, cudaStream_t stream) {
  switch (f32_nk(d)) {
    case 4: return launch_f32<4, VEC>(q, k, v, o, batch, p, d, stream);
    case 8: return launch_f32<8, VEC>(q, k, v, o, batch, p, d, stream);
    case 16: return launch_f32<16, VEC>(q, k, v, o, batch, p, d, stream);
    default: return launch_f32<32, VEC>(q, k, v, o, batch, p, d, stream);
  }
}

template <int NK>
void f32_tile(int* rows, int* keys) {
  *rows = F32Tile<NK>::SLOT;
  *keys = F32Tile<NK>::BK;
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

// The float32 kernel's tiles at head_dim: NK (k-steps of the padded head
// dim), query rows a slot, keys a tile, and the k-steps of S's chains
// (kernels/flash_attention.py's f32_tiles and F32_S_CHAIN mirror them).
extern "C" void flash_attention_fwd_f32_tile(int head_dim, int* nk,
                                             int* rows, int* keys,
                                             int* chain) {
  *nk = f32_nk(head_dim);
  *chain = F_CHAIN;
  switch (*nk) {
    case 4: return f32_tile<4>(rows, keys);
    case 8: return f32_tile<8>(rows, keys);
    case 16: return f32_tile<16>(rows, keys);
    default: return f32_tile<32>(rows, keys);
  }
}
