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
// dk and dv come back per KV head). No atomics: every sum runs in a fixed
// order, so two calls agree bit for bit. Two forms, chosen by dtype alone
// (`takes_wgmma`), each four launches: `bwd_delta` (D, one warp a (batch,
// row, head)); the dK / dV walk, a block per (key tile, KV head, batch
// row, run of its steps) walking the query heads of the group and the
// query tiles that see its keys; the runs' sums added in order; the dQ
// walk, a block per query tile walking the key tiles its rows see.
//   * bf16 (D 32, 64, 128 and 256: StarCoder2-3B, OLMoE-1B-7B, Gemma-7B,
//     hymba, the REDUCED configs), on the tensor cores with `wgmma`, TMA
//     and warp specialisation (see the two sections below):
//     `bwd_dkdv_wg` (128-key tiles to D 128) or `bwd_dkdv_wg256` (64-key
//     tiles at D 256), `bwd_dkdv_sum`, `bwd_dq_wg` (64 query rows of two
//     heads or 128 of one, walking 128-key tiles) or `bwd_dq_wg256` (64
//     rows of one head, 64-key tiles).
//   * float32 (any D to 256), on the tensor cores as 3xTF32 with
//     `mma.sync` (the section after them): `bwd_dkdv_f32`,
//     `bwd_dkdv_sum_f32`, `bwd_dq_f32`.
//
// Bound on an H100 at StarCoder2-3B's training shape (B 1, S 8192, H 24,
// Hkv 2, D 128, window 4096): 25.2 M (query, key) pairs a head; the
// function's work is 2.5x the forward's 4 D FLOP a pair, 0.77 TFLOP at
// 989 TFLOP/s of dense bf16 = 0.78 ms, against 219 MB of inputs and
// outputs (65 us at 3.35 TB/s): operations. At Gemma-7B's (B 1, S 4096,
// 16 / 16 heads of 256, causal): 8.39 M pairs a head, 0.34 TFLOP, 0.35
// ms. The bf16 form runs 20 D products a pair (S and dP in both walks;
// dV, dK, dQ twice each, hi and lo): 1.56 ms at the peak at StarCoder2-3B's
// shape, 0.69 ms at Gemma-7B's. Its first version (`mma.sync` m16n8k16
// through `ldmatrix`, four warps on 64 keys and 32 queries a step, the
// masks evaluated and lse / D read from device memory at every element)
// ran 8.43 ms at StarCoder2-3B's; this one issues `wgmma` from
// warpgroups fed by TMA, masks only edge tiles, stages lse and D once a
// tile, and keeps P and dS of the dK / dV walk in shared memory so that
// the accumulators and each tile's partial fit in registers. In float32
// the same call is 0.77 TFLOP at 67 TFLOP/s of float32 FMA = 11.55 ms;
// the float32 form runs 42 D tf32 FLOP a pair (S, dP, dV, dK, dQ and S,
// dP again, three passes each), 3.25 TFLOP at 495 TFLOP/s of dense tf32 =
// 6.6 ms. Its first version ran 14 D float32 FMA a pair on the CUDA cores
// (16.2 ms at best), its inner loops held by scalar shared-memory reads.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "gru_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;     // bwd_delta's block
constexpr int MAX_SMEM = 232448;
// whether the bf16 (wgmma) form takes a call: bf16 at D 32, 64, 128 and
// 256, the only head dims bf16 calls may have
constexpr bool takes_wgmma(int is_bf16, int d) {
  return is_bf16 && (d == 32 || d == 64 || d == 128 || d == 256);
}

struct Params {
  int seq, seq_k, heads, kv_heads, causal, window, d;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// ------------------------------------------ bf16 on the tensor cores

// The bf16 kernels at D 32, 64 and 128, on the forward's pattern
// (`flash_attention.cu`): a block is three warpgroups, a producer that
// gives up its registers (`setmaxnreg`) and issues every TMA load, and
// two consumers (240 registers) that run `wgmma`. Tiles come through TMA
// tensor maps over the model's layout (boxes of 64 columns, 128-byte
// swizzle; D 32 one 64-byte box) into a 2-stage ring of full / empty
// mbarriers. P and dS enter the products that accumulate them (dV, dK,
// dQ) as bf16 hi + lo parts, so they keep ~2^-17 of their value; the
// products of the inputs (S, dP) are exact. Each tile's products are
// summed on the tensor cores into a zeroed partial (8 or 16 products
// deep: their accumulation does not round to nearest, and a chain over
// every tile failed the limit) that is then added in float32.
//
//   * dK / dV: a block per (128-key tile, KV head, batch row, split); K
//     and V stay in shared memory, each consumer owns 64 keys (dK, dV:
//     64 x D float32 accumulators). The block walks the query heads of
//     the group and, for each, the 64-query tiles that see one of its
//     keys (Q and dO through the ring); the walk's steps are cut into
//     `splits` contiguous runs, one a block, so that the first key tiles,
//     which see the most queries, do not hold the card while the rest is
//     done (`dkdv_splits`: 4 waves of 132 SMs, 8 steps a run at least).
//     A step: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both
//     operands in shared memory); P^T = exp2(S^T scale log2(e) - lse
//     log2(e)) and dS^T = P^T (dP^T - D) in registers, the tile's lse and
//     D staged in shared memory by the consumer itself; P^T and dS^T as
//     hi + lo into shared memory (K-major, 128-byte swizzle); then dV +=
//     P^T dO and dK += dS^T Q (wgmma m64nDk16, A and B from shared
//     memory, B MN-major through the transpose bit). P^T and dS^T go
//     through shared memory because dK, dV (128 registers a thread at D
//     128) and a tile's partial (64) leave no room for their hi + lo
//     fragments beside S^T and dP^T. Each block writes its run's sums in
//     float32; `bwd_dkdv_sum` adds the runs in order and rounds (dK
//     scaled).
//   * dQ: a block per (64 rows, two heads of a KV group or 128 rows of
//     one head, batch row), as the forward's: Q and dO stay in shared
//     memory, K and V tiles of 128 keys through the ring. S = Q K^T and
//     dP = dO V^T (wgmma m64n128k16 from shared memory); dS in registers
//     is, pair by pair, the A fragment of dQ += dS K (wgmma m64nDk16, A
//     from registers, K MN-major); the epilogue writes dQ through a TMA
//     store.
// Masks only on tiles that cross the causal diagonal or the window's
// lower edge (the elementwise loop in a masked and a plain form, chosen
// once a tile); tiles with no visible pair are passed over. Keys past Sk
// arrive zero-filled (their dK / dV rows are not written, and in dQ they
// multiply zero rows of K); rows past Sq get lse = +inf, so P = 0 there.
constexpr int WG_ROWS = 64;                  // rows a consumer owns
constexpr int CONSUMERS = 2;                 // consumer warpgroups
constexpr int TC_THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;                    // the Q / dO or K / V ring
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int KV_KEYS = CONSUMERS * WG_ROWS; // keys of a dK / dV block
constexpr int BQ = 64;                       // queries a dK / dV step
constexpr int BK = 128;                      // keys a dQ step
constexpr int MIN_BLOCKS = 4 * 132;          // dK / dV blocks aimed at
constexpr int MIN_STEPS = 8;                 // steps of a run at least
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == WG_ROWS && BK == KV_KEYS, "one Q and one K box size");
static_assert(BQ * 2 == 128, "a P^T row is one 128-byte swizzle row");

// A D-wide tile is NCH boxes of CH columns side by side, each ROW bytes a
// row, swizzled over ROW bytes (SWZ: the wgmma descriptor's layout type)
template <int D>
struct Box {
  static constexpr int CH = D < 64 ? D : 64;
  static constexpr int NCH = D / CH;
  static constexpr int ROW = 2 * CH;
  static constexpr uint64_t SWZ = ROW == 128 ? 1 : 2;
  static_assert(D % CH == 0 && (ROW == 128 || ROW == 64), "head dim");
};
// the shared memory of the kernels to D 128
template <int D>
struct Geo : Box<D> {
  static constexpr int KV_BYTES = KV_KEYS * D * 2;    // a K or V tile
  static constexpr int Q_BYTES = WG_ROWS * D * 2;     // a Q or dO tile
  static constexpr int PDS_BYTES = WG_ROWS * BQ * 2;  // P^T or dS^T, hi or lo
  static constexpr int BARS = 8 * (2 * STAGES + 1);
  // dK / dV: K, V; the Q / dO ring; each consumer's P^T, dS^T parts and
  // its staged lse, D
  static constexpr int DKDV_SMEM = 1024 + 2 * KV_BYTES +
                                   2 * STAGES * Q_BYTES +
                                   CONSUMERS * (4 * PDS_BYTES + 8 * BQ) +
                                   BARS;
  // dQ: each consumer's Q, dO; the K / V ring
  static constexpr int DQ_SMEM =
      1024 + 2 * CONSUMERS * Q_BYTES + 2 * STAGES * KV_BYTES + BARS;
  static_assert(DKDV_SMEM <= MAX_SMEM && DQ_SMEM <= MAX_SMEM, "smem");
};

// 2^x on the SFU (`ex2.approx`, to ~2^-22 relative; what underflows is
// flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the wgmma descriptor of 16 columns [16 kk, 16 kk + 16) of a K-major
// tile of `rows` rows at a (rows of the box-major layout above)
template <int D>
__device__ __forceinline__ uint64_t k_major(uint32_t a, int rows, int kk) {
  using G = Box<D>;
  const int c = kk * 16 / G::CH, off = (kk * 16 % G::CH) * 2;
  return gmma_desc(a + c * rows * G::ROW + off, 16, 8 * G::ROW, G::SWZ);
}
// the descriptor of rows [16 kk, 16 kk + 16) of such a tile read MN-major
// (the columns from a on): 8-row groups 8 ROW bytes apart, boxes rows ROW
// apart
template <int D>
__device__ __forceinline__ uint64_t mn_major(uint32_t a, int rows, int kk) {
  using G = Box<D>;
  return gmma_desc(a + kk * 16 * G::ROW, rows * G::ROW, 8 * G::ROW, G::SWZ);
}

__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}
// both consumer warpgroups (the D 256 kernels)
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// keys of a dK / dV block: 128 to D 128, 64 at D 256 (W_KEYS)
constexpr int W_KEYS = 64;
constexpr int dkdv_keys(int d) { return d > 128 ? W_KEYS : KV_KEYS; }

// the dK / dV walk's runs: enough blocks for 4 waves of 132 SMs, each run
// at least MIN_STEPS of the heaviest key tile's steps
int dkdv_splits(int batch, const Params& p) {
  const int keys = dkdv_keys(p.d);
  const int blocks = (p.seq_k + keys - 1) / keys * p.kv_heads * batch;
  const int i_hi = p.window > 0 && keys - 1 + p.window < p.seq
                       ? keys - 1 + p.window
                       : p.seq;
  const int steps = p.heads / p.kv_heads * ((i_hi + BQ - 1) / BQ);
  const int want = (MIN_BLOCKS + blocks - 1) / blocks;
  const int most = steps / MIN_STEPS;
  return want < most ? want : most > 1 ? most : 1;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    bwd_dkdv_wg(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ part,
                Params p, int splits) {
  using G = Geo<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base;                            // K
  const uint32_t v_s = k_s + G::KV_BYTES;               // V
  const uint32_t q_s = v_s + G::KV_BYTES;               // [STAGES] Q
  const uint32_t o_s = q_s + STAGES * G::Q_BYTES;       // [STAGES] dO
  const uint32_t pds_s = o_s + STAGES * G::Q_BYTES;     // [CONSUMERS][4]
  const uint32_t rows_s = pds_s + CONSUMERS * 4 * G::PDS_BYTES;
  const uint32_t bars = rows_s + CONSUMERS * 8 * BQ;
  const uint32_t kvbar = bars + 16 * STAGES;
  auto full = [&](int i) { return bars + 8 * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i % STAGES); };

  const int kt = blockIdx.x / splits, split = blockIdx.x % splits;
  const int k0 = kt * KV_KEYS, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  // the query tiles that see a key of the block, for every head of the
  // group: steps (g, t) in that order, this block's run of them
  const int t_lo = (p.causal ? k0 : 0) / BQ;
  const int i_hi =
      p.window > 0 ? min(p.seq, k0 + KV_KEYS - 1 + p.window) : p.seq;
  const int n_t = max(0, (i_hi + BQ - 1) / BQ - t_lo);
  const long long total = static_cast<long long>(group) * n_t;
  const int s0 = static_cast<int>(total * split / splits);
  const int n_steps = static_cast<int>(total * (split + 1) / splits) - s0;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);  // one arrival per warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * G::KV_BYTES);
      for (int c = 0; c < G::NCH; ++c) {
        const int off = c * KV_KEYS * G::ROW;
        tma_load(k_s + off, &kmap, kvbar, c * G::CH, hk, k0, b);
        tma_load(v_s + off, &vmap, kvbar, c * G::CH, hk, k0, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = s0 + i;
        const int h = hk * group + s / n_t, q0 = (t_lo + s % n_t) * BQ;
        mbar_wait(empty(i), ((i / STAGES) & 1) ^ 1);  // first pass: free
        mbar_expect_tx(full(i), 2 * G::Q_BYTES);
        for (int c = 0; c < G::NCH; ++c) {
          const int off = (i % STAGES) * G::Q_BYTES + c * BQ * G::ROW;
          tma_load(q_s + off, &qmap, full(i), c * G::CH, h, q0, b);
          tma_load(o_s + off, &omap, full(i), c * G::CH, h, q0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = warp / 4 - 1;  // consumer warpgroup: keys kw + [0, 64)
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int kw = k0 + g * WG_ROWS;
  const uint32_t ka = k_s + g * WG_ROWS * G::ROW;
  const uint32_t va = v_s + g * WG_ROWS * G::ROW;
  // P^T hi, P^T lo, dS^T hi, dS^T lo: 64 keys x 64 queries each
  const uint32_t pds = pds_s + g * 4 * G::PDS_BYTES;
  // the step's lse (log2 units) and D of its 64 queries
  float* rows = reinterpret_cast<float*>(smem + (rows_s - base)) + g * 2 * BQ;
  const float sl2 = p.scale * LOG2E;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.0f;

  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = s0 + i;
    const int h = hk * group + s / n_t, q0 = (t_lo + s % n_t) * BQ;
    const int q_last = min(q0 + BQ, p.seq) - 1;
    // whether a key of the warpgroup sees a query of the tile
    const bool live = kw < p.seq_k && (!p.causal || kw <= q_last) &&
                      (p.window <= 0 || kw + WG_ROWS - 1 > q0 - p.window);
    float staged = 0.0f;
    if (live) {
      const int q = q0 + tid % BQ;
      const size_t at = (static_cast<size_t>(b) * p.heads + h) * p.seq + q;
      staged = tid < BQ ? (q < p.seq ? lse[at] * LOG2E : INFINITY)
                        : (q < p.seq ? delta[at] : 0.0f);
    }
    mbar_wait(full(i), (i / STAGES) & 1);
    if (live) {
      const uint32_t qa = q_s + (i % STAGES) * G::Q_BYTES;
      const uint32_t oa = o_s + (i % STAGES) * G::Q_BYTES;
      // S^T = K_w Q^T and dP^T = V_w dO^T: 64 keys x 64 queries
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, k_major<D>(ka, KV_KEYS, kk), k_major<D>(qa, BQ, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, k_major<D>(va, KV_KEYS, kk), k_major<D>(oa, BQ, kk),
                 kk > 0);
      wgmma_commit();
      rows[tid] = staged;
      wg_sync(g);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, masked where the tile crosses a boundary (the loop
      // in two forms, so that interior tiles test nothing): key 16 w + gid
      // + 8 h of the warpgroup against query 8 j + c of the tile is masked
      // where c' = 8 j + c < kq + 8 h (causal) or c' >= kq + 8 h + window
      const int kq = kw + 16 * w + gid - q0 - 2 * tig;
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(rows + 8 * j + 2 * tig);
          const float2 dl =
              *reinterpret_cast<const float2*>(rows + BQ + 8 * j + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = ex2(fmaf(st[4 * j + e], sl2, (e & 1) ? -l2.y : -l2.x));
            if constexpr (decltype(masked)::value) {
              const int c = 8 * j + (e & 1), lim = kq + 8 * (e >> 1);
              if ((p.causal && c < lim) ||
                  (p.window > 0 && c >= lim + p.window))
                pv = 0.0f;
            }
            st[4 * j + e] = pv;
            dpt[4 * j + e] = pv * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
      };
      const bool edge = (p.causal && kw + WG_ROWS - 1 > q0) ||
                        (p.window > 0 && kw <= q_last - p.window);
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        // rows (keys) 16 w + gid (+ 8), queries 8 j + 2 tig (+ 1): a
        // K-major 128-byte row a key, its 16-byte chunks swizzled
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * w + gid + 8 * half;
          const uint32_t off = r * 128 + ((j ^ gid) << 4) + 4 * tig;
          uint32_t hi, lo;
          unsigned char* at = smem + (pds - base) + off;
          split_bf16(st[4 * j + 2 * half], st[4 * j + 2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(at) = hi;
          *reinterpret_cast<uint32_t*>(at + G::PDS_BYTES) = lo;
          split_bf16(dpt[4 * j + 2 * half], dpt[4 * j + 2 * half + 1], hi,
                     lo);
          *reinterpret_cast<uint32_t*>(at + 2 * G::PDS_BYTES) = hi;
          *reinterpret_cast<uint32_t*>(at + 3 * G::PDS_BYTES) = lo;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(g);

      // dV += P^T dO, then dK += dS^T Q, each tile's sum from zero: A
      // (hi, then lo) from the parts at a, B the tile at bt, MN-major
      float part[D / 2];
      auto tile_sum = [&](uint32_t a, uint32_t bt) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t bd = mn_major<D>(bt, BQ, kk);
          wgmma_ss<1>(part, gmma_desc(a + kk * 32, 16, 1024, 1), bd, kk > 0);
          wgmma_ss<1>(part,
                      gmma_desc(a + G::PDS_BYTES + kk * 32, 16, 1024, 1), bd,
                      1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
      };
      tile_sum(pds, oa);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dv[x] += part[x];
      tile_sum(pds + 2 * G::PDS_BYTES, qa);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] += part[x];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i));  // the consumer is done with it
  }

  // the run's sums, float32: part[split][dK, dV][b][key][hk][:]
  const size_t n = static_cast<size_t>(gridDim.z) * p.seq_k * p.kv_heads * D;
  float* pk = part + static_cast<size_t>(split) * 2 * n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kw + 16 * w + gid + 8 * half;
    if (key >= p.seq_k) continue;
    const size_t off =
        ((static_cast<size_t>(b) * p.seq_k + key) * p.kv_heads + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(pk + off + col) =
          make_float2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
      *reinterpret_cast<float2*>(pk + n + off + col) =
          make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
}

// dK = scale sum of the runs, dV = sum, in run order; n elements each, 4
// a thread
__global__ void __launch_bounds__(256)
    bwd_dkdv_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, size_t n, int splits,
                 float scale) {
  const size_t e = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (e >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float4 s = *reinterpret_cast<const float4*>(part + which * n + e);
    for (int r = 1; r < splits; ++r) {
      const float4 x =
          *reinterpret_cast<const float4*>(part + (2 * r + which) * n + e);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const float f = which ? 1.0f : scale;
    uint2 out;
    out.x = pack_bf16(s.x * f, s.y * f);
    out.y = pack_bf16(s.z * f, s.w * f);
    *reinterpret_cast<uint2*>((which ? dv : dk) + e) = out;
  }
}

// dQ: two slots of 64 query rows, one per consumer: with `pair` (an even
// number of query heads per KV head) heads 2 y and 2 y + 1 on the same
// rows, else rows [0, 64) and [64, 128) of one head; both share every K /
// V tile the block loads
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    bwd_dq_wg(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap dqmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              Params p, int pair) {
  using G = Geo<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;                           // [CONSUMERS] Q / dQ
  const uint32_t o_s = q_s + CONSUMERS * G::Q_BYTES;   // [CONSUMERS] dO
  const uint32_t k_s = o_s + CONSUMERS * G::Q_BYTES;   // [STAGES] K
  const uint32_t v_s = k_s + STAGES * G::KV_BYTES;     // [STAGES] V
  const uint32_t bars = v_s + STAGES * G::KV_BYTES;
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [&](int i) { return bars + 8 * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i % STAGES); };

  // causal: the last query tiles see the most keys, and start first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int rows = pair ? WG_ROWS : CONSUMERS * WG_ROWS;
  const int q0 = qt * rows, b = blockIdx.z;
  const int h0 = pair ? CONSUMERS * blockIdx.y : blockIdx.y;
  const int hk = h0 / (p.heads / p.kv_heads);
  auto slot_head = [&](int g) { return h0 + (pair ? g : 0); };
  auto slot_row = [&](int g) { return q0 + (pair ? 0 : g * WG_ROWS); };
  // key tiles of the block: [t_begin, t_begin + n_tiles)
  const int k_end = p.causal ? min(q0 + rows, p.seq_k) : p.seq_k;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int n_tiles = (k_end + BK - 1) / BK - t_begin;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, 2 * CONSUMERS * G::Q_BYTES);
      for (int g = 0; g < CONSUMERS; ++g)
        for (int c = 0; c < G::NCH; ++c) {
          const int off = g * G::Q_BYTES + c * WG_ROWS * G::ROW;
          tma_load(q_s + off, &qmap, qbar, c * G::CH, slot_head(g),
                   slot_row(g), b);
          tma_load(o_s + off, &omap, qbar, c * G::CH, slot_head(g),
                   slot_row(g), b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(empty(i), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(i), 2 * G::KV_BYTES);
        const int key = (t_begin + i) * BK;
        for (int c = 0; c < G::NCH; ++c) {
          const int off = (i % STAGES) * G::KV_BYTES + c * BK * G::ROW;
          tma_load(k_s + off, &kmap, full(i), c * G::CH, hk, key, b);
          tma_load(v_s + off, &vmap, full(i), c * G::CH, hk, key, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int g = warp / 4 - 1;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int h = slot_head(g), r0 = slot_row(g);
  const int r_last = min(r0 + WG_ROWS, p.seq) - 1;
  const uint32_t qa = q_s + g * G::Q_BYTES, oa = o_s + g * G::Q_BYTES;
  const float sl2 = p.scale * LOG2E;
  // the slot's tiles [i_lo, i_hi): those with a key for one of its rows
  int i_lo = 0, i_hi = n_tiles;
  if (p.window > 0) i_lo = max(0, r0 - p.window + 1) / BK - t_begin;
  if (p.causal) i_hi = min(n_tiles, r_last / BK + 1 - t_begin);
  if (r0 > r_last) i_hi = i_lo;
  // the thread's two rows' lse (log2 units) and D
  float l2[2], dl[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = r0 + 16 * w + gid + 8 * rh;
    const size_t at = (static_cast<size_t>(b) * p.heads + h) * p.seq + row;
    l2[rh] = row < p.seq ? lse[at] * LOG2E : INFINITY;
    dl[rh] = row < p.seq ? delta[at] : 0.0f;
  }

  float dq[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dq[x] = 0.0f;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(full(i), (i / STAGES) & 1);
    if (i >= i_lo && i < i_hi) {
      const int kt = (t_begin + i) * BK;
      const uint32_t ka = k_s + (i % STAGES) * G::KV_BYTES;
      const uint32_t va = v_s + (i % STAGES) * G::KV_BYTES;
      // S = Q K^T and dP = dO V^T: 64 rows x 128 keys
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, k_major<D>(qa, WG_ROWS, kk), k_major<D>(ka, BK, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, k_major<D>(oa, WG_ROWS, kk), k_major<D>(va, BK, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - D) into sc, masked where the tile crosses a boundary
      // (the loop in two forms): row 16 w + gid + 8 h against key 8 j + c
      // of the tile is masked where c' = 8 j + c > rk + 8 h (causal) or
      // c' <= rk + 8 h - window
      const int rk = r0 + 16 * w + gid - kt - 2 * tig;
      auto ds = [&](auto masked) {
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          const int h2 = (x & 3) >> 1;
          float pv = ex2(fmaf(sc[x], sl2, -l2[h2]));
          if constexpr (decltype(masked)::value) {
            const int c = 8 * (x >> 2) + (x & 1), lim = rk + 8 * h2;
            if ((p.causal && c > lim) || (p.window > 0 && c <= lim - p.window))
              pv = 0.0f;
          }
          sc[x] = pv * (dp[x] - dl[h2]);
        }
      };
      const bool edge = (p.causal && kt + BK - 1 > r0) ||
                        (p.window > 0 && kt <= r_last - p.window);
      if (edge)
        ds(std::true_type{});
      else
        ds(std::false_type{});

      // dQ += dS K, dS = hi + lo: the dS accumulator of keys [16 kk, 16
      // kk + 16) is, pair by pair, the A fragment of the 16-key slice
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r],
                     lo[kk][r]);
      float part[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bd = mn_major<D>(ka, BK, kk);
        wgmma_rs(part, hi[kk], bd, kk > 0);
        wgmma_rs(part, lo[kk], bd, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] += part[x];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i));
  }
  if (r0 > r_last) return;

  // epilogue: dQ scale in bf16 into the slot's Q tile (its last reader,
  // the final S product, is done), in the swizzled layout of the dQ map;
  // one TMA store per box, clipped at Sq
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = 16 * w + gid + 8 * rh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      uint32_t off = (col / G::CH) * WG_ROWS * G::ROW + row * G::ROW +
                     (col % G::CH) * 2;
      off ^= ((off >> 7) & (G::ROW / 16 - 1)) << 4;
      *reinterpret_cast<uint32_t*>(smem + (qa - base) + off) =
          pack_bf16(dq[4 * j + 2 * rh] * p.scale,
                    dq[4 * j + 2 * rh + 1] * p.scale);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(g);
  if (tid == 0) {
    for (int c = 0; c < G::NCH; ++c)
      tma_store(&dqmap, qa + c * WG_ROWS * G::ROW, c * G::CH, h, r0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------ bf16 at D 256 on the tensor cores

// At D 256 the kernels above do not fit: a consumer's dK and dV for its 64
// keys would take 256 registers a thread on their own, and 128-key tiles
// overflow shared memory. So both consumers work on the same 64 rows, and
// each product is split between them by columns (the forward's D 256 form
// walks 64-key tiles too):
//
//   * dK / dV (`bwd_dkdv_wg256`): a block per (64-key tile, KV head, batch
//     row, run), K and V resident (64 KB), Q and dO through the 2-stage
//     ring (128 KB). Consumer g computes S^T = K Q^T and dP^T = V dO^T for
//     query columns [32 g, 32 g + 32) of the 64-query step (wgmma
//     m64n32k16, 16 deep), forms P^T and dS^T there and writes their hi +
//     lo parts into one P^T / dS^T tile of the block (32 KB, K-major,
//     128-byte swizzle); after a 256-thread barrier it adds P^T dO and
//     dS^T Q over all 64 queries to head-dim columns [128 g, 128 g + 128)
//     of dV and dK (wgmma m64n128k16, B MN-major), each step's sum from a
//     zeroed partial. Registers a consumer thread: dK and dV 64 + 64, the
//     partial 64, S^T and dP^T 16 + 16. Shared memory: 230,952 of the
//     232,448 bytes a block may have, so the P^T / dS^T tile is single: a
//     second barrier a step (before the parts are written) keeps a
//     consumer from overwriting what the other still reads.
//   * dQ (`bwd_dq_wg256`): a block per (64 query rows, head, batch row), Q
//     and dO resident (64 KB), 64-key K / V tiles through the ring (128
//     KB). Consumer g computes S and dP for keys [32 g, 32 g + 32) of the
//     tile, writes dS as hi + lo into a tile of the block (16 KB), and
//     after the barrier adds dS K to columns [128 g, 128 g + 128) of dQ;
//     in the epilogue each consumer writes its columns through a TMA
//     store.
// Runs, masks (each consumer tests its own 32 columns), keys past Sk and
// rows past Sq as in the kernels above.
constexpr int W_HALF = 32;   // a consumer's columns of S^T (queries) or S
constexpr int W_COLS = 128;  // a consumer's head-dim columns of dK, dV, dQ
struct Wide {
  using B = Box<256>;
  static constexpr int TILE = W_KEYS * 256 * 2;  // 64 rows: K, V, Q or dO
  static constexpr int PART = W_KEYS * BQ * 2;   // a 64 x 64 bf16 part
  static constexpr int BARS = 8 * (2 * STAGES + 1);
  // dK / dV: K, V; the Q / dO ring; P^T hi, lo, dS^T hi, lo; each
  // consumer's staged lse and D
  static constexpr int DKDV_SMEM = 1024 + 2 * TILE + 2 * STAGES * TILE +
                                   4 * PART + CONSUMERS * 2 * W_HALF * 4 +
                                   BARS;
  // dQ: Q, dO; the K / V ring; dS hi, lo
  static constexpr int DQ_SMEM =
      1024 + 2 * TILE + 2 * STAGES * TILE + 2 * PART + BARS;
  static_assert(W_KEYS == WG_ROWS && 2 * W_HALF == BQ, "tiles");
  static_assert(DKDV_SMEM <= MAX_SMEM && DQ_SMEM <= MAX_SMEM, "smem");
};

// A consumer's columns [32 g, 32 g + 32) of a 64 x 64 tile, from its
// wgmma m64n32 accumulator x, as bf16 hi + lo into the parts at `at` (hi)
// and `at` + PART (lo): K-major, a 128-byte row a tile row, its 16-byte
// chunks swizzled
__device__ __forceinline__ void store_half(unsigned char* at,
                                           const float (&x)[W_HALF / 2],
                                           int g, int w, int gid, int tig) {
#pragma unroll
  for (int j = 0; j < W_HALF / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * w + gid + 8 * half;
      const uint32_t off =
          r * 128 + (((W_HALF / 8 * g + j) ^ gid) << 4) + 4 * tig;
      uint32_t hi, lo;
      split_bf16(x[4 * j + 2 * half], x[4 * j + 2 * half + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(at + off) = hi;
      *reinterpret_cast<uint32_t*>(at + Wide::PART + off) = lo;
    }
}

// acc = A B summed from zero: A the 64 x 64 tile at a as hi + lo parts
// (`store_half`'s layout), B 64 rows of a D 256 tile at bt read MN-major,
// 128 columns (two boxes) from bt on
__device__ __forceinline__ void wide_sum(float (&acc)[W_COLS / 2], uint32_t a,
                                         uint32_t bt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    const uint64_t bd = mn_major<256>(bt, W_KEYS, kk);
    wgmma_ss<1>(acc, gmma_desc(a + kk * 32, 16, 1024, 1), bd, kk > 0);
    wgmma_ss<1>(acc, gmma_desc(a + Wide::PART + kk * 32, 16, 1024, 1), bd,
                1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

__global__ void __launch_bounds__(TC_THREADS, 1)
    bwd_dkdv_wg256(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ part,
                   Params p, int splits) {
  constexpr int D = 256;
  using B = Wide::B;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base;                          // K
  const uint32_t v_s = k_s + Wide::TILE;              // V
  const uint32_t q_s = v_s + Wide::TILE;              // [STAGES] Q
  const uint32_t o_s = q_s + STAGES * Wide::TILE;     // [STAGES] dO
  const uint32_t pds = o_s + STAGES * Wide::TILE;     // P^T, dS^T: hi, lo
  const uint32_t rows_s = pds + 4 * Wide::PART;       // [CONSUMERS] lse, D
  const uint32_t bars = rows_s + CONSUMERS * 2 * W_HALF * 4;
  const uint32_t kvbar = bars + 16 * STAGES;
  auto full = [&](int i) { return bars + 8 * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i % STAGES); };

  const int kt = blockIdx.x / splits, split = blockIdx.x % splits;
  const int k0 = kt * W_KEYS, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  // steps (head of the group, query tile that sees a key of the block),
  // this block's run of them
  const int t_lo = (p.causal ? k0 : 0) / BQ;
  const int i_hi =
      p.window > 0 ? min(p.seq, k0 + W_KEYS - 1 + p.window) : p.seq;
  const int n_t = max(0, (i_hi + BQ - 1) / BQ - t_lo);
  const long long total = static_cast<long long>(group) * n_t;
  const int s0 = static_cast<int>(total * split / splits);
  const int n_steps = static_cast<int>(total * (split + 1) / splits) - s0;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);  // one arrival per warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * Wide::TILE);
      for (int c = 0; c < B::NCH; ++c) {
        const int off = c * W_KEYS * B::ROW;
        tma_load(k_s + off, &kmap, kvbar, c * B::CH, hk, k0, b);
        tma_load(v_s + off, &vmap, kvbar, c * B::CH, hk, k0, b);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = s0 + i;
        const int h = hk * group + s / n_t, q0 = (t_lo + s % n_t) * BQ;
        mbar_wait(empty(i), ((i / STAGES) & 1) ^ 1);  // first pass: free
        mbar_expect_tx(full(i), 2 * Wide::TILE);
        for (int c = 0; c < B::NCH; ++c) {
          const int off = (i % STAGES) * Wide::TILE + c * BQ * B::ROW;
          tma_load(q_s + off, &qmap, full(i), c * B::CH, h, q0, b);
          tma_load(o_s + off, &omap, full(i), c * B::CH, h, q0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // consumer g: queries [32 g, 32 g + 32) of S^T, columns [128 g, 128 g +
  // 128) of dK and dV
  const int g = warp / 4 - 1;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  // the step's lse (log2 units) and D of the consumer's 32 queries
  float* rows =
      reinterpret_cast<float*>(smem + (rows_s - base)) + g * 2 * W_HALF;
  unsigned char* pds_at = smem + (pds - base);
  const float sl2 = p.scale * LOG2E;

  float dk[W_COLS / 2], dv[W_COLS / 2];
#pragma unroll
  for (int x = 0; x < W_COLS / 2; ++x) dk[x] = dv[x] = 0.0f;

  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = s0 + i;
    const int h = hk * group + s / n_t, q0 = (t_lo + s % n_t) * BQ;
    const int q_last = min(q0 + BQ, p.seq) - 1;
    // whether a key of the block sees a query of the tile: the same for
    // both consumers, which meet at the barriers below
    const bool live = (!p.causal || k0 <= q_last) &&
                      (p.window <= 0 || k0 + W_KEYS - 1 > q0 - p.window);
    const int qc = q0 + W_HALF * g;  // the consumer's first query
    const int qc_last = min(qc + W_HALF, p.seq) - 1;
    float staged = 0.0f;
    if (live && tid < 2 * W_HALF) {
      const int q = qc + tid % W_HALF;
      const size_t at = (static_cast<size_t>(b) * p.heads + h) * p.seq + q;
      staged = tid < W_HALF ? (q < p.seq ? lse[at] * LOG2E : INFINITY)
                            : (q < p.seq ? delta[at] : 0.0f);
    }
    mbar_wait(full(i), (i / STAGES) & 1);
    if (live) {
      const uint32_t qa = q_s + (i % STAGES) * Wide::TILE;
      const uint32_t oa = o_s + (i % STAGES) * Wide::TILE;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x the consumer's 32 queries
      float st[W_HALF / 2], dpt[W_HALF / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, k_major<D>(k_s, W_KEYS, kk),
                 k_major<D>(qa + W_HALF * g * B::ROW, BQ, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, k_major<D>(v_s, W_KEYS, kk),
                 k_major<D>(oa + W_HALF * g * B::ROW, BQ, kk), kk > 0);
      wgmma_commit();
      if (tid < 2 * W_HALF) rows[tid] = staged;
      // the rows staged, and both consumers done with the last step's
      // P^T / dS^T parts
      pair_sync();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, masked where the consumer's columns cross a
      // boundary: key 16 w + gid + 8 h of the block against query 8 j + c
      // of the consumer's columns is masked where c' = 8 j + c < kq + 8 h
      // (causal) or c' >= kq + 8 h + window
      const int kq = k0 + 16 * w + gid - qc - 2 * tig;
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < W_HALF / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(rows + 8 * j + 2 * tig);
          const float2 dl = *reinterpret_cast<const float2*>(
              rows + W_HALF + 8 * j + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = ex2(fmaf(st[4 * j + e], sl2, (e & 1) ? -l2.y : -l2.x));
            if constexpr (decltype(masked)::value) {
              const int c = 8 * j + (e & 1), lim = kq + 8 * (e >> 1);
              if ((p.causal && c < lim) ||
                  (p.window > 0 && c >= lim + p.window))
                pv = 0.0f;
            }
            st[4 * j + e] = pv;
            dpt[4 * j + e] = pv * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
      };
      const bool edge = (p.causal && k0 + W_KEYS - 1 > qc) ||
                        (p.window > 0 && k0 <= qc_last - p.window);
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      store_half(pds_at, st, g, w, gid, tig);
      store_half(pds_at + 2 * Wide::PART, dpt, g, w, gid, tig);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      pair_sync();  // the parts of all 64 queries written

      // dV += P^T dO, then dK += dS^T Q, the consumer's 128 columns
      float acc[W_COLS / 2];
      wide_sum(acc, pds, oa + 2 * g * BQ * B::ROW);
#pragma unroll
      for (int x = 0; x < W_COLS / 2; ++x) dv[x] += acc[x];
      wide_sum(acc, pds + 2 * Wide::PART, qa + 2 * g * BQ * B::ROW);
#pragma unroll
      for (int x = 0; x < W_COLS / 2; ++x) dk[x] += acc[x];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i));  // the consumer is done with it
  }

  // the run's sums, float32: part[split][dK, dV][b][key][hk][:], the
  // consumer's columns
  const size_t n = static_cast<size_t>(gridDim.z) * p.seq_k * p.kv_heads * D;
  float* pk = part + static_cast<size_t>(split) * 2 * n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + 16 * w + gid + 8 * half;
    if (key >= p.seq_k) continue;
    const size_t off =
        ((static_cast<size_t>(b) * p.seq_k + key) * p.kv_heads + hk) * D +
        W_COLS * g;
#pragma unroll
    for (int j = 0; j < W_COLS / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(pk + off + col) =
          make_float2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
      *reinterpret_cast<float2*>(pk + n + off + col) =
          make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
    bwd_dq_wg256(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap,
                 const __grid_constant__ CUtensorMap dqmap,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, Params p) {
  constexpr int D = 256;
  using B = Wide::B;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;                          // Q, then dQ
  const uint32_t o_s = q_s + Wide::TILE;              // dO
  const uint32_t k_s = o_s + Wide::TILE;              // [STAGES] K
  const uint32_t v_s = k_s + STAGES * Wide::TILE;     // [STAGES] V
  const uint32_t ds_s = v_s + STAGES * Wide::TILE;    // dS: hi, lo
  const uint32_t bars = ds_s + 2 * Wide::PART;
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [&](int i) { return bars + 8 * (i % STAGES); };
  auto empty = [&](int i) { return bars + 8 * (STAGES + i % STAGES); };

  // causal: the last query tiles see the most keys, and start first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int r0 = qt * WG_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const int r_last = min(r0 + WG_ROWS, p.seq) - 1;
  // the key tiles the rows see: [t_begin, t_begin + n_tiles)
  const int k_end = p.causal ? min(r0 + WG_ROWS, p.seq_k) : p.seq_k;
  const int k_begin = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  const int t_begin = k_begin / W_KEYS;
  const int n_tiles = (k_end + W_KEYS - 1) / W_KEYS - t_begin;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, 2 * Wide::TILE);
      for (int c = 0; c < B::NCH; ++c) {
        const int off = c * WG_ROWS * B::ROW;
        tma_load(q_s + off, &qmap, qbar, c * B::CH, h, r0, b);
        tma_load(o_s + off, &omap, qbar, c * B::CH, h, r0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(empty(i), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(i), 2 * Wide::TILE);
        const int key = (t_begin + i) * W_KEYS;
        for (int c = 0; c < B::NCH; ++c) {
          const int off = (i % STAGES) * Wide::TILE + c * W_KEYS * B::ROW;
          tma_load(k_s + off, &kmap, full(i), c * B::CH, hk, key, b);
          tma_load(v_s + off, &vmap, full(i), c * B::CH, hk, key, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // consumer g: keys [32 g, 32 g + 32) of S, columns [128 g, 128 g + 128)
  // of dQ
  const int g = warp / 4 - 1;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  unsigned char* ds_at = smem + (ds_s - base);
  const float sl2 = p.scale * LOG2E;
  // the thread's two rows' lse (log2 units) and D
  float l2[2], dl[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = r0 + 16 * w + gid + 8 * rh;
    const size_t at = (static_cast<size_t>(b) * p.heads + h) * p.seq + row;
    l2[rh] = row < p.seq ? lse[at] * LOG2E : INFINITY;
    dl[rh] = row < p.seq ? delta[at] : 0.0f;
  }

  float dq[W_COLS / 2];
#pragma unroll
  for (int x = 0; x < W_COLS / 2; ++x) dq[x] = 0.0f;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(full(i), (i / STAGES) & 1);
    const int kc = (t_begin + i) * W_KEYS + W_HALF * g;  // consumer's keys
    const uint32_t ka = k_s + (i % STAGES) * Wide::TILE;
    const uint32_t va = v_s + (i % STAGES) * Wide::TILE;
    // S = Q K^T and dP = dO V^T: 64 rows x the consumer's 32 keys
    float sc[W_HALF / 2], dp[W_HALF / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, k_major<D>(q_s, WG_ROWS, kk),
               k_major<D>(ka + W_HALF * g * B::ROW, W_KEYS, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, k_major<D>(o_s, WG_ROWS, kk),
               k_major<D>(va + W_HALF * g * B::ROW, W_KEYS, kk), kk > 0);
    wgmma_commit();
    pair_sync();  // both consumers done with the last tile's dS parts
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - D) into sc, masked where the consumer's keys cross a
    // boundary: row 16 w + gid + 8 h against key 8 j + c of its keys is
    // masked where c' = 8 j + c > rk + 8 h (causal) or c' <= rk + 8 h -
    // window
    const int rk = r0 + 16 * w + gid - kc - 2 * tig;
    auto ds = [&](auto masked) {
#pragma unroll
      for (int x = 0; x < W_HALF / 2; ++x) {
        const int h2 = (x & 3) >> 1;
        float pv = ex2(fmaf(sc[x], sl2, -l2[h2]));
        if constexpr (decltype(masked)::value) {
          const int c = 8 * (x >> 2) + (x & 1), lim = rk + 8 * h2;
          if ((p.causal && c > lim) || (p.window > 0 && c <= lim - p.window))
            pv = 0.0f;
        }
        sc[x] = pv * (dp[x] - dl[h2]);
      }
    };
    const bool edge = (p.causal && kc + W_HALF - 1 > r0) ||
                      (p.window > 0 && kc <= r_last - p.window);
    if (edge)
      ds(std::true_type{});
    else
      ds(std::false_type{});
    store_half(ds_at, sc, g, w, gid, tig);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    pair_sync();  // the dS parts of all 64 keys written

    // dQ += dS K, the consumer's 128 columns
    float acc[W_COLS / 2];
    wide_sum(acc, ds_s, ka + 2 * g * W_KEYS * B::ROW);
#pragma unroll
    for (int x = 0; x < W_COLS / 2; ++x) dq[x] += acc[x];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i));
  }

  // epilogue: dQ scale in bf16 into the consumer's two boxes of the Q
  // tile, in the dQ map's swizzled layout; one TMA store per box, clipped
  // at Sq. The other consumer's last read of Q, its last S product, ended
  // before it reached the last tile's second barrier.
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = 16 * w + gid + 8 * rh;
#pragma unroll
    for (int j = 0; j < W_COLS / 8; ++j) {
      const int col = W_COLS * g + 8 * j + 2 * tig;
      uint32_t off = (col / B::CH) * WG_ROWS * B::ROW + row * B::ROW +
                     (col % B::CH) * 2;
      off ^= ((off >> 7) & (B::ROW / 16 - 1)) << 4;
      *reinterpret_cast<uint32_t*>(smem + off) =
          pack_bf16(dq[4 * j + 2 * rh] * p.scale,
                    dq[4 * j + 2 * rh + 1] * p.scale);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(g);
  if (tid == 0) {
    for (int c = 2 * g; c < 2 * g + 2; ++c)
      tma_store(&dqmap, q_s + c * WG_ROWS * B::ROW, c * B::CH, h, r0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------ float32 on the tensor cores

// float32 at any head dim to 256 (float32 training, the REDUCED configs'
// float32 checks), on the tensor cores as 3xTF32 with `mma.sync` m16n8k8
// (`gru_tile.cuh`): each float32 operand is split into a tf32 hi (rounded
// on its bits) and lo = x - hi, which the tensor cores read truncated to
// tf32, and a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo,
// ~2^-22 of a b, is dropped). `wgmma` takes tf32 operands K-major only, so
// dV = P^T dO and dK = dS^T Q would need dO and Q staged transposed;
// `mma.sync` with fragments read by hand takes them as they lie. The
// tensor cores' float32 accumulation does not round to nearest, so every
// chain is short: S and dP sum each 32 columns of the head dim (4
// k-steps, each pass in an accumulator of its own) into a zeroed partial
// that is then added in float32, and dV, dK, dQ sum each step's columns
// of P^T, dS^T or dS the same way.
//
// Both walks are a block of eight warps holding FR rows (the keys of a
// dK / dV block, the queries of a dQ block) and walking steps of FC
// columns (the queries that see its keys, for each query head of the
// group in turn; the keys its rows see): FR x FC = 64 x 64 to D 64, 64 x
// 32 (dK / dV) or 64 x 64 (dQ) to D 128, 32 x 32 to D 256 (`f_rows`,
// `f_cols`, `f_dq_cols`), the largest that fit shared memory with the
// step double-buffered. `cp.async` stages
// rows and steps (16 bytes a copy where D is a multiple of 4, else 4),
// the next step's copies issued before the current step is used. Rows
// hold the head dim padded with zeros to 8 NK columns (NK: its 8-column
// k-steps rounded up to 4, 8, 16 or 32, the kernels' instantiations), +
// 4 floats, so that `ldmatrix` rows and the sums' column-wise reads fall
// in distinct banks. A step: (1) each warp forms S and dP for 16 rows x 8
// NT1 columns (fragments by `ldmatrix`), then P and dS in registers
// (masked only where its sub-tile crosses the causal diagonal, the
// window's lower edge or Sk), and writes P^T and dS^T (dK / dV) or dS
// (dQ) to shared memory; (2) each warp adds P^T dO and dS^T Q (or dS K)
// for 16 rows x its half (quarter at D 256) of the head dim. The sums'
// k index is permuted (column 2 t for t, 2 t + 1 for t + 4), so that an
// A fragment is a float2 of the tile that S's accumulator layout wrote
// and B's rows fall in distinct banks, and so is their n index (column 2
// n + j % 2 of a pair of tiles j), so that a thread reads two tiles' B
// values as a float2. dK / dV blocks are cut into runs of their steps as
// the bf16 form's (`f_splits`: 4 waves of 132 SMs, 2 steps a run at
// least), added in order by `bwd_dkdv_sum_f32`.
constexpr int F_THREADS = 256;         // eight warps
constexpr int F_MIN_BLOCKS = 4 * 132;  // dK / dV blocks aimed at
constexpr int F_MIN_STEPS = 2;         // steps of a run at least

// NK of head dim d; FR rows resident, FC columns a step
__host__ __device__ constexpr int f_nk(int d) {
  return d <= 32 ? 4 : d <= 64 ? 8 : d <= 128 ? 16 : 32;
}
__host__ __device__ constexpr int f_rows(int nk) { return nk > 16 ? 32 : 64; }
__host__ __device__ constexpr int f_cols(int nk) { return nk > 8 ? 32 : 64; }
// the dQ walk's key tiles: 64 to D 128 too (its ring holds no lse or D,
// and no P^T beside dS: 221,184 bytes at D 128)
__host__ __device__ constexpr int f_dq_cols(int nk) {
  return nk > 16 ? 32 : 64;
}
// shared row strides (floats): a staged tile's, 8 NK + 4 (a quarter of it
// odd); P^T's, dS^T's and dS's, a step's FC columns + 8 (8 mod 32: float2
// reads and writes without conflicts)
__host__ __device__ constexpr int f_ld(int nk) { return 8 * nk + 4; }
__host__ __device__ constexpr int f_ldp(int fc) { return fc + 8; }
// bytes of shared memory: K, V; the Q / dO ring and its lse, D; P^T, dS^T
__host__ __device__ constexpr int f_dkdv_smem(int nk) {
  return 4 * (2 * f_rows(nk) * f_ld(nk) + 4 * f_cols(nk) * f_ld(nk) +
              4 * f_cols(nk) + 2 * f_rows(nk) * f_ldp(f_cols(nk)));
}
// Q, dO; the K / V ring; dS
__host__ __device__ constexpr int f_dq_smem(int nk) {
  return 4 * (2 * f_rows(nk) * f_ld(nk) + 4 * f_dq_cols(nk) * f_ld(nk) +
              f_rows(nk) * f_ldp(f_dq_cols(nk)));
}
static_assert(f_dkdv_smem(4) <= MAX_SMEM && f_dkdv_smem(8) <= MAX_SMEM &&
                  f_dkdv_smem(16) <= MAX_SMEM && f_dkdv_smem(32) <= MAX_SMEM,
              "smem");
static_assert(f_dq_smem(4) <= MAX_SMEM && f_dq_smem(8) <= MAX_SMEM &&
                  f_dq_smem(16) <= MAX_SMEM && f_dq_smem(32) <= MAX_SMEM,
              "smem");

// the dK / dV walk's runs: enough blocks for 4 waves of 132 SMs, each run
// at least F_MIN_STEPS of the heaviest key tile's steps
int f_splits(int batch, const Params& p) {
  const int nk = f_nk(p.d), rows = f_rows(nk), cols = f_cols(nk);
  const int blocks = (p.seq_k + rows - 1) / rows * p.kv_heads * batch;
  const int i_hi = p.window > 0 && rows - 1 + p.window < p.seq
                       ? rows - 1 + p.window
                       : p.seq;
  const int steps = p.heads / p.kv_heads * ((i_hi + cols - 1) / cols);
  const int want = (F_MIN_BLOCKS + blocks - 1) / blocks;
  const int most = steps / F_MIN_STEPS;
  return want < most ? want : most > 1 ? most : 1;
}

// n rows from row r0 of g (row stride gld floats, d columns) into s (row
// stride LD), zeros from row lim on; VEC: 16-byte copies (d a multiple of
// 4, g 16-byte aligned), else 4 bytes. Issues the copies only.
template <int LD, bool VEC>
__device__ __forceinline__ void f_stage(float* s, const float* g, size_t gld,
                                        int r0, int lim, int n, int d) {
  const int per = VEC ? d / 4 : d;
  for (int e = threadIdx.x; e < n * per; e += F_THREADS) {
    const int row = e / per, col = (e - row * per) * (VEC ? 4 : 1);
    const bool ok = r0 + row < lim;
    const float* src =
        g + static_cast<size_t>(ok ? r0 + row : 0) * gld + col;
    if constexpr (VEC)
      gru::cp_async16(s + row * LD + col, src, ok ? 16 : 0);
    else
      gru::cp_async4(s + row * LD + col, src, ok ? 4 : 0);
  }
}
// n floats from g[r0] on into s, zeros from lim on
__device__ __forceinline__ void f_stage_row(float* s, const float* g, int r0,
                                            int lim, int n) {
  for (int e = threadIdx.x; e < n; e += F_THREADS) {
    const bool ok = r0 + e < lim;
    gru::cp_async4(s + e, g + (ok ? r0 + e : 0), ok ? 4 : 0);
  }
}
// zeros in columns [d, LD) of n rows: the head dim's padding, which no
// copy writes
template <int LD>
__device__ __forceinline__ void f_zero_pad(float* s, int n, int d) {
  const int w = LD - d;
  for (int e = threadIdx.x; e < n * w; e += F_THREADS)
    s[(e / w) * LD + d + e % w] = 0.0f;
}

// four (two) 8 x 4 float32 tiles from shared memory (`ldmatrix` of 8 x 8
// b16 matrices): lane l gives the address of row l % 8 of tile l / 8 and
// gets element (l / 4, l % 4) of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c0, c1, c2 += the three passes of a b (lo hi, hi lo, hi hi), each in
// an accumulator of its own so that they do not wait on each other; b0,
// b1 the B fragment as float32 bits
__device__ __forceinline__ void mma3p(float (&c0)[4], float (&c1)[4],
                                      float (&c2)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t b0,
                                      uint32_t b1) {
  uint32_t bh0, bl0, bh1, bl1;
  gru::Tf32x3::split(__uint_as_float(b0), bh0, bl0);
  gru::Tf32x3::split(__uint_as_float(b1), bh1, bl1);
  gru::mma_tf32(c0, al, bh0, bh1);
  gru::mma_tf32(c1, ah, bl0, bl1);
  gru::mma_tf32(c2, ah, bh0, bh1);
}
// c += a b as 3xTF32 in one accumulator (the small terms first)
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  gru::Tf32x3::split(b0, bh0, bl0);
  gru::Tf32x3::split(b1, bh1, bl1);
  gru::mma_tf32(c, al, bh0, bh1);
  gru::mma_tf32(c, ah, bl0, bl1);
  gru::mma_tf32(c, ah, bh0, bh1);
}

// acc[pass][n] += one k-step of A B^T: the warp's 16 rows of A at the
// `ldmatrix` address a (lane l: row l % 8 + 8 (l / 8 % 2), column 4 (l /
// 16)) against NT 8-row tiles of B at b (lane l: row l % 8 + 8 (l / 16),
// column 4 (l / 8 % 2); tile pairs 16 rows apart)
template <int NT, int LD>
__device__ __forceinline__ void f_kstep(float (&acc)[3][NT][4], uint32_t a,
                                        uint32_t b) {
  uint32_t x[4], ah[4], al[4];
  ldsm4(x, a);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    gru::Tf32x3::split(__uint_as_float(x[e]), ah[e], al[e]);
  if constexpr (NT == 1) {
    uint32_t y[2];
    ldsm2(y, b);
    mma3p(acc[0][0], acc[1][0], acc[2][0], ah, al, y[0], y[1]);
  } else {
#pragma unroll
    for (int m = 0; m < NT / 2; ++m) {
      uint32_t y[4];
      ldsm4(y, b + m * 16 * LD * 4);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma3p(acc[0][2 * m + j], acc[1][2 * m + j], acc[2][2 * m + j], ah,
              al, y[2 * j], y[2 * j + 1]);
    }
  }
}

// s = A B^T and t = A2 B2^T over the NK k-steps (`f_kstep`'s addresses
// a, b, a2, b2), each 4 k-steps summed from zero, then added in float32.
// s[n][e]: row gid + 8 (e >> 1), column 8 n + 2 tig + (e & 1).
template <int NT, int NK, int LD>
__device__ __forceinline__ void f_gram(float (&s)[NT][4], float (&t)[NT][4],
                                       uint32_t a, uint32_t b, uint32_t a2,
                                       uint32_t b2) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = t[n][e] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < NK; k0 += 4) {
    float ps[3][NT][4], pt[3][NT][4];
#pragma unroll
    for (int z = 0; z < 3; ++z)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[z][n][e] = pt[z][n][e] = 0.0f;
#pragma unroll
    for (int kk = k0; kk < k0 + 4; ++kk) {
      f_kstep<NT, LD>(ps, a + 32 * kk, b + 32 * kk);
      f_kstep<NT, LD>(pt, a2 + 32 * kk, b2 + 32 * kk);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] += (ps[0][n][e] + ps[1][n][e]) + ps[2][n][e];
        t[n][e] += (pt[0][n][e] + pt[1][n][e]) + pt[2][n][e];
      }
  }
}

// acc (the warp's 16 rows x NT tiles of 8 columns) = the sum over a
// step's FC columns of p (16 rows from p, row stride LDP: P^T, dS^T or dS
// as phase 1 wrote them) times y (FC rows of a staged tile, from the
// warp's first column), from zero. The k index is permuted (k t of a
// k-step is its column / row 2 t, k t + 4 is 2 t + 1), and so is the n
// index: column n of tile j is y's column 16 (j / 2) + 2 n + j % 2.
template <int NT, int FC, int LD, int LDP>
__device__ __forceinline__ void f_sum(float (&acc)[NT][4], const float* p,
                                      const float* y, int gid, int tig) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < FC / 8; ++kk) {
    const float2 x0 =
        *reinterpret_cast<const float2*>(p + gid * LDP + 8 * kk + 2 * tig);
    const float2 x1 = *reinterpret_cast<const float2*>(
        p + (gid + 8) * LDP + 8 * kk + 2 * tig);
    uint32_t ah[4], al[4];
    gru::Tf32x3::split(x0.x, ah[0], al[0]);
    gru::Tf32x3::split(x1.x, ah[1], al[1]);
    gru::Tf32x3::split(x0.y, ah[2], al[2]);
    gru::Tf32x3::split(x1.y, ah[3], al[3]);
    const float* y0 = y + (8 * kk + 2 * tig) * LD + 2 * gid;
#pragma unroll
    for (int m = 0; m < NT / 2; ++m) {
      const float2 u = *reinterpret_cast<const float2*>(y0 + 16 * m);
      const float2 w = *reinterpret_cast<const float2*>(y0 + LD + 16 * m);
      mma3(acc[2 * m], ah, al, u.x, w.x);
      mma3(acc[2 * m + 1], ah, al, u.y, w.y);
    }
  }
}
// the column of a staged tile that f_sum's acc[j][e] (lane tig) sums,
// from the warp's first column
__device__ __forceinline__ int f_col(int j, int e, int tig) {
  return 16 * (j >> 1) + 4 * tig + 2 * (e & 1) + (j & 1);
}

// x[n][2 h + e] (rows gid + 8 h, columns 8 n + 2 tig + e) as float2s into
// a tile of row stride LDP from `at` (the warp's first row and column)
template <int NT, int LDP>
__device__ __forceinline__ void f_put(float* at, const float (&x)[NT][4],
                                      int gid, int tig) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(at + (gid + 8 * h) * LDP + 8 * n +
                                 2 * tig) =
          make_float2(x[n][2 * h], x[n][2 * h + 1]);
}

// dK / dV: a block per (FR-key tile, KV head, batch row, run of its
// steps); each run's sums (dK unscaled) into part[split][dK, dV][b][key]
// [hk][:]
template <int NK, bool VEC>
__global__ void __launch_bounds__(F_THREADS, 1)
    bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ part,
                 Params p, int splits) {
  constexpr int FR = f_rows(NK), FC = f_cols(NK);
  constexpr int LD = f_ld(NK), LDP = f_ldp(FC);
  constexpr int MT = FR / 16, CG = 8 / MT;  // row tiles, column groups
  constexpr int NT1 = FC / 8 / CG, NT2 = NK / CG;
  extern __shared__ __align__(16) float fs[];
  const int d = p.d;
  float* ks = fs;                 // [FR][LD]
  float* vs = ks + FR * LD;       // [FR][LD]
  float* qs = vs + FR * LD;       // [2][FC][LD]
  float* os = qs + 2 * FC * LD;   // [2][FC][LD]
  float* ls = os + 2 * FC * LD;   // [2][FC] lse
  float* dls = ls + 2 * FC;       // [2][FC] D
  float* pts = dls + 2 * FC;      // [FR][LDP] P^T
  float* dss = pts + FR * LDP;    // [FR][LDP] dS^T

  const int kt = blockIdx.x / splits, split = blockIdx.x % splits;
  const int k0 = kt * FR, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * d;
  const size_t q_ld = static_cast<size_t>(p.heads) * d;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * d;
  // steps (g, t): the query tiles that see a key of the block, for every
  // head of the group; this block's run of them
  const int t_lo = (p.causal ? k0 : 0) / FC;
  const int i_hi =
      p.window > 0 ? min(p.seq, k0 + FR - 1 + p.window) : p.seq;
  const int n_t = max(0, (i_hi + FC - 1) / FC - t_lo);
  const long long total = static_cast<long long>(group) * n_t;
  const int s0 = static_cast<int>(total * split / splits);
  const int n_steps = static_cast<int>(total * (split + 1) / splits) - s0;
  auto stage_step = [&](int i) {
    const int s = s0 + i, h = hk * group + s / n_t;
    const int q0 = (t_lo + s % n_t) * FC, st = i & 1;
    const size_t q_off = (static_cast<size_t>(b) * p.seq * p.heads + h) * d;
    const size_t row_off = (static_cast<size_t>(b) * p.heads + h) * p.seq;
    f_stage<LD, VEC>(qs + st * FC * LD, q + q_off, q_ld, q0, p.seq, FC, d);
    f_stage<LD, VEC>(os + st * FC * LD, dout + q_off, q_ld, q0, p.seq, FC,
                     d);
    f_stage_row(ls + st * FC, lse + row_off, q0, p.seq, FC);
    f_stage_row(dls + st * FC, delta + row_off, q0, p.seq, FC);
  };
  f_zero_pad<LD>(ks, 2 * FR + 4 * FC, d);  // K, V, the ring: adjacent
  f_stage<LD, VEC>(ks, k + kv_off, kv_ld, k0, p.seq_k, FR, d);
  f_stage<LD, VEC>(vs, v + kv_off, kv_ld, k0, p.seq_k, FR, d);
  if (n_steps > 0) stage_step(0);
  gru::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  // phase 1: rows (keys) 16 mt, columns 8 NT1 cg of the step; phase 2:
  // rows 16 mt, head-dim columns 8 NT2 cg on
  const int mt = warp % MT, cg = warp / MT;
  const int kw = 16 * mt, cw = 8 * NT1 * cg;
  // `ldmatrix` addresses (f_kstep): K, V rows (A), a step's Q, dO (B)
  const int a_at = (kw + lane % 8 + 8 * (lane / 8 % 2)) * LD + 4 * (lane / 16);
  const int b_at = (cw + lane % 8 + 8 * (lane / 16)) * LD + 4 * (lane / 8 % 2);
  const uint32_t ka = smem_addr(ks + a_at), va = smem_addr(vs + a_at);
  const uint32_t qb = smem_addr(qs + b_at), ob = smem_addr(os + b_at);
  const float sl2 = p.scale * LOG2E;
  float dk[NT2][4], dv[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    __syncthreads();  // step i - 1's readers are done with its buffers
    if (i + 1 < n_steps) {
      stage_step(i + 1);
      gru::cp_async_commit();
      gru::cp_async_wait<1>();
    } else {
      gru::cp_async_wait<0>();
    }
    __syncthreads();  // step i has landed, for every thread
    const int st = i & 1, q0 = (t_lo + (s0 + i) % n_t) * FC;
    const float* qt = qs + st * FC * LD;
    const float* ot = os + st * FC * LD;
    const float* lt = ls + st * FC;
    const float* dlt = dls + st * FC;

    // (1) S^T = K Q^T, dP^T = V dO^T for keys kw + [0, 16), queries cw +
    // [0, 8 NT1); P^T and dS^T, masked where the sub-tile crosses an edge
    float sv[NT1][4], tv[NT1][4];
    const uint32_t so = st * FC * LD * 4;
    f_gram<NT1, NK, LD>(sv, tv, ka, qb + so, va, ob + so);
    const int key0 = k0 + kw, qry0 = q0 + cw;
    const bool edge = key0 + 15 >= p.seq_k ||
                      (p.causal && key0 + 15 > qry0) ||
                      (p.window > 0 && key0 <= qry0 + 8 * NT1 - 1 - p.window);
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = cw + 8 * n + 2 * tig + (e & 1);
        float pv = ex2(fmaf(sv[n][e], sl2, -lt[c] * LOG2E));
        if (edge && !visible(p, q0 + c, key0 + gid + 8 * (e >> 1)))
          pv = 0.0f;
        sv[n][e] = pv;
        tv[n][e] = pv * (tv[n][e] - dlt[c]);
      }
    f_put<NT1, LDP>(pts + kw * LDP + cw, sv, gid, tig);
    f_put<NT1, LDP>(dss + kw * LDP + cw, tv, gid, tig);
    __syncthreads();

    // (2) dV += P^T dO, dK += dS^T Q: keys kw + [0, 16), the warp's
    // head-dim columns; each step's sum from zero
    float acc[NT2][4];
    f_sum<NT2, FC, LD, LDP>(acc, pts + kw * LDP, ot + 8 * NT2 * cg, gid,
                            tig);
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] += acc[n][e];
    f_sum<NT2, FC, LD, LDP>(acc, dss + kw * LDP, qt + 8 * NT2 * cg, gid,
                            tig);
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += acc[n][e];
  }

  const size_t n_el = static_cast<size_t>(gridDim.z) * p.seq_k *
                      p.kv_heads * d;
  float* pk = part + static_cast<size_t>(split) * 2 * n_el;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kw + gid + 8 * h;
    if (key >= p.seq_k) continue;
    const size_t off =
        ((static_cast<size_t>(b) * p.seq_k + key) * p.kv_heads + hk) * d;
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * NT2 * cg + f_col(n, e, tig);
        if (col < d) {
          pk[off + col] = dk[n][2 * h + e];
          pk[n_el + off + col] = dv[n][2 * h + e];
        }
      }
  }
}

// dK = scale sum of the runs, dV = sum, in run order, float32; an element
// a thread
__global__ void __launch_bounds__(256)
    bwd_dkdv_sum_f32(const float* __restrict__ part, float* __restrict__ dk,
                     float* __restrict__ dv, size_t n, int splits,
                     float scale) {
  const size_t e = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float s = part[which * n + e];
    for (int r = 1; r < splits; ++r) s += part[(2 * r + which) * n + e];
    if (which)
      dv[e] = s;
    else
      dk[e] = s * scale;
  }
}

// dQ: a block per (FR query rows, head, batch row), walking FC-key tiles
template <int NK, bool VEC>
__global__ void __launch_bounds__(F_THREADS, 1)
    bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               Params p) {
  constexpr int FR = f_rows(NK), FC = f_dq_cols(NK);
  constexpr int LD = f_ld(NK), LDP = f_ldp(FC);
  constexpr int MT = FR / 16, CG = 8 / MT;
  constexpr int NT1 = FC / 8 / CG, NT2 = NK / CG;
  extern __shared__ __align__(16) float fs[];
  const int d = p.d;
  float* qs = fs;                 // [FR][LD]
  float* os = qs + FR * LD;       // [FR][LD]
  float* ks = os + FR * LD;       // [2][FC][LD]
  float* vs = ks + 2 * FC * LD;   // [2][FC][LD]
  float* dss = vs + 2 * FC * LD;  // [FR][LDP] dS

  // causal: the last query tiles see the most keys, and start first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * FR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.heads / p.kv_heads);
  const size_t kv_ld = static_cast<size_t>(p.kv_heads) * d;
  const size_t q_ld = static_cast<size_t>(p.heads) * d;
  const size_t kv_off =
      (static_cast<size_t>(b) * p.seq_k * p.kv_heads + hk) * d;
  const size_t q_off = (static_cast<size_t>(b) * p.seq * p.heads + h) * d;
  const size_t row_off = (static_cast<size_t>(b) * p.heads + h) * p.seq;
  // the key tiles the rows see: [t_begin, t_begin + n_tiles)
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? min(q0 + FR, p.seq_k) : p.seq_k;
  const int t_begin = k_begin / FC;
  const int n_tiles = (k_end + FC - 1) / FC - t_begin;
  auto stage_tile = [&](int i) {
    const int key = (t_begin + i) * FC, st = i & 1;
    f_stage<LD, VEC>(ks + st * FC * LD, k + kv_off, kv_ld, key, p.seq_k,
                     FC, d);
    f_stage<LD, VEC>(vs + st * FC * LD, v + kv_off, kv_ld, key, p.seq_k,
                     FC, d);
  };
  f_zero_pad<LD>(qs, 2 * FR + 4 * FC, d);  // Q, dO, the ring: adjacent
  f_stage<LD, VEC>(qs, q + q_off, q_ld, q0, p.seq, FR, d);
  f_stage<LD, VEC>(os, dout + q_off, q_ld, q0, p.seq, FR, d);
  if (n_tiles > 0) stage_tile(0);
  gru::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int mt = warp % MT, cg = warp / MT;
  const int rw = 16 * mt, cw = 8 * NT1 * cg;
  // `ldmatrix` addresses (f_kstep): Q, dO rows (A), a tile's K, V (B)
  const int a_at = (rw + lane % 8 + 8 * (lane / 8 % 2)) * LD + 4 * (lane / 16);
  const int b_at = (cw + lane % 8 + 8 * (lane / 16)) * LD + 4 * (lane / 8 % 2);
  const uint32_t qa = smem_addr(qs + a_at), oa = smem_addr(os + a_at);
  const uint32_t kb = smem_addr(ks + b_at), vb = smem_addr(vs + b_at);
  const float sl2 = p.scale * LOG2E;
  // the thread's two rows' lse (log2 units) and D
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + gid + 8 * r;
    l2[r] = row < p.seq ? lse[row_off + row] * LOG2E : INFINITY;
    dl[r] = row < p.seq ? delta[row_off + row] : 0.0f;
  }
  float acc_q[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_q[n][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    __syncthreads();  // tile i - 1's readers are done with its buffers
    if (i + 1 < n_tiles) {
      stage_tile(i + 1);
      gru::cp_async_commit();
      gru::cp_async_wait<1>();
    } else {
      gru::cp_async_wait<0>();
    }
    __syncthreads();  // tile i has landed, for every thread
    const int st = i & 1, kt0 = (t_begin + i) * FC;
    const float* kt = ks + st * FC * LD;

    // (1) S = Q K^T, dP = dO V^T for rows rw + [0, 16), keys cw + [0, 8
    // NT1); dS, masked where the sub-tile crosses an edge
    float sv[NT1][4], tv[NT1][4];
    const uint32_t so = st * FC * LD * 4;
    f_gram<NT1, NK, LD>(sv, tv, qa, kb + so, oa, vb + so);
    const int row0 = q0 + rw, key0 = kt0 + cw, key_last = key0 + 8 * NT1 - 1;
    const bool edge = key_last >= p.seq_k ||
                      (p.causal && key_last > row0) ||
                      (p.window > 0 && key0 <= row0 + 15 - p.window);
#pragma unroll
    for (int n = 0; n < NT1; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = ex2(fmaf(sv[n][e], sl2, -l2[r]));
        if (edge && !visible(p, row0 + gid + 8 * r,
                             key0 + 8 * n + 2 * tig + (e & 1)))
          pv = 0.0f;
        sv[n][e] = pv * (tv[n][e] - dl[r]);
      }
    f_put<NT1, LDP>(dss + rw * LDP + cw, sv, gid, tig);
    __syncthreads();

    // (2) dQ += dS K: rows rw + [0, 16), the warp's head-dim columns
    float acc[NT2][4];
    f_sum<NT2, FC, LD, LDP>(acc, dss + rw * LDP, kt + 8 * NT2 * cg, gid,
                            tig);
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_q[n][e] += acc[n][e];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + gid + 8 * r;
    if (row >= p.seq) continue;
    float* out = dq + q_off + static_cast<size_t>(row) * q_ld;
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * NT2 * cg + f_col(n, e, tig);
        if (col < d) out[col] = acc_q[n][2 * r + e] * p.scale;
      }
  }
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

// the floats of the dK / dV runs' scratch a call needs
size_t scratch_floats(int batch, const Params& p, int is_bf16) {
  const int splits = takes_wgmma(is_bf16, p.d) ? dkdv_splits(batch, p)
                                               : f_splits(batch, p);
  return static_cast<size_t>(splits) * 2 * batch * p.seq_k * p.kv_heads *
         p.d;
}

// bf16 at head dim D (32, 64, 128 or 256) on the tensor cores
template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, int batch, const Params& p,
              float* delta, float* part, void* dq, void* dk, void* dv,
              cudaStream_t st) {
  constexpr bool wide = D > 128;
  constexpr int ch = Box<D>::CH, keys = dkdv_keys(D);
  CUtensorMap qm, km, vm, om, dqm;
  if (!tensor_map_bf16(&qm, q, batch, p.seq, p.heads, D, ch, WG_ROWS) ||
      !tensor_map_bf16(&om, dout, batch, p.seq, p.heads, D, ch, WG_ROWS) ||
      !tensor_map_bf16(&dqm, dq, batch, p.seq, p.heads, D, ch, WG_ROWS) ||
      !tensor_map_bf16(&km, k, batch, p.seq_k, p.kv_heads, D, ch, keys) ||
      !tensor_map_bf16(&vm, v, batch, p.seq_k, p.kv_heads, D, ch, keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if constexpr (wide) {
    err = allow_smem<bwd_dkdv_wg256>(Wide::DKDV_SMEM);
    if (err == cudaSuccess) err = allow_smem<bwd_dq_wg256>(Wide::DQ_SMEM);
  } else {
    err = allow_smem<bwd_dkdv_wg<D>>(Geo<D>::DKDV_SMEM);
    if (err == cudaSuccess) err = allow_smem<bwd_dq_wg<D>>(Geo<D>::DQ_SMEM);
  }
  if (err == cudaSuccess)
    err = launch_delta<__nv_bfloat16>(o, dout, batch, p, delta, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* tl = static_cast<const float*>(lse);
  const int splits = dkdv_splits(batch, p);
  const dim3 dkdv_grid((p.seq_k + keys - 1) / keys * splits, p.kv_heads,
                       batch);
  if constexpr (wide)
    bwd_dkdv_wg256<<<dkdv_grid, TC_THREADS, Wide::DKDV_SMEM, st>>>(
        qm, km, vm, om, tl, delta, part, p, splits);
  else
    bwd_dkdv_wg<D><<<dkdv_grid, TC_THREADS, Geo<D>::DKDV_SMEM, st>>>(
        qm, km, vm, om, tl, delta, part, p, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(batch) * p.seq_k * p.kv_heads * D;
  bwd_dkdv_sum<<<(n / 4 + 255) / 256, 256, 0, st>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      n, splits, p.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (wide) {
    bwd_dq_wg256<<<dim3((p.seq + WG_ROWS - 1) / WG_ROWS, p.heads, batch),
                   TC_THREADS, Wide::DQ_SMEM, st>>>(qm, km, vm, om, dqm, tl,
                                                    delta, p);
  } else {
    const int pair = (p.heads / p.kv_heads) % CONSUMERS == 0;
    const int rows = pair ? WG_ROWS : CONSUMERS * WG_ROWS;
    bwd_dq_wg<D><<<dim3((p.seq + rows - 1) / rows,
                        pair ? p.heads / CONSUMERS : p.heads, batch),
                   TC_THREADS, Geo<D>::DQ_SMEM, st>>>(qm, km, vm, om, dqm, tl,
                                                      delta, p, pair);
  }
  return static_cast<int>(cudaGetLastError());
}

// float32 at head dims to 8 NK on the tensor cores (3xTF32): four
// launches, as the bf16 form's
template <int NK, bool VEC>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, int batch, const Params& p,
               float* delta, float* part, void* dq, void* dk, void* dv,
               cudaStream_t st) {
  constexpr int FR = f_rows(NK);
  cudaError_t err =
      allow_smem<bwd_dkdv_f32<NK, VEC>>(f_dkdv_smem(NK));
  if (err == cudaSuccess)
    err = allow_smem<bwd_dq_f32<NK, VEC>>(f_dq_smem(NK));
  if (err == cudaSuccess)
    err = launch_delta<float>(o, dout, batch, p, delta, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* tl = static_cast<const float*>(lse);
  const int splits = f_splits(batch, p);
  bwd_dkdv_f32<NK, VEC>
      <<<dim3((p.seq_k + FR - 1) / FR * splits, p.kv_heads, batch),
         F_THREADS, f_dkdv_smem(NK), st>>>(tq, tk, tv, tdo, tl, delta,
                                                part, p, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(batch) * p.seq_k * p.kv_heads * p.d;
  bwd_dkdv_sum_f32<<<(n + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(dk), static_cast<float*>(dv), n, splits,
      p.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_f32<NK, VEC><<<dim3((p.seq + FR - 1) / FR, p.heads, batch),
                        F_THREADS, f_dq_smem(NK), st>>>(
      tq, tk, tv, tdo, tl, delta, static_cast<float*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

// float32 at any head dim to 256
template <bool VEC>
int dispatch_f32(const void* q, const void* k, const void* v, const void* o,
                 const void* lse, const void* dout, int batch,
                 const Params& p, float* delta, float* part, void* dq,
                 void* dk, void* dv, cudaStream_t st) {
  switch (f_nk(p.d)) {
    case 4: return launch_f32<4, VEC>(q, k, v, o, lse, dout, batch, p, delta,
                                      part, dq, dk, dv, st);
    case 8: return launch_f32<8, VEC>(q, k, v, o, lse, dout, batch, p, delta,
                                      part, dq, dk, dv, st);
    case 16: return launch_f32<16, VEC>(q, k, v, o, lse, dout, batch, p,
                                        delta, part, dq, dk, dv, st);
    default: return launch_f32<32, VEC>(q, k, v, o, lse, dout, batch, p,
                                        delta, part, dq, dk, dv, st);
  }
}

}  // namespace

namespace {

// the call's parameters, or false where the kernels do not take it
bool params_of(int seq_q, int seq_k, int heads, int kv_heads, int head_dim,
               int causal, int window, int is_bf16, Params* p) {
  if (kv_heads <= 0 || heads % kv_heads || head_dim <= 0 ||
      head_dim > 256 || (is_bf16 && !takes_wgmma(1, head_dim)) || seq_k <= 0 ||
      seq_q <= 0 || ((causal || window > 0) && seq_k != seq_q))
    return false;
  *p = Params{seq_q,  seq_k,  heads,    kv_heads,
              causal, window, head_dim,
              1.0f / sqrtf(static_cast<float>(head_dim))};
  return true;
}

}  // namespace

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D); all
// bfloat16 (is_bf16 = 1; D 32, 64, 128 or 256) or all float32 (D <= 256),
// contiguous, 16-byte aligned; lse (B, H, Sq) float32 from
// `flash_attention_fwd`; delta: (B, H, Sq) float32 scratch; part:
// `part_floats` float32 of scratch, as many as
// `flash_attention_bwd_scratch` gives for the call (else refused). H a
// multiple of Hkv; window <= 0 for none; Sk >= 1, and Sk = Sq where the
// call is causal or has a window. Four launches on `stream` in both
// forms; returns the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   int batch, int seq_q, int seq_k,
                                   int heads, int kv_heads, int head_dim,
                                   int causal, int window, int is_bf16,
                                   void* delta, void* part,
                                   long long part_floats, void* dq,
                                   void* dk, void* dv, void* stream) {
  if (batch == 0 || heads == 0) return 0;
  Params p;
  if (!params_of(seq_q, seq_k, heads, kv_heads, head_dim, causal, window,
                 is_bf16, &p) ||
      static_cast<size_t>(part_floats) !=
          scratch_floats(batch, p, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  // float32 takes any head dim (the calls' contract); no model's is
  // off a multiple of 4, only test shapes such as D 21 take the
  // 4-byte copies
  if (!is_bf16)
    return head_dim % 4 == 0
               ? dispatch_f32<true>(q, k, v, o, lse, dout, batch, p, dl, pt,
                                    dq, dk, dv, st)
               : dispatch_f32<false>(q, k, v, o, lse, dout, batch, p, dl, pt,
                                     dq, dk, dv, st);
  switch (head_dim) {
    case 32: return launch_tc<32>(q, k, v, o, lse, dout, batch, p, dl, pt,
                                  dq, dk, dv, st);
    case 64: return launch_tc<64>(q, k, v, o, lse, dout, batch, p, dl, pt,
                                  dq, dk, dv, st);
    case 128: return launch_tc<128>(q, k, v, o, lse, dout, batch, p, dl, pt,
                                    dq, dk, dv, st);
    default: return launch_tc<256>(q, k, v, o, lse, dout, batch, p, dl, pt,
                                   dq, dk, dv, st);
  }
}

// The float32 scratch (`part`) that `flash_attention_bwd` needs for the
// call: the dK / dV runs' sums, (splits, 2, B, Sk, Hkv, D), in either
// form; -1 for a call the kernels refuse. Launches nothing.
extern "C" long long flash_attention_bwd_scratch(int batch, int seq_q,
                                                 int seq_k, int heads,
                                                 int kv_heads, int head_dim,
                                                 int causal, int window,
                                                 int is_bf16) {
  Params p;
  if (!params_of(seq_q, seq_k, heads, kv_heads, head_dim, causal, window,
                 is_bf16, &p))
    return -1;
  return static_cast<long long>(scratch_floats(batch, p, is_bf16));
}

// The dQ walk's tile in the form that takes a call at (head_dim,
// is_bf16): *rows queries by *keys keys, key tiles starting at multiples
// of *keys. Launches nothing.
extern "C" void flash_attention_bwd_dq_tile(int head_dim, int is_bf16,
                                            int* rows, int* keys) {
  if (takes_wgmma(is_bf16, head_dim)) {
    *rows = WG_ROWS;
    *keys = head_dim > 128 ? W_KEYS : BK;
  } else {
    *rows = f_rows(f_nk(head_dim));
    *keys = f_dq_cols(f_nk(head_dim));
  }
}
