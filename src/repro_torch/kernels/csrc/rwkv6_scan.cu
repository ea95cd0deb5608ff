// RWKV6 (Finch) WKV recurrence with state carry, forward: a chunked kernel
// on the tensor cores (S >= 64 through ops.rwkv6) and a sequential one
// (decode, S < 64).
//
// Replaces the TPU kernel `_wkv_kernel` of src/repro/kernels/rwkv6_scan.py
// (entry `rwkv6_chunked`). Per (batch b, head h), with the head dim Dk = Dv
// = 64:
//
//   o_t = r_t^T S_{t-1} + (r_t . (u (.) k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// which is `rwkv6_ref`'s o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T). The
// state starts from `s0` (or zeros); the final state is written out of
// place. r, k, v, w and o are in the model's (B, S, H, 64) layout.
//
// Bound on an H100 at the prompt-scoring shape (B 4, H 32, S 2048, bf16 r,
// k, v and o, float32 w): the bytes, each input read once and o written
// once, ~201 MB, take 60.7 us at 3.35 TB/s; the chunked form's products,
// counted with their passes at the rates they use (below), ~30 us. So the
// function is bound by bytes. (The scan's count, 5 float32 operations per
// state element per token, is 80 us at 67 TFLOP/s.)
//
// The chunked kernel (`wkv_chunked_kernel`). The TPU kernel cuts the
// sequence into chunks of C = 64 tokens and turns each into matrix
// products; so does this one, with every decay factor at most 1 by
// construction, so that nothing overflows for any w in (0, 1]. (The TPU
// form centres its exponents on half the chunk's log-decay and stays in
// float32 range only for |log w| * C below about 80.) With the chunk cut
// into NS = 8 sub-chunks of SUB = 8 tokens and W(i, j) = prod_{j < s < i}
// w_s the weight of key j at query i:
//
//   * within a sub-chunk (j < i): per element, the product chain k_j
//     w_{j+1} ... w_{i-1} in float32 dotted with r_i; the bonus (r_j . (u
//     (.) k_j)) on the diagonal. A lane holds two channels of a sub-chunk;
//     the 36 sums of a block are reduced across the warp's lanes by a
//     butterfly reduce-scatter;
//   * across sub-chunks (key sub-chunk b < query sub-chunk a): reference
//     points at the sub-chunk edges. Q_i = r_i prod_{start(a) <= s < i} w_s,
//     K_j = k_j prod_{j < s <= end(b)} w_s and g(a, b) = the product of the
//     whole sub-chunks strictly between: W(i, j) = Q_i g(a, b) K_j, each
//     factor <= 1, so a factor underflows only where the true weight does.
//     16 tiles of 16 x 8 on mma.sync, 3xTF32 (gru_tile.cuh's split);
//   * the carried state: o += (Q_i rho_a) S_0 with rho_a the product of the
//     sub-chunks before a; S_C = dec S_0 + sum_j (K_j kappa_b) v_j^T with
//     kappa_b the product of the sub-chunks after b and dec the chunk's.
// The decays are products of w, as the token scan forms them, not
// exponentials of summed logarithms: no log or exp, and no cancellation in
// a difference of large cumulative sums.
//
// o = (Q rho) S_0 + A V and the state's update run on wgmma (m64n64k16,
// bf16, float32 accumulators) at float32 precision: each float32 operand is
// split on its bits into three bf16 parts, hi + mid + lo, exactly, and a
// product takes the terms down to 2^-16 of hi hi, six wgmma per 16-deep
// step, three where B is a bf16 v (its own one part). The A operands come
// from registers, the B operands (v, and the state's parts) from 128-byte
// swizzled tiles in shared memory.
//
// One block of two warpgroups per (b, h); warpgroup 0 owns o, warpgroup 1
// keeps the state in registers, so no chunk state goes through device
// memory. Per chunk: (1) every warp: Q, K and the sub-chunk products of
// its sub-chunk, and its diagonal block; (2) the products before, after
// and between sub-chunks; (3) warpgroup 0 issues (Q rho) S_0 and
// warpgroup 1 (K kappa)^T V, while every warp forms two cross tiles; (4)
// warpgroup 0 adds A V and stages o for 16-byte stores, warpgroup 1 splits
// the state for the next chunk. TMA stages the next chunk's r, k, v, w
// meanwhile (rows past the sequence read as zero; w is taken as 1 there).
// Sums in a fixed order, no atomics: two calls give the same bits. What
// limits it: ptxas serializes the wgmma of the warpgroups' two branches
// (a branch uniform to it lifts that, but the A registers then in flight
// spill), and phases (1) and (4) wait on their own latency with 8 warps.
//
// The sequential kernel (`wkv_seq_kernel`): one block of 256 threads per
// (b, h); thread (j, q) owns state column j, rows [16q, 16q + 16), in
// registers; one token at a time, as the scan. At decode's S 1 the state's
// 2 MB read and 2 MB write bound both kernels, and this one does no
// chunk's worth of products for one token.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "gru_tile.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// two adjacent float32 outputs (p 8-byte aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// ------------------------------------------------------------ sequential

namespace scan {

constexpr int D = 64;                 // head dim (Dk = Dv)
constexpr int KSPLIT = 4;             // row groups per state column
constexpr int ROWS = D / KSPLIT;      // 16 state rows per thread
constexpr int THREADS = D * KSPLIT;   // 256
constexpr int TILE = 32;              // tokens staged per round
constexpr int PAD_ROW = ROWS + 4;     // 20: row groups start on distinct banks
constexpr int STRIDE = KSPLIT * PAD_ROW;  // 80 floats per staged token
constexpr int PER = TILE * D / THREADS;   // 8 elements per thread per tile

// Every TILE tokens the block stages r, k, w (float32, each row padded so
// the four row groups of a warp hit distinct banks) and v in shared
// memory, and one warp per token forms the bonus scalar. Per token and
// thread: 16 multiplies and 32 fused multiply-adds, then a two-step
// shuffle sums the four row groups' partial outputs. The next tile's loads
// are issued into registers before the current tile's token loop.
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
wkv_seq_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
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

  // Token t of (b, h) starts at base + t * tstride.
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

}  // namespace scan

// --------------------------------------------------------------- chunked

namespace chunked {

using gru::Tf32x3;

constexpr int D = 64;             // head dim (Dk = Dv)
constexpr int C = 64;             // tokens per chunk
constexpr int SUB = 8;            // tokens per sub-chunk
constexpr int NS = C / SUB;       // sub-chunks per chunk
constexpr int THREADS = 256;      // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int LA = D + 4;         // row stride of the float32 [token][channel]
                                  // tiles: fragment reads hit 32 banks
constexpr int LO = D + 8;         // row stride of the staged o
constexpr int TILES = 16;         // cross-sub-chunk 16 x 8 score tiles
constexpr int NPAIR = SUB * (SUB - 1) / 2;   // 28 pairs j < i in a block
constexpr int ITEMS = NPAIR + SUB;           // and 8 bonuses
static_assert(C == 64 && SUB == 8 && D == 64, "the tiles below assume these");
static_assert(TILES == 2 * WARPS, "two score tiles per warp");

constexpr int PART = C * D * 2;   // one bfloat16 [64][64] swizzled tile

// Shared memory, bytes from a 1024-byte aligned base. The wgmma B operands,
// v and the state, are bfloat16 parts (hi + mid + lo: float32's 24 bits),
// each a [64][64] MN-major tile with 128-byte rows swizzled as TMA's
// 128-byte mode lays them out (16-byte chunk c of row x at chunk c ^ (x %
// 8)).
template <typename TI>
struct Smem {
  static constexpr int NV = sizeof(TI) == 2 ? 1 : 3;   // v's parts
  static constexpr int V = 0;                      // [NV] v [t][j]
  static constexpr int S = V + NV * PART;          // [3] state [d][j]
  static constexpr int Q = S + 3 * PART;           // [C][LA] Q, float32
  static constexpr int K = Q + C * LA * 4;         // [C][LA] K
  static constexpr int A = K + C * LA * 4;         // [C][LA] weights A
  static constexpr int O = A + C * LA * 4;         // [C][LO] o, float32
  static constexpr int OM = O + C * LO * 4;        // [NS][D] sub-chunk products
  static constexpr int RHO = OM + NS * D * 4;      // [NS][D] ... before
  static constexpr int KAP = RHO + NS * D * 4;     // [NS][D] ... after
  static constexpr int G = KAP + NS * D * 4;       // [NPAIR][D] ... between
  static constexpr int DEC = G + NPAIR * D * 4;    // [D] ... over the chunk
  static constexpr int RAW = (DEC + D * 4 + 127) / 128 * 128;  // TMA boxes
  static constexpr int RAW_BYTES =
      C * D * (3 * static_cast<int>(sizeof(TI)) + 4);  // r, k, v, w
  static constexpr int BAR = RAW + RAW_BYTES;      // the staging's mbarrier
  static constexpr int BYTES = 1024 + BAR + 8;
};
static_assert(Smem<float>::BYTES <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (x, col) of a swizzled [64][64] bfloat16 tile
__device__ __forceinline__ int sw128(int x, int col) {
  return x * 128 + ((((col >> 3) ^ (x & 7)) << 4) | ((col & 7) << 1));
}

// (x, y) = hi + mid + lo, exactly: each part a bfloat16 cut from the
// float32 bits (hi the top 8 significant bits, mid the next 8 of the exact
// remainder, lo the rest), the parts of x and y packed two a register, x
// in the low half
__device__ __forceinline__ void split3x2(float x, float y, uint32_t (&p)[3]) {
  constexpr uint32_t TOP = 0xffff0000u;
  const uint32_t x0 = __float_as_uint(x) & TOP, y0 = __float_as_uint(y) & TOP;
  const float xr = x - __uint_as_float(x0), yr = y - __uint_as_float(y0);
  const uint32_t x1 = __float_as_uint(xr) & TOP, y1 = __float_as_uint(yr) & TOP;
  const uint32_t x2 = __float_as_uint(xr - __uint_as_float(x1));
  const uint32_t y2 = __float_as_uint(yr - __uint_as_float(y1));
  p[0] = __byte_perm(x0, y0, 0x7632);
  p[1] = __byte_perm(x1, y1, 0x7632);
  p[2] = __byte_perm(x2, y2, 0x7632);
}

// wgmma shared-memory descriptor of an MN-major swizzled tile (rows along
// K, 128 bytes of N each) at addr: start address, leading and stride byte
// offsets (16-byte units; 8-row groups 1024 bytes apart), layout type (1:
// 128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t lbo = C * 128, sbo = 8 * 128;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         ((sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// generic-proxy writes of shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64) += A B: A (64 x 16) from registers, each warp's 16 rows in
// the mma.sync m16n8k16 A layout; B (16 x 64) a swizzled [k][n] tile in
// shared memory (MN-major). The accumulator: element e of n8 block j of a
// thread (warp w of the warpgroup, lane 4 g + t) is row 16 w + g + 8 (e >>
// 1), column 8 j + 2 t + (e & 1), at index 4 j + e.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// acc += A B over K = 64 in four 16-deep steps at float32 precision from
// bfloat16 parts: A = a0 + a1 + a2 (parts of the float32 values that
// `aval(kk, v)` gives, v[8] the A fragment of step kk) and B = b0 + b1 +
// b2 (NB parts at b, b + PART, ...; NB = 1 for a bfloat16 B). Per step the
// terms down to 2^-16 of a0 b0 (a1 b0, a2 b0 and, with NB = 3, a0 b1, a0
// b2, a1 b1) go in first, a0 b0 last. Issued, not waited for.
template <int NB, class AVal>
__device__ __forceinline__ void product_rs(float (&acc)[32], uint32_t b,
                                           AVal aval) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float v[8];
    aval(kk, v);
    uint32_t a[3][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t p[3];
      split3x2(v[2 * r], v[2 * r + 1], p);
      a[0][r] = p[0];
      a[1][r] = p[1];
      a[2][r] = p[2];
    }
    const uint32_t bk = b + kk * 16 * 128;
    wgmma(acc, a[2], desc(bk));
    wgmma(acc, a[1], desc(bk));
    if constexpr (NB == 3) {
      wgmma(acc, a[0], desc(bk + 2 * PART));
      wgmma(acc, a[1], desc(bk + PART));
      wgmma(acc, a[0], desc(bk + PART));
    }
    wgmma(acc, a[0], desc(bk));
  }
}

// c[p] += the tf32 pass p of a b (lo hi, hi lo, hi hi), three independent
// accumulators
__device__ __forceinline__ void mma3(float (&c)[3][4], const Tf32x3::A& a,
                                     const Tf32x3::B& b) {
  gru::mma_tf32(c[0], a.lo, b.hi[0], b.hi[1]);
  gru::mma_tf32(c[1], a.hi, b.lo[0], b.lo[1]);
  gru::mma_tf32(c[2], a.hi, b.hi[0], b.hi[1]);
}

// Butterfly step of a reduce-scatter across the lanes: lanes that differ
// in bit m swap halves of x[0, N) and add, the lane with the bit set
// keeping the upper half; x[0, N / 2) holds the result.
template <int N>
__device__ __forceinline__ void halve(float* x, int m) {
  const bool up = (threadIdx.x & m) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = up ? x[N / 2 + i] : x[i];
    const float send = up ? x[i] : x[N / 2 + i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// (i, j) of item p of a diagonal block: pair i (i - 1) / 2 + j (j < i),
// then the bonuses NPAIR + j
__constant__ int2 kItems[ITEMS] = {
    {1, 0}, {2, 0}, {2, 1}, {3, 0}, {3, 1}, {3, 2}, {4, 0}, {4, 1}, {4, 2},
    {4, 3}, {5, 0}, {5, 1}, {5, 2}, {5, 3}, {5, 4}, {6, 0}, {6, 1}, {6, 2},
    {6, 3}, {6, 4}, {6, 5}, {7, 0}, {7, 1}, {7, 2}, {7, 3}, {7, 4}, {7, 5},
    {7, 6}, {0, 0}, {1, 1}, {2, 2}, {3, 3}, {4, 4}, {5, 5}, {6, 6}, {7, 7}};
__device__ __forceinline__ int2 item_ij(int p) { return kItems[p]; }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// box at (c0, c1, c2, c3) of `map` into shared memory at dst, completing
// its bytes on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The chunk's r, k, v [C][64] of TI and w [C][64] float32 of (b, h) from
// token t0 into shared memory at stg, one TMA box each (rows past the
// sequence zero); they arrive on the mbarrier bar. One thread.
template <typename TI>
__device__ __forceinline__ void stage(uint32_t stg, uint32_t bar,
                                      const CUtensorMap* rm,
                                      const CUtensorMap* km,
                                      const CUtensorMap* vm,
                                      const CUtensorMap* wm, int b, int h,
                                      int t0) {
  constexpr uint32_t TB = C * D * sizeof(TI);
  mbar_expect_tx(bar, 3 * TB + C * D * 4);
  tma_load(stg, rm, bar, 0, h, t0, b);
  tma_load(stg + TB, km, bar, 0, h, t0, b);
  tma_load(stg + 2 * TB, vm, bar, 0, h, t0, b);
  tma_load(stg + 3 * TB, wm, bar, 0, h, t0, b);
}

__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_f2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the staged v's parts into the swizzled tiles (a bf16 v is its own part)
__device__ __forceinline__ void put_v(unsigned char* vp,
                                      const __nv_bfloat16* rv) {
  for (int e = threadIdx.x; e < C * D / 8; e += THREADS) {
    const int row = e / 8, col = (e % 8) * 8;
    *reinterpret_cast<uint4*>(vp + sw128(row, col)) =
        *reinterpret_cast<const uint4*>(rv + row * D + col);
  }
}
__device__ __forceinline__ void put_v(unsigned char* vp, const float* rv) {
  for (int e = threadIdx.x; e < C * D / 4; e += THREADS) {
    const int row = e / 16, col = (e % 16) * 4;
    const float4 f = *reinterpret_cast<const float4*>(rv + row * D + col);
    uint32_t lo[3], hi[3];
    split3x2(f.x, f.y, lo);
    split3x2(f.z, f.w, hi);
#pragma unroll
    for (int pt = 0; pt < 3; ++pt)
      *reinterpret_cast<uint2*>(vp + pt * PART + sw128(row, col)) =
          make_uint2(lo[pt], hi[pt]);
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
wkv_chunked_kernel(const __grid_constant__ CUtensorMap rmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   int heads, int seq, TO* __restrict__ o,
                   float* __restrict__ s_out) {
  using L = Smem<TI>;
  constexpr int NB = L::NV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base_a = (raw0 + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base_a - raw0);
  unsigned char* vp = sm + L::V;
  unsigned char* sp = sm + L::S;
  float* sq = reinterpret_cast<float*>(sm + L::Q);
  float* skk = reinterpret_cast<float*>(sm + L::K);
  float* sa = reinterpret_cast<float*>(sm + L::A);
  float* so = reinterpret_cast<float*>(sm + L::O);
  float* som = reinterpret_cast<float*>(sm + L::OM);
  float* srho = reinterpret_cast<float*>(sm + L::RHO);
  float* skap = reinterpret_cast<float*>(sm + L::KAP);
  float* sg = reinterpret_cast<float*>(sm + L::G);
  float* sdec = reinterpret_cast<float*>(sm + L::DEC);
  const uint32_t vp_a = base_a + L::V, sp_a = base_a + L::S;
  const uint32_t raw_a = base_a + L::RAW, bar_a = base_a + L::BAR;
  const TI* rr_s = reinterpret_cast<const TI*>(sm + L::RAW);   // staged
  const TI* rk_s = rr_s + C * D;
  const TI* rv_s = rk_s + C * D;
  const float* rw_s = reinterpret_cast<const float*>(rv_s + C * D);

  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wg = warp / 4, ww = warp % 4;    // warpgroup, warp in it
  const size_t tstride = static_cast<size_t>(heads) * D;
  const size_t base = (static_cast<size_t>(b) * seq * heads + h) * D;
  const size_t sbase = static_cast<size_t>(bh) * D * D;
  const float2 ud = *reinterpret_cast<const float2*>(u + h * D + 2 * lane);

  // warpgroup 1 keeps the state in registers as a wgmma accumulator: rows
  // d = 16 ww + gq (+ 8), columns 8 j + 2 tq (+ 1)
  float sreg[32];
  auto put_state = [&]() {   // its parts to shared memory
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int row = 16 * ww + gq + 8 * ((e >> 1) & 1);
      const int col = 8 * (e >> 2) + 2 * tq;
      uint32_t p[3];
      split3x2(sreg[e], sreg[e + 1], p);
#pragma unroll
      for (int pt = 0; pt < 3; ++pt)
        *reinterpret_cast<uint32_t*>(sp + pt * PART + sw128(row, col)) =
            p[pt];
    }
    fence_async_smem();
  };
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int row = 16 * ww + gq + 8 * ((e >> 1) & 1);
      const int col = 8 * (e >> 2) + 2 * tq;
      sreg[e] = s0 ? s0[sbase + row * D + col] : 0.0f;
      sreg[e + 1] = s0 ? s0[sbase + row * D + col + 1] : 0.0f;
    }
    put_state();
  }
  // the staged o of the chunk at t0 (n tokens) to device memory, 16 bytes
  // a store
  auto write_o = [&](int t0, int n) {
    constexpr int VEC = 16 / sizeof(TO), PER_ROW = D / VEC;
    for (int e = tid; e < n * PER_ROW; e += THREADS) {
      const int row = e / PER_ROW, col = (e % PER_ROW) * VEC;
      alignas(16) TO vals[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) store_f32(vals + c, so[row * LO + col + c]);
      *reinterpret_cast<uint4*>(o + base + (t0 + row) * tstride + col) =
          *reinterpret_cast<const uint4*>(vals);
    }
  };

  if (tid == 0) mbar_init(bar_a, 1);
  for (int e = tid; e < C * LA; e += THREADS) sa[e] = 0.0f;
  __syncthreads();
  const int nchunks = (seq + C - 1) / C;
  if (tid == 0) stage<TI>(raw_a, bar_a, &rmap, &kmap, &vmap, &wmap, b, h, 0);

  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * C, n = min(C, seq - t0);
    mbar_wait(bar_a, ci & 1);           // this chunk is staged
    __syncthreads();                    // the previous one is consumed
    if (ci > 0) write_o(t0 - C, C);
    put_v(vp, rv_s);
    fence_async_smem();

    // Warp s, lane l: sub-chunk s, channels 2 l, 2 l + 1. Q = r x products
    // from the sub-chunk's start, K = k x products to its end, and the
    // sub-chunk's product; then the diagonal block of A: for j < i, A(i, j)
    // = sum_d r_id k_jd w_{j+1,d} ... w_{i-1,d}, the product chain carried
    // along i; A(j, j) = sum_d r_jd u_d k_jd; the lanes' terms summed by a
    // butterfly reduce-scatter.
    {
      const int s = warp, c = 2 * lane;
      float2 rr[SUB], kk[SUB], wv[SUB];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {   // past the sequence r = k = 0
        const int t = s * SUB + i;
        rr[i] = ld_f2(rr_s + t * D + c);
        kk[i] = ld_f2(rk_s + t * D + c);
        wv[i] = t < n ? ld_f2(rw_s + t * D + c) : make_float2(1.0f, 1.0f);
      }
      float2 pr = make_float2(1.0f, 1.0f);
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        *reinterpret_cast<float2*>(sq + (s * SUB + i) * LA + c) =
            make_float2(rr[i].x * pr.x, rr[i].y * pr.y);
        pr.x *= wv[i].x;
        pr.y *= wv[i].y;
      }
      *reinterpret_cast<float2*>(som + s * D + c) = pr;
      pr = make_float2(1.0f, 1.0f);
#pragma unroll
      for (int i = SUB - 1; i >= 0; --i) {
        *reinterpret_cast<float2*>(skk + (s * SUB + i) * LA + c) =
            make_float2(kk[i].x * pr.x, kk[i].y * pr.y);
        pr.x *= wv[i].x;
        pr.y *= wv[i].y;
      }
      float x[ITEMS];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        x[NPAIR + j] = fmaf(rr[j].x * ud.x, kk[j].x, rr[j].y * ud.y * kk[j].y);
        float2 pc = kk[j];
#pragma unroll
        for (int i = j + 1; i < SUB; ++i) {
          x[i * (i - 1) / 2 + j] = fmaf(rr[i].x, pc.x, rr[i].y * pc.y);
          pc.x *= wv[i].x;
          pc.y *= wv[i].y;
        }
      }
      halve<36>(x, 16);
      halve<18>(x, 8);
      x[9] = 0.0f;
      halve<10>(x, 4);
      x[5] = 0.0f;
      halve<6>(x, 2);
      x[3] = 0.0f;
      halve<4>(x, 1);
      // x[f] is the sum of item it: undo the halvings, padding excluded
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        int it = f + 2 * (lane & 1);
        if (it >= 3) continue;
        it += 3 * ((lane >> 1) & 1);
        if (it >= 5) continue;
        it += 5 * ((lane >> 2) & 1);
        if (it >= 9) continue;
        it += 9 * ((lane >> 3) & 1) + 18 * ((lane >> 4) & 1);
        const int2 ij = item_ij(it);
        sa[(s * SUB + ij.x) * LA + s * SUB + ij.y] = x[f];
      }
    }
    __syncthreads();
    if (tid == 0 && ci + 1 < nchunks)   // the staging is free
      stage<TI>(raw_a, bar_a, &rmap, &kmap, &vmap, &wmap, b, h, t0 + C);

    // products of whole sub-chunks: thread (channel d, part p); part 0 the
    // products before and after each sub-chunk and the chunk's, part p
    // g(a, kb) = prod_{kb < s < a} for kb = p, p + 4
    {
      const int d = tid % D, part = tid / D;
      float om[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) om[s] = som[s * D + d];
      if (part == 0) {
        float pr = 1.0f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          srho[s * D + d] = pr;
          pr *= om[s];
        }
        sdec[d] = pr;
        pr = 1.0f;
#pragma unroll
        for (int s = NS - 1; s >= 0; --s) {
          skap[s * D + d] = pr;
          pr *= om[s];
        }
      }
#pragma unroll
      for (int kb = 0; kb < NS - 1; ++kb) {
        if (kb % (THREADS / D) != part) continue;
        float pg = 1.0f;
#pragma unroll
        for (int qa = kb + 1; qa < NS; ++qa) {
          sg[(qa * (qa - 1) / 2 + kb) * D + d] = pg;
          pg *= om[qa];
        }
      }
    }
    __syncthreads();

    // Warpgroup 0 issues o = (Q rho) S_0 and warpgroup 1 (K kappa)^T V on
    // the tensor cores (wgmma, asynchronous); meanwhile each warp forms two
    // cross-sub-chunk tiles of A with mma.sync: tile ti = (m, nb), rows
    // 16 m + gq (+ 8) (sub-chunks 2 m, 2 m + 1), keys 8 nb + gq, nb <= 2 m;
    // A(i, j) = sum_d Q_id g(a_i, nb)_d K_jd, row half 0 only off the
    // diagonal block; 3xTF32, each pass in its own accumulator.
    float acc[32] = {};
    wgmma_fence();
    if (wg == 0) {
      const int i0 = 16 * ww + gq, i1 = i0 + 8;
      const float* rho0 = srho + (2 * ww) * D;
      const float* rho1 = srho + (2 * ww + 1) * D;
      product_rs<3>(acc, sp_a, [&](int kk, float (&x)[8]) {
        const int c = 16 * kk + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[e] = sq[i0 * LA + c + e] * rho0[c + e];
          x[2 + e] = sq[i1 * LA + c + e] * rho1[c + e];
          x[4 + e] = sq[i0 * LA + c + 8 + e] * rho0[c + 8 + e];
          x[6 + e] = sq[i1 * LA + c + 8 + e] * rho1[c + 8 + e];
        }
      });
    } else {
      const int d0 = 16 * ww + gq, d1 = d0 + 8;
      product_rs<NB>(acc, vp_a, [&](int kk, float (&x)[8]) {
        const int t = 16 * kk + 2 * tq;
        const float* ka = skap + (2 * kk) * D;
        const float* kb = skap + (2 * kk + 1) * D;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[e] = skk[(t + e) * LA + d0] * ka[d0];
          x[2 + e] = skk[(t + e) * LA + d1] * ka[d1];
          x[4 + e] = skk[(t + 8 + e) * LA + d0] * kb[d0];
          x[6 + e] = skk[(t + 8 + e) * LA + d1] * kb[d1];
        }
      });
    }
    wgmma_commit();
    {
      int mt[2], nbt[2];
      bool off0[2];
      const float *g0[2], *g1[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int ti = warp + WARPS * x;
        const int m = ti < 1 ? 0 : ti < 4 ? 1 : ti < 9 ? 2 : 3;
        const int a1 = 2 * m + 1;
        mt[x] = m;
        nbt[x] = ti - m * m;
        off0[x] = 2 * m > nbt[x];
        g1[x] = sg + (a1 * (a1 - 1) / 2 + nbt[x]) * D;
        g0[x] = off0[x] ? sg + (m * (2 * m - 1) + nbt[x]) * D : g1[x];
      }
      float sc[2][3][4] = {};
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        const int c0 = kk + tq, c1 = c0 + 4;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i0 = 16 * mt[x] + gq, i1 = i0 + 8, jr = SUB * nbt[x] + gq;
          const float av[4] = {
              off0[x] ? sq[i0 * LA + c0] * g0[x][c0] : 0.0f,
              sq[i1 * LA + c0] * g1[x][c0],
              off0[x] ? sq[i0 * LA + c1] * g0[x][c1] : 0.0f,
              sq[i1 * LA + c1] * g1[x][c1]};
          mma3(sc[x], Tf32x3::split_a(av),
               Tf32x3::split_b(skk[jr * LA + c0], skk[jr * LA + c1]));
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i0 = 16 * mt[x] + gq, i1 = i0 + 8;
        const int cj = SUB * nbt[x] + 2 * tq;
        float res[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          res[e] = (sc[x][0][e] + sc[x][1][e]) + sc[x][2][e];
        if (off0[x]) {
          sa[i0 * LA + cj] = res[0];
          sa[i0 * LA + cj + 1] = res[1];
        }
        sa[i1 * LA + cj] = res[2];
        sa[i1 * LA + cj + 1] = res[3];
      }
    }
    wgmma_wait0();
    fence_regs(acc);
    if (wg == 1) {
      const float dec0 = sdec[16 * ww + gq], dec1 = sdec[16 * ww + gq + 8];
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sreg[e] = ((e >> 1) & 1 ? dec1 : dec0) * sreg[e] + acc[e];
    }
    __syncthreads();                    // A complete; S_0 read by all

    if (wg == 0) {
      // o += A V (the keys past a warp's rows are zero in A), staged
      const int i0 = 16 * ww + gq, i1 = i0 + 8;
      wgmma_fence();
      product_rs<NB>(acc, vp_a, [&](int kk, float (&x)[8]) {
        const int c = 16 * kk + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[e] = sa[i0 * LA + c + e];
          x[2 + e] = sa[i1 * LA + c + e];
          x[4 + e] = sa[i0 * LA + c + 8 + e];
          x[6 + e] = sa[i1 * LA + c + 8 + e];
        }
      });
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int row = 16 * ww + gq + 8 * ((e >> 1) & 1);
        const int col = 8 * (e >> 2) + 2 * tq;
        *reinterpret_cast<float2*>(so + row * LO + col) =
            make_float2(acc[e], acc[e + 1]);
      }
    } else {
      put_state();                      // for the next chunk's o
    }
  }
  __syncthreads();
  write_o((nchunks - 1) * C, seq - (nchunks - 1) * C);
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int row = 16 * ww + gq + 8 * ((e >> 1) & 1);
      const int col = 8 * (e >> 2) + 2 * tq;
      store2(s_out + sbase + row * D + col, sreg[e], sreg[e + 1]);
    }
  }
}

}  // namespace chunked

template <typename TI, typename TO>
int launch_seq(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, int bh, int heads, int seq,
               void* o, void* s_out, cudaStream_t stream) {
  scan::wkv_seq_kernel<TI, TO><<<bh, scan::THREADS, 0, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0), heads,
      seq, static_cast<TO*>(o), static_cast<float*>(s_out));
  return static_cast<int>(cudaGetLastError());
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

// (batch, seq, heads, 64) at ptr as a 4-D map over (64, heads, seq,
// batch), box (64 columns, 1 head, C tokens, 1); zero-filled past the
// sequence
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                int heads) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr cuuint64_t E = sizeof(T);
  const cuuint64_t dims[4] = {chunked::D, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = E * chunked::D * heads;   // bytes of one token
  const cuuint64_t strides[3] = {E * chunked::D, row,
                                 row * static_cast<cuuint64_t>(seq)};
  const cuuint32_t box[4] = {chunked::D, 1, chunked::C, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                E == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TI, typename TO>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, int bh,
                   int heads, int seq, void* o, void* s_out,
                   cudaStream_t stream) {
  const int batch = bh / heads;
  CUtensorMap rm, km, vm, wm;
  if (!tensor_map<TI>(&rm, r, batch, seq, heads) ||
      !tensor_map<TI>(&km, k, batch, seq, heads) ||
      !tensor_map<TI>(&vm, v, batch, seq, heads) ||
      !tensor_map<float>(&wm, w, batch, seq, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel = chunked::wkv_chunked_kernel<TI, TO>;
  constexpr int smem = chunked::Smem<TI>::BYTES;
  // above 48 KB the kernel needs an attribute, set at its first launch
  // (the port drives one card a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<bh, chunked::THREADS, smem, stream>>>(
      rm, km, vm, wm, static_cast<const float*>(u),
      static_cast<const float*>(s0), heads, seq, static_cast<TO*>(o),
      static_cast<float*>(s_out));
  return static_cast<int>(cudaGetLastError());
}

// the launcher of a WKV entry for the dtypes asked for
using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, int, int, int, void*, void*,
                       cudaStream_t);

int run(Launch f32, Launch bf16_f32, Launch bf16_bf16, const void* r,
        const void* k, const void* v, const void* w, const void* u,
        const void* s0, int batch, int heads, int seq, int in_bf16,
        int out_bf16, void* o, void* s_out, void* stream) {
  const int bh = batch * heads;
  if (bh == 0) return 0;
  if (seq < 1 || (out_bf16 && !in_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch f = !in_bf16 ? f32 : !out_bf16 ? bf16_f32 : bf16_bf16;
  return f(r, k, v, w, u, s0, bh, heads, seq, o, s_out,
           static_cast<cudaStream_t>(stream));
}

}  // namespace

// Both entries: r, k, v: (B, S, H, 64) float32 (in_bf16 = 0) or bfloat16
// (in_bf16 = 1); w: (B, S, H, 64) float32; u: (H, 64) float32; s0: (B, H,
// 64, 64) float32 or null for a zero state; o: (B, S, H, 64) float32
// (out_bf16 = 0) or bfloat16 (out_bf16 = 1, only with in_bf16 = 1); s_out:
// (B, H, 64, 64) float32. All contiguous; seq >= 1.

// The chunked kernel.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         int batch, int heads, int seq, int in_bf16,
                         int out_bf16, void* o, void* s_out, void* stream) {
  return run(launch_chunked<float, float>,
             launch_chunked<__nv_bfloat16, float>,
             launch_chunked<__nv_bfloat16, __nv_bfloat16>, r, k, v, w, u, s0,
             batch, heads, seq, in_bf16, out_bf16, o, s_out, stream);
}

// The sequential kernel.
extern "C" int rwkv6_wkv_seq(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             int batch, int heads, int seq, int in_bf16,
                             int out_bf16, void* o, void* s_out,
                             void* stream) {
  return run(launch_seq<float, float>, launch_seq<__nv_bfloat16, float>,
             launch_seq<__nv_bfloat16, __nv_bfloat16>, r, k, v, w, u, s0,
             batch, heads, seq, in_bf16, out_bf16, o, s_out, stream);
}
