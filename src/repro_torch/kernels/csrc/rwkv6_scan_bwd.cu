// RWKV6 (Finch) WKV recurrence, backward: the gradients of r, k, v, w, u
// and of the initial state, given the output's cotangent and the final
// state's.
//
// Replaces no TPU kernel: the JAX package differentiates its XLA path
// (`rwkv6_chunked_xla`, src/repro/kernels/ref.py:190, through
// src/repro/kernels/ops.py:312-321), and its Pallas kernel has no VJP.
// Per (batch b, head h), with Dk = Dv = 64, the forward is
//
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//
// and with G_t = dL/dS_t (G_{S-1} the final state's cotangent, or 0) the
// backward is
//
//   dr_t = S_{t-1} do_t + u k_t (v_t . do_t)
//   dk_t = G_t v_t + u r_t (v_t . do_t)
//   dv_t = G_t^T k_t + (r_t . (u k_t)) do_t
//   dw_t = rowsum(G_t * S_{t-1})
//   du   = sum over (b, t) of r_t k_t (v_t . do_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T,  d(initial state) = G_{-1}.
//
// `ref.rwkv6_bwd_ref` is the plain version. Nothing divides by w, so the
// kernel is right for any w in (0, 1], as the forward is.
//
// Three launches:
//   1. `bounds`: the state S before each chunk of T = 32 tokens, and the
//      cotangent G after each chunk's last token, into scratch (B, H, NC,
//      64, 64) float32 that the wrapper allocates. Each state element is a
//      recurrence of its own (the rows and columns of S do not mix), so a
//      thread walks every token for 4 rows of one column; blockIdx.y picks
//      the pass (forward for S from s0, backward for G from the final
//      state's cotangent). 32-token tiles of w, k or r (rows) and v or do
//      (the block's 16 columns) are staged in shared memory.
//   2. `chunk`: a block a (b, h, chunk), the whole 64 x 64 state, a thread
//      a row i and 8 columns. A forward walk from S_{start-1} forms dr
//      (a row sum over the thread's 8 columns, then over the row's 8
//      threads by shuffles) and keeps the state at each 8-token sub-chunk
//      start in shared memory. Then the sub-chunks in reverse: the 8 states
//      S_{t-1} recomputed into registers from the sub-chunk's start, and
//      the reverse walk of G over them forms dk, dw (row sums, as dr) and
//      dv (column sums: a reduce-scatter over the warp's 4 rows, then the
//      16 warps' partials summed from shared memory). The recomputation
//      costs two forward walks; no state goes through device memory but
//      the chunk boundaries.
//   3. `du`: u's gradient, summed over the (b, chunk) partials that
//      launch 2 writes.
// The states are formed as the plain version forms them, two rounded
// products and a rounded sum (__fmul_rn, __fadd_rn): launch 1 and 2 walk
// the same tokens in the same order, so a chunk's recomputed states are
// the boundary pass's. Every sum runs in a fixed order (no atomics), so
// two calls give the same bits.
//
// Bound on an H100 at RWKV6-1.6B's training call (B 1, S 4096, H 32, bf16
// r, k, v, dr, dk, dv; float32 w, do, dw): the bytes (inputs read once,
// outputs written once) 201 MB, ~60 us at 3.35 TB/s. The function's
// operations in the chunked form, as the forward computes it (products of
// 64-token chunks on the tensor cores), take ~41 us even as six bf16
// passes a float32 product, so the bytes bound it; chip_smoke.py's
// `wkv_bwd_bound` computes the bound from each call's shape. This design
// runs the token form on the CUDA cores instead: 14 float32 operations a
// state element and token (S's and G's updates, 3 each; the
// multiply-adds of dr, dk, dw and dv, 2 each), 7.5 GFLOP, ~112 us at 67
// TFLOP/s, plus 3 more (the second forward walk of the states) and the
// shuffles of its sums, so it cannot reach the bound.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int D = 64;          // head dim (Dk = Dv)
constexpr int T = 32;          // tokens a chunk of the backward
constexpr int SUB = 8;         // tokens a sub-chunk of the reverse walk
constexpr int NSUB = T / SUB;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// s <- w s + a b, two rounded products and a rounded sum
__device__ __forceinline__ float step(float w, float s, float a, float b) {
  return __fadd_rn(__fmul_rn(w, s), __fmul_rn(a, b));
}

// ------------------------------------------------------ 1. chunk bounds

namespace bounds {

constexpr int COLS = 16;                  // state columns a block
constexpr int RG = 4;                     // rows a thread
constexpr int THREADS = COLS * (D / RG);  // 256
constexpr int TILE = 32;                  // tokens staged a round
constexpr int SLICES = D / COLS;

template <typename TI>
__global__ void __launch_bounds__(THREADS)
wkv_bwd_bounds(const TI* __restrict__ r, const TI* __restrict__ k,
              const TI* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ dout, const float* __restrict__ s0,
              const float* __restrict__ ds_out, int heads, int seq, int nc,
              float* __restrict__ sb, float* __restrict__ gb) {
  __shared__ __align__(16) float sw[TILE][D];
  __shared__ __align__(16) float srow[TILE][D];   // k (state), r (cotangent)
  __shared__ float scol[TILE][COLS];              // v (state), do (cotangent)

  const int bh = blockIdx.x / SLICES;
  const int slice = blockIdx.x % SLICES;
  const int b = bh / heads, h = bh % heads;
  const bool rev = blockIdx.y == 1;
  const int tid = threadIdx.x;
  const int jl = tid % COLS;
  const int i0 = (tid / COLS) * RG;
  const int j = slice * COLS + jl;

  const size_t mbase = static_cast<size_t>(bh) * D * D;
  const float* init = rev ? ds_out : s0;
  float s[RG];
#pragma unroll
  for (int m = 0; m < RG; ++m)
    s[m] = init ? init[mbase + (i0 + m) * D + j] : 0.0f;
  float* out = rev ? gb : sb;

  const size_t tstride = static_cast<size_t>(heads) * D;
  const size_t base = (static_cast<size_t>(b) * seq * heads + h) * D;
  const int ntiles = (seq + TILE - 1) / TILE;
  for (int q = 0; q < ntiles; ++q) {
    const int t0 = (rev ? ntiles - 1 - q : q) * TILE;
    const int n = min(TILE, seq - t0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = tid; e < n * D; e += THREADS) {
      const int tt = e / D, c = e % D;
      const size_t g = base + static_cast<size_t>(t0 + tt) * tstride + c;
      sw[tt][c] = w[g];
      srow[tt][c] = rev ? ld(r + g) : ld(k + g);
    }
    for (int e = tid; e < n * COLS; e += THREADS) {
      const int tt = e / COLS, c = e % COLS;
      const size_t g = base + static_cast<size_t>(t0 + tt) * tstride +
                       slice * COLS + c;
      scol[tt][c] = rev ? dout[g] : ld(v + g);
    }
    __syncthreads();
    for (int p = 0; p < n; ++p) {
      const int tt = rev ? n - 1 - p : p;
      const int t = t0 + tt;
      // the state before each chunk's first token; the cotangent after
      // each chunk's last token
      const bool edge = rev ? (t == seq - 1 || (t + 1) % T == 0)
                            : (t % T == 0);
      if (edge) {
        float* o = out + (static_cast<size_t>(bh) * nc + t / T) * D * D;
#pragma unroll
        for (int m = 0; m < RG; ++m) o[(i0 + m) * D + j] = s[m];
      }
      const float4 wa = *reinterpret_cast<const float4*>(&sw[tt][i0]);
      const float4 ra = *reinterpret_cast<const float4*>(&srow[tt][i0]);
      const float cv = scol[tt][jl];
      s[0] = step(wa.x, s[0], ra.x, cv);
      s[1] = step(wa.y, s[1], ra.y, cv);
      s[2] = step(wa.z, s[2], ra.z, cv);
      s[3] = step(wa.w, s[3], ra.w, cv);
    }
  }
}

}  // namespace bounds

// ------------------------------------------------- 2. the reverse walk

namespace chunk {

constexpr int CG = 8;                    // columns a thread
constexpr int GROUPS = D / CG;           // threads a row
constexpr int THREADS = D * GROUPS;      // 512
constexpr int WARPS = THREADS / 32;      // 16, each 4 rows

struct Smem {
  float r[T][D], k[T][D], v[T][D], w[T][D], dout[T][D];
  float sub[NSUB][CG][THREADS];          // states at the sub-chunk starts
  float dvp[SUB][WARPS][D];              // dv partials, a warp's 4 rows
  float vd[T], ruk[T];                   // v . do and r . (u k) a token
};
static_assert(sizeof(Smem) <= 232448, "shared memory");

__device__ __forceinline__ void load8(const float* p, float (&x)[CG]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// the sum over the row's 8 threads (lanes cg = 0..7), in a fixed order
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  x += __shfl_xor_sync(FULL, x, 4);
  return x;
}

template <typename TI>
__global__ void __launch_bounds__(THREADS, 1)
wkv_bwd_chunk(const TI* __restrict__ r, const TI* __restrict__ k,
             const TI* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ dout,
             const float* __restrict__ sb, const float* __restrict__ gb,
             int heads, int seq, int nc, TI* __restrict__ dr,
             TI* __restrict__ dk, TI* __restrict__ dv,
             float* __restrict__ dw, float* __restrict__ du_part,
             float* __restrict__ ds0) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int c = blockIdx.x % nc;
  const int bh = blockIdx.x / nc;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / GROUPS, cg = tid % GROUPS, j0 = cg * CG;
  const int t0 = c * T;
  const int n = min(T, seq - t0);
  const size_t tstride = static_cast<size_t>(heads) * D;
  const size_t base = (static_cast<size_t>(b) * seq * heads + h) * D +
                      static_cast<size_t>(t0) * tstride;

  // the chunk's tokens; past the sequence r = k = v = do = 0 and w = 1,
  // which leave S and G as they are
  for (int e = tid; e < T * D; e += THREADS) {
    const int tt = e / D, cc = e % D;
    float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 1.0f, ov = 0.0f;
    if (tt < n) {
      const size_t g = base + tt * tstride + cc;
      rv = ld(r + g); kv = ld(k + g); vv = ld(v + g);
      wv = w[g]; ov = dout[g];
    }
    sm.r[tt][cc] = rv; sm.k[tt][cc] = kv; sm.v[tt][cc] = vv;
    sm.w[tt][cc] = wv; sm.dout[tt][cc] = ov;
  }
  __syncthreads();
  for (int tt = warp; tt < T; tt += WARPS) {          // a warp a token
    float a = 0.0f, q = 0.0f;
#pragma unroll
    for (int cc = lane; cc < D; cc += 32) {
      a += sm.v[tt][cc] * sm.dout[tt][cc];
      q += __fmul_rn(sm.r[tt][cc], u[h * D + cc]) * sm.k[tt][cc];
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane == 0) { sm.vd[tt] = a; sm.ruk[tt] = q; }
  }
  const float ui = u[h * D + i];
  const size_t mb = (static_cast<size_t>(bh) * nc + c) * D * D +
                    static_cast<size_t>(i) * D + j0;
  float s[CG], g[CG];
  load8(sb + mb, s);
  load8(gb + mb, g);
  __syncthreads();

  // forward walk: dr, and the states at the sub-chunk starts
  for (int tt = 0; tt < T; ++tt) {
    if (tt % SUB == 0) {
#pragma unroll
      for (int m = 0; m < CG; ++m) sm.sub[tt / SUB][m][tid] = s[m];
    }
    float vv[CG], oo[CG];
    load8(&sm.v[tt][j0], vv);
    load8(&sm.dout[tt][j0], oo);
    float p = 0.0f;
#pragma unroll
    for (int m = 0; m < CG; ++m) p = fmaf(s[m], oo[m], p);
    p = row_sum(p);
    if (cg == 0 && tt < n)
      st(dr + base + tt * tstride + i,
         p + __fmul_rn(ui, sm.k[tt][i]) * sm.vd[tt]);
    const float wi = sm.w[tt][i], ki = sm.k[tt][i];
#pragma unroll
    for (int m = 0; m < CG; ++m) s[m] = step(wi, s[m], ki, vv[m]);
  }

  // the sub-chunks in reverse: recompute S_{t-1}, walk G back over them
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const int col = j0 + (hi16 ? 4 : 0) + (hi8 ? 2 : 0);
  float dup = 0.0f;
  for (int q = NSUB - 1; q >= 0; --q) {
    float hist[SUB][CG];
#pragma unroll
    for (int m = 0; m < CG; ++m) s[m] = sm.sub[q][m][tid];
#pragma unroll
    for (int mm = 0; mm < SUB; ++mm) {
      const int tt = q * SUB + mm;
      float vv[CG];
      load8(&sm.v[tt][j0], vv);
      const float wi = sm.w[tt][i], ki = sm.k[tt][i];
#pragma unroll
      for (int m = 0; m < CG; ++m) {
        hist[mm][m] = s[m];
        s[m] = step(wi, s[m], ki, vv[m]);
      }
    }
#pragma unroll
    for (int mm = SUB - 1; mm >= 0; --mm) {
      const int tt = q * SUB + mm;
      float vv[CG], oo[CG], pv[CG];
      load8(&sm.v[tt][j0], vv);
      load8(&sm.dout[tt][j0], oo);
      const float wi = sm.w[tt][i], ki = sm.k[tt][i], ri = sm.r[tt][i];
      float pk = 0.0f, pw = 0.0f;
#pragma unroll
      for (int m = 0; m < CG; ++m) {
        pk = fmaf(g[m], vv[m], pk);
        pw = fmaf(g[m], hist[mm][m], pw);
        pv[m] = __fmul_rn(g[m], ki);
      }
      pk = row_sum(pk);
      pw = row_sum(pw);
      // dv: the sum over the warp's 4 rows (lane bits 3 and 4), scattered
      // so that each lane ends with two of its row group's 8 columns
      float q4[4], q2[2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float send = hi16 ? pv[m] : pv[m + 4];
        q4[m] = (hi16 ? pv[m + 4] : pv[m]) +
                __shfl_xor_sync(FULL, send, 16);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float send = hi8 ? q4[m] : q4[m + 2];
        q2[m] = (hi8 ? q4[m + 2] : q4[m]) + __shfl_xor_sync(FULL, send, 8);
      }
      sm.dvp[mm][warp][col] = q2[0];
      sm.dvp[mm][warp][col + 1] = q2[1];
      if (cg == 0 && tt < n) {
        const size_t o = base + tt * tstride + i;
        st(dk + o, pk + __fmul_rn(ui, ri) * sm.vd[tt]);
        dw[o] = pw;
        dup += __fmul_rn(ri, ki) * sm.vd[tt];
      }
#pragma unroll
      for (int m = 0; m < CG; ++m) g[m] = step(wi, g[m], ri, oo[m]);
    }
    __syncthreads();
    {  // dv of the sub-chunk's 8 tokens: the 16 warps' partials, in order
      const int mm = tid / D, jj = tid % D;
      const int tt = q * SUB + mm;
      float a = 0.0f;
#pragma unroll
      for (int ww = 0; ww < WARPS; ++ww) a += sm.dvp[mm][ww][jj];
      if (tt < n)
        st(dv + base + tt * tstride + jj,
           a + __fmul_rn(sm.ruk[tt], sm.dout[tt][jj]));
    }
    __syncthreads();
  }
  if (ds0 != nullptr && c == 0) {
    float* o = ds0 + static_cast<size_t>(bh) * D * D +
               static_cast<size_t>(i) * D + j0;
#pragma unroll
    for (int m = 0; m < CG; ++m) o[m] = g[m];
  }
  if (cg == 0)
    du_part[(static_cast<size_t>(b) * nc + c) * heads * D + h * D + i] = dup;
}

}  // namespace chunk

// ------------------------------------------------------------ 3. du

constexpr int DU_THREADS = 256;

// du[e] = sum over q of part[q][e], q = (b, chunk) in order
__global__ void __launch_bounds__(DU_THREADS)
wkv_bwd_du(const float* __restrict__ part, int rows, int hd,
          float* __restrict__ du) {
  const int e = blockIdx.x * DU_THREADS + threadIdx.x;
  if (e >= hd) return;
  float a = 0.0f;
  for (int q = 0; q < rows; ++q) a += part[static_cast<size_t>(q) * hd + e];
  du[e] = a;
}

template <typename TI>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dout, const void* s0,
           const void* ds_out, int batch, int heads, int seq, void* sb,
           void* gb, void* du_part, void* dr, void* dk, void* dv, void* dw,
           void* du, void* ds0, cudaStream_t stream) {
  const int nc = (seq + T - 1) / T;
  const int bh = batch * heads;
  const dim3 grid1(bh * bounds::SLICES, 2);
  bounds::wkv_bwd_bounds<TI><<<grid1, bounds::THREADS, 0, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const float*>(w),
      static_cast<const float*>(dout), static_cast<const float*>(s0),
      static_cast<const float*>(ds_out), heads, seq, nc,
      static_cast<float*>(sb), static_cast<float*>(gb));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr auto kernel = chunk::wkv_bwd_chunk<TI>;
  constexpr int smem = sizeof(chunk::Smem);
  // above 48 KB the kernel needs an attribute, set at its first launch
  // (the port drives one card a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<bh * nc, chunk::THREADS, smem, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(dout),
      static_cast<const float*>(sb), static_cast<const float*>(gb), heads,
      seq, nc, static_cast<TI*>(dr), static_cast<TI*>(dk),
      static_cast<TI*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), static_cast<float*>(ds0));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int hd = heads * D;
  wkv_bwd_du<<<(hd + DU_THREADS - 1) / DU_THREADS, DU_THREADS, 0, stream>>>(
      static_cast<const float*>(du_part), batch * nc, hd,
      static_cast<float*>(du));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (B, S, H, 64) float32 (in_bf16 = 0) or bfloat16 (in_bf16 = 1);
// w and dout (the output's cotangent): (B, S, H, 64) float32; u: (H, 64)
// float32; s0 (the initial state) and ds_out (the final state's
// cotangent): (B, H, 64, 64) float32, or null for zeros. Scratch: sb and gb
// (B, H, NC, 64, 64) float32 and du_part (B, NC, H, 64) float32, NC =
// `chunks`, which must be ceil(S / T) (`rwkv6_wkv_bwd_chunk` gives T).
// Out: dr, dk, dv in r's dtype and dw float32, (B, S, H, 64); du (H, 64)
// float32; ds0 (B, H, 64, 64) float32, or null where no initial-state
// gradient is wanted. All contiguous; seq >= 1.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* dout,
                             const void* s0, const void* ds_out, int batch,
                             int heads, int seq, int in_bf16, int chunks,
                             void* sb, void* gb, void* du_part, void* dr,
                             void* dk, void* dv, void* dw, void* du,
                             void* ds0, void* stream) {
  if (batch * heads == 0) return 0;
  if (seq < 1 || chunks != (seq + T - 1) / T)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = in_bf16 ? launch<__nv_bfloat16> : launch<float>;
  return f(r, k, v, w, u, dout, s0, ds_out, batch, heads, seq, sb, gb,
           du_part, dr, dk, dv, dw, du, ds0,
           static_cast<cudaStream_t>(stream));
}

// The tokens T between two stored states of the backward, with which the
// wrapper sizes its scratch. Launches nothing.
extern "C" int rwkv6_wkv_bwd_chunk() { return T; }
