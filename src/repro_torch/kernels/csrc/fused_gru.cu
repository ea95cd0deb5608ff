// GRU cell, forward and backward, float32.
//
// Replaces the TPU kernels `_gru_kernel` (entry `fused_gru`) and
// `_gru_bwd_kernel` (entry `fused_gru_bwd`) of
// src/repro/kernels/fused_gru.py.
//
//   gx = x wx + bx,  gh = h wh + bh,  gates [r | z | n] in thirds of 3 d_h
//   r = sigmoid(gx_r + gh_r),  z = sigmoid(gx_z + gh_z)
//   n = tanh(gx_n + r gh_n),   h' = (1 - z) n + z h
//
// Layout as the JAX package's, row-major: x (B, d_in), h (B, d_h),
// wx (d_in, 3 d_h), wh (d_h, 3 d_h), bx, bh (3 d_h,). Any B, d_in, d_h:
// rows past B and columns past d_h are guarded, nothing is padded.
//
// Forward (`gru_gates_kernel<false>`): one block of 256 threads per tile of
// 32 rows x 32 hidden columns. For each column j the block needs the three
// gate columns j, d_h + j, 2 d_h + j of wx and wh; it stages 32-deep slices
// of the row tile (transposed, so four rows are one float4) and of the
// three gate column groups in shared memory, and each thread keeps 4 rows
// x 3 gates of x wx and of h wh in registers (24 accumulators, 12 fused
// multiply-adds per 4 shared loads). The gates never leave registers: one
// pass over x, h and the weights, one write of h'.
//
// Backward: the TPU kernel recomputes the gates per row block and sums
// dwx, dwh, dbx, dbh in one output block that every grid step revisits,
// which relies on the TPU running its grid in order. CUDA blocks run in
// no order, so the backward is three launches with no atomics, each sum
// taken in a fixed order (deterministic):
//   1. `gru_gates_kernel<true>`: the forward's tiles recompute the gates
//      and write the gate pre-activation grads dgx, dgh (B, 3 d_h) to a
//      workspace, and dh = g z;
//   2. `gemm_kernel`, two products in one launch (blockIdx.z):
//      dx = dgx wx^T and dh += dgh wh^T;
//   3. `gemm_kernel`, two products in one launch: dwx = x^T dgx and
//      dwh = h^T dgh, each output tile owned by one block that sums over
//      all B rows in order; an extra row of ones in x^T (h^T) gives dbx
//      (dbh), the column sums of dgx (dgh).
//
// Bound on an H100 at TGN's updater shape (B 400, d_in 616, d_h 172):
// the forward does 2 B (d_in + d_h) 3 d_h = 325 MFLOP of float32 (4.9 us
// at 67 TFLOP/s; TF32 stays off for float32 parity) against 3.2 MB of
// operands (1 us at 3.35 TB/s): operations. The backward does three times
// the products (~0.98 GFLOP, ~15 us). The tiles are small (78 forward
// blocks on 132 SMs) and each block streams its weight slices from L2:
// a first version that is right, not yet near that bound.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BM = 32;                    // rows per block
constexpr int BN = 32;                    // hidden columns per block
constexpr int BK = 32;                    // depth of a staged slice
constexpr int THREADS = 256;
constexpr int RPT = BM / (THREADS / BN);  // 4 rows per thread

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[i][g] += sum_k a[row0 + ty RPT + i][k] w[k][g d_h + col0 + tx] for
// k in [0, kdim), g = r, z, n; a is (rows, kdim), w is (kdim, 3 dh).
__device__ __forceinline__ void gate_products(
    const float* __restrict__ a, int rows, int kdim,
    const float* __restrict__ w, int dh, int row0, int col0,
    float (*as)[BM + 4], float (*ws)[3][BN], float acc[RPT][3]) {
  const int tid = threadIdx.x, tx = tid % BN, ty = tid / BN;
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;  // neighbours read neighbours in k
      const int r = row0 + m, kk = k0 + k;
      as[k][m] = (r < rows && kk < kdim)
                     ? a[static_cast<size_t>(r) * kdim + kk] : 0.0f;
    }
    for (int e = tid; e < 3 * BK * BN; e += THREADS) {
      const int n = e % BN, k = (e / BN) % BK, g = e / (BN * BK);
      const int c = col0 + n, kk = k0 + k;
      ws[k][g][n] =
          (c < dh && kk < kdim)
              ? w[static_cast<size_t>(kk) * 3 * dh + g * dh + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * RPT]);
      const float ar[RPT] = {av.x, av.y, av.z, av.w};
      const float wr = ws[k][0][tx], wz = ws[k][1][tx], wn = ws[k][2][tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        acc[i][0] = fmaf(ar[i], wr, acc[i][0]);
        acc[i][1] = fmaf(ar[i], wz, acc[i][1]);
        acc[i][2] = fmaf(ar[i], wn, acc[i][2]);
      }
    }
    __syncthreads();
  }
}

// BWD = false: out = h'. BWD = true: dgx, dgh (rows, 3 dh) and
// dh_out = g z from the cotangent g.
template <bool BWD>
__global__ void __launch_bounds__(THREADS)
gru_gates_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ wx, const float* __restrict__ wh,
                 const float* __restrict__ bx, const float* __restrict__ bh,
                 const float* __restrict__ g, int rows, int din, int dh,
                 float* __restrict__ out, float* __restrict__ dgx,
                 float* __restrict__ dgh) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ float ws[BK][3][BN];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float ax[RPT][3] = {}, ah[RPT][3] = {};
  gate_products(x, rows, din, wx, dh, row0, col0, as, ws, ax);
  gate_products(h, rows, dh, wh, dh, row0, col0, as, ws, ah);

  const int c = col0 + threadIdx.x % BN;
  if (c >= dh) return;
  const float bxr = bx[c], bxz = bx[dh + c], bxn = bx[2 * dh + c];
  const float bhr = bh[c], bhz = bh[dh + c], bhn = bh[2 * dh + c];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + (threadIdx.x / BN) * RPT + i;
    if (r >= rows) break;
    const size_t o = static_cast<size_t>(r) * dh + c;
    const float hv = h[o];
    const float rg = sigmoidf((ax[i][0] + bxr) + (ah[i][0] + bhr));
    const float zg = sigmoidf((ax[i][1] + bxz) + (ah[i][1] + bhz));
    const float nh = ah[i][2] + bhn;
    const float ng = tanhf((ax[i][2] + bxn) + rg * nh);
    if (!BWD) {
      out[o] = (1.0f - zg) * ng + zg * hv;
    } else {
      const float gv = g[o];
      const float dpre_n = gv * (1.0f - zg) * (1.0f - ng * ng);
      const float dpre_r = (dpre_n * nh) * rg * (1.0f - rg);
      const float dpre_z = gv * (hv - ng) * zg * (1.0f - zg);
      const size_t o3 = static_cast<size_t>(r) * 3 * dh + c;
      dgx[o3] = dpre_r;
      dgx[o3 + dh] = dpre_z;
      dgx[o3 + 2 * dh] = dpre_n;
      dgh[o3] = dpre_r;
      dgh[o3 + dh] = dpre_z;
      dgh[o3 + 2 * dh] = dpre_n * rg;
      out[o] = gv * zg;  // dh's direct term; the product is added later
    }
  }
}

// C (m, n) = A (m, k) B (k, n), A(i, l) at a[i sam + l sak], B(l, j) at
// b[l sbk + j sbn]; C row-major with leading dim ldc, added to what C
// holds if `accumulate`. With `bias` set, A has an extra row m of ones
// whose product row (the column sums of B) goes to bias[0, n).
struct Gemm {
  const float* a;
  long long sam, sak;
  const float* b;
  long long sbk, sbn;
  int m, n, k;
  float* c;
  int ldc;
  float* bias;
  int accumulate;
};

constexpr int GM = 64, GN = 64, GK = 16;  // block tile; 4 x 4 per thread

__global__ void __launch_bounds__(THREADS)
gemm_kernel(Gemm p0, Gemm p1) {
  const Gemm p = blockIdx.z == 0 ? p0 : p1;
  const int mt = p.m + (p.bias != nullptr);
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  if (m0 >= mt || n0 >= p.n) return;  // block-uniform
  __shared__ __align__(16) float as[GK][GM];
  __shared__ __align__(16) float bs[GK][GN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.k; k0 += GK) {
    for (int e = tid; e < GM * GK; e += THREADS) {
      // neighbouring threads read neighbouring addresses
      const int mm = p.sak == 1 ? e / GK : e % GM;
      const int kk = p.sak == 1 ? e % GK : e / GM;
      const int i = m0 + mm, l = k0 + kk;
      float v = 0.0f;
      if (l < p.k) {
        if (i < p.m)
          v = p.a[i * p.sam + l * p.sak];
        else if (i == p.m && p.bias != nullptr)
          v = 1.0f;
      }
      as[kk][mm] = v;
    }
    for (int e = tid; e < GK * GN; e += THREADS) {
      const int nn = p.sbn == 1 ? e % GN : e / GK;
      const int kk = p.sbn == 1 ? e / GN : e % GK;
      const int j = n0 + nn, l = k0 + kk;
      bs[kk][nn] = (l < p.k && j < p.n) ? p.b[l * p.sbk + j * p.sbn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= p.n) continue;
      if (r < p.m) {
        float* dst = p.c + static_cast<size_t>(r) * p.ldc + col;
        *dst = p.accumulate ? *dst + acc[i][j] : acc[i][j];
      } else if (r == p.m && p.bias != nullptr) {
        p.bias[col] = acc[i][j];
      }
    }
  }
}

int launch_gemm(const Gemm& p0, const Gemm& p1, cudaStream_t stream) {
  const int mt = std::max(p0.m + (p0.bias != nullptr),
                          p1.m + (p1.bias != nullptr));
  const int nt = std::max(p0.n, p1.n);
  if (mt == 0 || nt == 0) return 0;
  const dim3 grid((nt + GN - 1) / GN, (mt + GM - 1) / GM, 2);
  gemm_kernel<<<grid, THREADS, 0, stream>>>(p0, p1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, din), h (rows, dh), wx (din, 3 dh), wh (dh, 3 dh), bx, bh
// (3 dh,), out (rows, dh); float32, contiguous.
extern "C" int fused_gru_fwd(const void* x, const void* h, const void* wx,
                             const void* wh, const void* bx, const void* bh,
                             int rows, int din, int dh, void* out,
                             void* stream) {
  if (rows == 0 || dh == 0) return 0;
  const dim3 grid((rows + BM - 1) / BM, (dh + BN - 1) / BN);
  gru_gates_kernel<false><<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(wx), static_cast<const float*>(wh),
      static_cast<const float*>(bx), static_cast<const float*>(bh), nullptr,
      rows, din, dh, static_cast<float*>(out), nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// As fused_gru_fwd, plus the cotangent g (rows, dh) and two (rows, 3 dh)
// float32 workspaces; writes dx (rows, din), dh_out (rows, dh), dwx, dwh,
// dbx, dbh (the shapes of wx, wh, bx, bh).
extern "C" int fused_gru_bwd(const void* g, const void* x, const void* h,
                             const void* wx, const void* wh, const void* bx,
                             const void* bh, int rows, int din, int dh,
                             void* dgx, void* dgh, void* dx, void* dh_out,
                             void* dwx, void* dwh, void* dbx, void* dbh,
                             void* stream) {
  if (dh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* hf = static_cast<const float*>(h);
  float* dgxf = static_cast<float*>(dgx);
  float* dghf = static_cast<float*>(dgh);
  const long long d3 = 3LL * dh;
  if (rows > 0) {
    const dim3 grid((rows + BM - 1) / BM, (dh + BN - 1) / BN);
    gru_gates_kernel<true><<<grid, THREADS, 0, st>>>(
        xf, hf, static_cast<const float*>(wx), static_cast<const float*>(wh),
        static_cast<const float*>(bx), static_cast<const float*>(bh),
        static_cast<const float*>(g), rows, din, dh,
        static_cast<float*>(dh_out), dgxf, dghf);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    // dx = dgx wx^T: B(l, j) = wx[j, l]; dh += dgh wh^T
    const Gemm gx{dgxf, d3, 1, static_cast<const float*>(wx), 1, d3,
                  rows, din, static_cast<int>(d3), static_cast<float*>(dx),
                  din, nullptr, 0};
    const Gemm gh{dghf, d3, 1, static_cast<const float*>(wh), 1, d3,
                  rows, dh, static_cast<int>(d3),
                  static_cast<float*>(dh_out), dh, nullptr, 1};
    err = launch_gemm(gx, gh, st);
    if (err) return err;
  }
  // dwx = x^T dgx (+ dbx), dwh = h^T dgh (+ dbh); with rows == 0 these
  // are the zeros of an empty sum
  const Gemm wgx{xf, 1, din, dgxf, d3, 1, din, static_cast<int>(d3), rows,
                 static_cast<float*>(dwx), static_cast<int>(d3),
                 static_cast<float*>(dbx), 0};
  const Gemm wgh{hf, 1, dh, dghf, d3, 1, dh, static_cast<int>(d3), rows,
                 static_cast<float*>(dwh), static_cast<int>(d3),
                 static_cast<float*>(dbh), 0};
  return launch_gemm(wgx, wgh, st);
}
