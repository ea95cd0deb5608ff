// The GRU gate-product tile on Hopper's tensor cores at float32 precision,
// shared by the GRU kernels (fused_gru.cu).
//
// Pieces:
//   * cp.async staging: `load_tile` copies a block of a row-major float32
//     matrix into shared memory, 16 bytes a copy where the rows allow it
//     (VEC), else 4 bytes a copy; zero past the matrix's edge.
//   * `pipelined`: a ring of STAGES shared-memory stages; slice i + 2 is
//     copied while slice i is multiplied.
//   * 3xTF32 (`Tf32x3`): each float32 operand is split once into tf32
//     parts, hi = a rounded to nearest (ties away) on its bits and lo = a
//     - hi (exact), which the tensor cores read truncated to tf32; a b is
//     accumulated as a_lo b_hi + a_hi b_lo + a_hi b_hi with mma.sync
//     m16n8k8 (a_lo b_lo, ~2^-21 relative, is dropped): within ~2^-20 of
//     float32, where one tf32 pass is ~2^-11. Three integer and float
//     instructions a split (`cvt.rna.tf32` costs several more each). The
//     tensor cores' float32 accumulation truncates, so each slice's
//     products start from zero in the mma and are added to the running sum
//     with a rounded float32 add.
//   * `gate_kernel`: one tile of BM rows x BN hidden columns x the three
//     gates [r | z | n] of x wx and h wh, with the gate math in registers.
//     A thread block cluster of CS blocks splits the (d_in + d_h)-deep
//     contraction; the partial sums meet in block 0's registers through
//     distributed shared memory in rank order (deterministic). With
//     SCATTER (the TGN flush's update, fused_flush.cu) the forward writes
//     row r of the tile to row orow[r] of `out`, skips rows with orow[r]
//     < 0, and zeroes `out` row n_dump.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gru {

constexpr int BK = 32;        // depth of a staged slice
constexpr int THREADS = 128;  // four warps
constexpr int STAGES = 3;     // the cp.async ring
constexpr int BM = 32;        // rows of a gate tile
constexpr int BN = 32;        // hidden columns of a gate tile
constexpr int CS = 2;         // blocks of a gate tile's cluster

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy of which the first `bytes` are read, the rest zero-filled.
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of the row-major matrix g
// (leading dimension ld) into s (row stride S floats), zero where a row is
// >= rlim or a column >= clim. VEC: 16-byte copies, which need g 16-byte
// aligned and ld, c0 multiples of 4; else one float a copy (any stride).
template <int R, int C, int S, bool VEC>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int r0, int c0, int rlim,
                                          int clim) {
  if constexpr (VEC) {
    constexpr int CH = C / 4, N = R * CH;
#pragma unroll
    for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
      const int e = i * THREADS + static_cast<int>(threadIdx.x);
      if (N % THREADS != 0 && e >= N) break;
      const int r = e / CH, c = (e % CH) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < rlim ? min(max(clim - gc, 0), 4) : 0;
      cp_async16(s + r * S + c,
                 n > 0 ? g + static_cast<size_t>(gr) * ld + gc : g, 4 * n);
    }
  } else {
    constexpr int N = R * C;
#pragma unroll 4
    for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
      const int e = i * THREADS + static_cast<int>(threadIdx.x);
      if (N % THREADS != 0 && e >= N) break;
      const int r = e / C, c = e % C;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rlim && gc < clim;
      cp_async4(s + r * S + c,
                ok ? g + static_cast<size_t>(gr) * ld + gc : g, ok ? 4 : 0);
    }
  }
}

// n slices through the ring: load(slice, stage) issues the copies of a
// slice, compute(slice, stage) uses it.
template <class Load, class Compute>
__device__ __forceinline__ void pipelined(int n, Load load,
                                          Compute compute) {
#pragma unroll 1
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load(i, i);
    cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // slice i has landed
    __syncthreads();              // ... for all; slice i - 1 is used up
    const int next = i + STAGES - 1;
    if (next < n) load(next, next % STAGES);
    cp_async_commit();
    compute(i, i % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// c (16 x 8) += a (16 x 8, row) b (8 x 8, col), tf32 in, float32 out
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of the tiles: an A fragment (16 x 8) and a B fragment
// (8 x 8) as float32 values, split once each, then c += a b.
struct Tf32x3 {
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  // hi: x rounded to tf32 on its bits (half an ulp added, the low 13 bits
  // cleared); lo = x - hi, exact in float32
  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ A split_a(const float (&v)[4]) {
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[e], a.hi[e], a.lo[e]);
    return a;
  }
  static __device__ __forceinline__ B split_b(float b0, float b1) {
    B b;
    split(b0, b.hi[0], b.lo[0]);
    split(b1, b.hi[1], b.lo[1]);
    return b;
  }
  // the small terms first
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
    mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x (rows, din), h (rows, dh), wx (din, 3 dh), wh (dh, 3 dh), bx, bh
// (3 dh,). Forward: out = h'. Backward (g set): out = g z (dh's direct
// term), dgx and dgh (rows, 3 dh) the grads of x wx + bx and h wh + bh.
// Forward with SCATTER: out is a (n_dump + 1, dh) table, row r of h' goes
// to out row orow[r] (none if < 0; distinct rows), out row n_dump is
// zeroed.
struct GateArgs {
  const float *x, *h, *wx, *wh, *bx, *bh, *g;
  int rows, din, dh;
  float *out, *dgx, *dgh;
  const int* orow;
  int n_dump;
};

// Four warps of a gate tile, each one m16 row block and NT n8 column
// blocks of every gate; stage: x or h as [m][k] (row stride BK + 4: a
// warp's fragment reads hit 32 banks) and the three gate column groups of
// wx or wh as [gate][k][n] (stride BN + 8, ditto).
namespace tile {
constexpr int WARPS_M = BM / 16;
constexpr int WARPS_N = (THREADS / 32) / WARPS_M;
constexpr int NT = BN / 8 / WARPS_N;
constexpr int AS = BK + 4;
constexpr int BS = BN + 8;
constexpr int A_FLOATS = BM * AS;
constexpr int STAGE = A_FLOATS + 3 * BK * BS;
constexpr size_t SMEM = STAGES * STAGE * sizeof(float);
static_assert(WARPS_M * WARPS_N * 32 == THREADS && NT >= 1, "tile");
static_assert(STAGES * STAGE >= 16 * NT * THREADS,
              "the stages hold a block's partial sums");
}  // namespace tile

// The slices of the contraction are those of x wx (ceil(din / BK)), then
// those of h wh (ceil(dh / BK)); block `rank` of a cluster takes the
// rank-th of CS equal runs of them. Accumulators: r and z over both
// products (their pre-activations are sums of both), n apart for x wx and
// h wh (r multiplies the latter). Block 0 reads what its epilogue needs
// (h, the biases, g, orow) before the mainloop, so that its latency is
// hidden.
template <bool BWD, bool VEC, bool SCATTER = false>
__global__ void __launch_bounds__(THREADS)
gate_kernel(const GateArgs p) {
  static_assert(!(BWD && SCATTER), "the scatter is the forward's");
  using namespace tile;
  extern __shared__ __align__(16) float smem[];
  auto cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / CS) * BM, col0 = blockIdx.y * BN;
  const int sx = (p.din + BK - 1) / BK, total = sx + (p.dh + BK - 1) / BK;
  const int per = (total + CS - 1) / CS;
  const int sb = min(total, rank * per), se = min(total, sb + per);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int dh = p.dh;
  float acc[4][NT][4] = {};  // r, z, n of x wx, n of h wh

  // element e of n8 block j: row r0 + (e >> 1) 8, column c0 + (e & 1)
  const int r0 = row0 + wm * 16 + gq;
  auto col = [&](int j, int e) {
    return col0 + (wn * NT + j) * 8 + 2 * tq + (e & 1);
  };
  // the epilogue's operands: h (and g), and per column the biases of r
  // and z (bx + bh) and of n (bx, bh apart)
  float hv[NT][4] = {}, gv[NT][4] = {}, bias[NT][2][4] = {};
  int dst[2] = {-1, -1};  // SCATTER: out rows of rows r0 and r0 + 8
  if (rank == 0) {
    if constexpr (SCATTER) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r0 + 8 * i < p.rows) dst[i] = p.orow[r0 + 8 * i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, c = col(j, e);
        if (c >= dh) continue;
        if (e < 2) {
          bias[j][e][0] = p.bx[c] + p.bh[c];
          bias[j][e][1] = p.bx[dh + c] + p.bh[dh + c];
          bias[j][e][2] = p.bx[2 * dh + c];
          bias[j][e][3] = p.bh[2 * dh + c];
        }
        if (r >= p.rows) continue;
        hv[j][e] = p.h[static_cast<size_t>(r) * dh + c];
        if constexpr (BWD) gv[j][e] = p.g[static_cast<size_t>(r) * dh + c];
      }
  }

  auto load = [&](int slice, int stage) {
    const int s = sb + slice;
    float* as = smem + stage * STAGE;
    float* bs = as + A_FLOATS;
    const bool isx = s < sx;
    const int k0 = (isx ? s : s - sx) * BK, kdim = isx ? p.din : dh;
    const float* w = isx ? p.wx : p.wh;
    load_tile<BM, BK, AS, VEC>(as, isx ? p.x : p.h, kdim, row0, k0, p.rows,
                               kdim);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      load_tile<BK, BN, BS, VEC>(bs + q * BK * BS, w + q * dh, 3 * dh, k0,
                                 col0, kdim, dh);
  };

  auto compute = [&](int slice, int stage) {
    const float* as = smem + stage * STAGE;
    const float* bs = as + A_FLOATS;
    float part[3][NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const float* ap = as + (wm * 16 + gq) * AS + kk + tq;
      const Tf32x3::A a =
          Tf32x3::split_a({ap[0], ap[8 * AS], ap[4], ap[8 * AS + 4]});
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* bp =
              bs + (q * BK + kk + tq) * BS + (wn * NT + j) * 8 + gq;
          Tf32x3::mma(part[q][j], a, Tf32x3::split_b(bp[0], bp[4 * BS]));
        }
    }
    const bool isx = sb + slice < sx;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][j][e] += part[0][j][e];
        acc[1][j][e] += part[1][j][e];
        if (isx)
          acc[2][j][e] += part[2][j][e];
        else
          acc[3][j][e] += part[2][j][e];
      }
  };

  pipelined(se - sb, load, compute);

  // Block 0 gets the sum of every block's acc through distributed shared
  // memory, added in rank order; the stages are free (pipelined waited
  // for every copy).
  constexpr int N = 16 * NT;
  float(&flat)[N] = reinterpret_cast<float(&)[N]>(acc);
  if (rank != 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) smem[i * THREADS + threadIdx.x] = flat[i];
  }
  cluster.sync();
  if (rank == 0) {
#pragma unroll 1
    for (int r = 1; r < CS; ++r) {
      const float* other = cluster.map_shared_rank(smem, r);
#pragma unroll
      for (int i = 0; i < N; ++i) flat[i] += other[i * THREADS + threadIdx.x];
    }
  }
  cluster.sync();  // block 0 has read every other block's sums
  if (rank != 0) return;
  if constexpr (SCATTER) {
    // no row of the tile goes to n_dump, and the tile reads h, not out
    if (blockIdx.x / CS == 0)
      for (int c = threadIdx.x; c < BN && col0 + c < dh; c += THREADS)
        p.out[static_cast<size_t>(p.n_dump) * dh + col0 + c] = 0.0f;
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >> 1) * 8, c = col(j, e);
      if (r >= p.rows || c >= dh) continue;
      const float* b = bias[j][e & 1];
      const size_t o = static_cast<size_t>(r) * dh + c;
      const float rg = sigmoidf(acc[0][j][e] + b[0]);
      const float zg = sigmoidf(acc[1][j][e] + b[1]);
      const float nh = acc[3][j][e] + b[3];
      const float ng = tanhf((acc[2][j][e] + b[2]) + rg * nh);
      if constexpr (!BWD) {
        const float hn = (1.0f - zg) * ng + zg * hv[j][e];
        if constexpr (SCATTER) {
          const int w = dst[e >> 1];
          if (w >= 0) p.out[static_cast<size_t>(w) * dh + c] = hn;
        } else {
          p.out[o] = hn;
        }
      } else {
        const float g = gv[j][e];
        const float dpre_n = g * (1.0f - zg) * (1.0f - ng * ng);
        const float dpre_r = (dpre_n * nh) * rg * (1.0f - rg);
        const float dpre_z = g * (hv[j][e] - ng) * zg * (1.0f - zg);
        const size_t o3 = static_cast<size_t>(r) * 3 * dh + c;
        p.dgx[o3] = dpre_r;
        p.dgx[o3 + dh] = dpre_z;
        p.dgx[o3 + 2 * dh] = dpre_n;
        p.dgh[o3] = dpre_r;
        p.dgh[o3 + dh] = dpre_z;
        p.dgh[o3 + 2 * dh] = dpre_n * rg;
        p.out[o] = g * zg;  // the product dgh wh^T is added by pass 2
      }
    }
}

// Launch Kernel with SMEM bytes of dynamic shared memory as clusters of
// `cluster` blocks along x. Above 48 KB the kernel needs an attribute,
// set at its first launch (the port drives one card a process).
template <auto Kernel, size_t SMEM, class Args>
cudaError_t launch(dim3 grid, int cluster, cudaStream_t stream,
                   const Args& p) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

inline bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// 16-byte copies need every row stride and gate offset a multiple of four
// floats and every base 16-byte aligned
inline bool vec_ok(const GateArgs& p) {
  return p.din % 4 == 0 && p.dh % 4 == 0 && aligned16(p.x) &&
         aligned16(p.h) && aligned16(p.wx) && aligned16(p.wh);
}

template <bool BWD, bool SCATTER = false>
int launch_gates(const GateArgs& p, cudaStream_t stream) {
  const dim3 grid(CS * ((p.rows + BM - 1) / BM), (p.dh + BN - 1) / BN);
  const cudaError_t err =
      vec_ok(p) ? launch<gate_kernel<BWD, true, SCATTER>, tile::SMEM>(
                      grid, CS, stream, p)
                : launch<gate_kernel<BWD, false, SCATTER>, tile::SMEM>(
                      grid, CS, stream, p);
  return static_cast<int>(err);
}

}  // namespace gru
