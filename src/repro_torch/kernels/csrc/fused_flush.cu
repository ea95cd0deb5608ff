// Fused TGN message flush: segment-mean of the pending messages, GRU
// update of the touched memory rows, scatter of mem / last.
//
// Replaces the TPU kernel `_flush_kernel` of
// src/repro/kernels/fused_flush.py (entry `fused_flush_fwd`).
//
// Two launches, because CUDA blocks run concurrently and the dump row can
// only be cleared after every write:
//   1. `flush_rows_kernel`, one block per pending row i (R = 2B):
//      - the block lists, in ascending order, the rows j whose live id
//        equals ids[i] (warp ballots over the R ids held in shared memory);
//      - it averages those rows of `msg` into mbar (written for every row);
//      - only the first occurrence of a live id goes on: it reads mem[id],
//        computes gx = mbar.wx + bx and gh = h.wh + bh as GEMVs (one thread
//        per gate output), applies the [r|z|n] gates and writes mem'[id]
//        and last'[id] = max(last[id], max ts of its rows).
//      Duplicates and padding rows write only mbar, so no block writes a
//      row another block writes, and every read is of the unmodified input.
//   2. `flush_zero_dump_kernel` zeroes mem'[N] and last'[N].
// The outputs are fresh copies of mem / last made by the wrapper (out of
// place, so autograd can recompute from the saved inputs); writing in
// place is later work.
//
// Bound on an H100 at the slice's shapes (R = 400, dm = 616, d = 172,
// N = 10,000): about 0.33 GFLOP of float32 GEMV (R x 2 x 788 x 516, at
// 67 TFLOP/s about 5 us) and about 4 MB of rows and weights, plus the
// out-of-place copy of mem (6.9 MB read and written, about 4 us). Per
// block, each first occurrence streams all of wx and wh (1.6 MB) from L2,
// so the kernel is bound by L2 bandwidth over R blocks, far above both;
// tiling several rows per block to reuse the weights is the next step.
#include "common.cuh"

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void flush_rows_kernel(
    const int* __restrict__ ids, const float* __restrict__ msg,
    const float* __restrict__ ts, const float* __restrict__ mem,
    const float* __restrict__ last, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ bx,
    const float* __restrict__ bh, int rows, int dm, int d, int n_dump,
    float* __restrict__ mem_out, float* __restrict__ last_out,
    float* __restrict__ mbar_out) {
  extern __shared__ float smem[];
  int* ids_s = reinterpret_cast<int*>(smem);  // [rows]
  int* match = ids_s + rows;                  // [rows]
  float* mbar_s = reinterpret_cast<float*>(match + rows);  // [dm]
  float* h_s = mbar_s + dm;                   // [d]
  float* gx_s = h_s + d;                      // [3d]
  float* gh_s = gx_s + 3 * d;                 // [3d]
  __shared__ int n_match;

  const int i = blockIdx.x;
  const int id = ids[i];
  const bool live = id < n_dump;
  for (int j = threadIdx.x; j < rows; j += blockDim.x) ids_s[j] = ids[j];
  __syncthreads();

  // rows with the same live id, in ascending order (deterministic sums)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int j0 = 0; j0 < rows; j0 += 32) {
      const int j = j0 + lane;
      const bool eq = live && j < rows && ids_s[j] == id;
      const unsigned m = __ballot_sync(0xffffffffu, eq);
      if (eq) match[base + __popc(m & ((1u << lane) - 1u))] = j;
      base += __popc(m);
    }
    if (lane == 0) n_match = base;
  }
  __syncthreads();
  const int cnt = n_match;
  const float denom = fmaxf(static_cast<float>(cnt), 1.0f);
  for (int c = threadIdx.x; c < dm; c += blockDim.x) {
    float s = 0.0f;
    for (int m = 0; m < cnt; ++m)
      s += msg[static_cast<size_t>(match[m]) * dm + c];
    const float v = s / denom;
    mbar_s[c] = v;
    mbar_out[static_cast<size_t>(i) * dm + c] = v;
  }
  // block-uniform: padding rows and non-first duplicates are done
  if (!live || match[0] != i) return;

  for (int c = threadIdx.x; c < d; c += blockDim.x)
    h_s[c] = mem[static_cast<size_t>(id) * d + c];
  __syncthreads();

  const int g3 = 3 * d;
  for (int o = threadIdx.x; o < g3; o += blockDim.x) {
    float ax = 0.0f, ah = 0.0f;
#pragma unroll 8
    for (int c = 0; c < dm; ++c)
      ax = fmaf(mbar_s[c], wx[static_cast<size_t>(c) * g3 + o], ax);
#pragma unroll 8
    for (int c = 0; c < d; ++c)
      ah = fmaf(h_s[c], wh[static_cast<size_t>(c) * g3 + o], ah);
    gx_s[o] = ax + bx[o];
    gh_s[o] = ah + bh[o];
  }
  __syncthreads();

  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float r = sigmoidf(gx_s[c] + gh_s[c]);
    const float z = sigmoidf(gx_s[d + c] + gh_s[d + c]);
    const float n = tanhf(gx_s[2 * d + c] + r * gh_s[2 * d + c]);
    mem_out[static_cast<size_t>(id) * d + c] = (1.0f - z) * n + z * h_s[c];
  }
  if (threadIdx.x == 0) {
    float tmax = ts[match[0]];
    for (int m = 1; m < cnt; ++m) tmax = fmaxf(tmax, ts[match[m]]);
    last_out[id] = fmaxf(last[id], tmax);
  }
}

__global__ void flush_zero_dump_kernel(float* __restrict__ mem_out,
                                       float* __restrict__ last_out, int d,
                                       int n_dump) {
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    mem_out[static_cast<size_t>(n_dump) * d + c] = 0.0f;
  if (threadIdx.x == 0) last_out[n_dump] = 0.0f;
}

extern "C" int fused_flush(
    const void* ids, const void* msg, const void* ts, const void* mem,
    const void* last, const void* wx, const void* wh, const void* bx,
    const void* bh, int rows, int dm, int d, int n_dump, void* mem_out,
    void* last_out, void* mbar_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    const size_t shmem = sizeof(int) * 2 * rows + sizeof(float) * (dm + 7 * d);
    if (shmem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          flush_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    // one thread per gate output, in whole warps, at most 1024
    int threads = ((3 * d + 31) / 32) * 32;
    threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
    flush_rows_kernel<<<rows, threads, shmem, s>>>(
        static_cast<const int*>(ids), static_cast<const float*>(msg),
        static_cast<const float*>(ts), static_cast<const float*>(mem),
        static_cast<const float*>(last), static_cast<const float*>(wx),
        static_cast<const float*>(wh), static_cast<const float*>(bx),
        static_cast<const float*>(bh), rows, dm, d, n_dump,
        static_cast<float*>(mem_out), static_cast<float*>(last_out),
        static_cast<float*>(mbar_out));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flush_zero_dump_kernel<<<1, 256, 0, s>>>(static_cast<float*>(mem_out),
                                            static_cast<float*>(last_out), d,
                                            n_dump);
  return static_cast<int>(cudaGetLastError());
}
