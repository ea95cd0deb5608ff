// Fused TGN message flush: segment-mean of the pending messages, GRU
// update of the touched memory rows, in-place update of mem / last.
//
// Replaces the TPU kernel `_flush_kernel` of
// src/repro/kernels/fused_flush.py (entry `fused_flush_fwd`), which also
// updates mem / last in place (`input_output_aliases`) and sends
// non-first duplicates' writes away from the live rows.
//
// Two launches, stream-ordered:
//   A. `flush_gather_kernel`, one block per pending row i (R = 2B):
//      - the block lists, in ascending order, the rows j whose live id
//        equals ids[i] (warp ballots over the R ids held in shared memory),
//        so the sums are deterministic;
//      - the mean of msg over an id's cnt rows is split by columns among
//        its cnt blocks: the k-th of them sums columns [k dm / cnt, (k +
//        1) dm / cnt) and writes them to mbar at all cnt rows (a padding
//        row's block writes its own zeros). Within a block, G row groups
//        sum a column's rows in a fixed order, then one thread adds the G
//        partials in order: deterministic, and an id on many rows is not
//        a chain of cnt dependent loads in one thread (the mid-epoch batch
//        of chip_smoke.py has 74 distinct ids on its 400 rows; a block
//        that summed all dm columns of its id alone took ~38 us there);
//      - it copies h_g[i] = mem[ids[i]] into an (R, d) scratch, which is
//        also what the backward keeps (the rows before the update);
//      - it writes orow[i] = ids[i] for the first occurrence of a live id,
//        else -1, and that block alone raises last[id] to the max of
//        last[id] and its rows' ts, in place;
//      - block 0 zeroes last[N] (no block reads it).
//      A never writes mem, so every block reads the input rows.
//   B. the GRU gate tile of fused_gru (gru_tile.cuh, 3xTF32 on the tensor
//      cores) on x = mbar, h = h_g, with the SCATTER epilogue: row r of
//      h' goes to mem[orow[r]] when orow[r] >= 0, and mem[N] is zeroed (A
//      read it for padding rows). B reads only h_g, mbar and the weights,
//      and writes distinct mem rows, so blocks of different column tiles
//      cannot race; running the tile on mem itself would let one column
//      tile read h columns another had already overwritten.
//
// Bound on an H100 at the TGN path's shape (R = 400, dm = 616, d = 172,
// N = 10,000): the larger of the products of the U <= R first
// occurrences, 3 x U x 2 x 788 x 516 FLOP at 495 TFLOP/s of dense TF32,
// and about 3.7 MB of pending rows, weights, touched memory rows and mbar
// at 3.35 TB/s (1.1 us): bytes at the mid-epoch batch of chip_smoke.py
// (U = 74). Launch B does fused_gru's work at (R, dm, d), all R rows.
#include "common.cuh"
#include "gru_tile.cuh"

namespace {

constexpr int GATHER_THREADS = 256;

// mbar[rows] = the mean of msg over rows, columns [c0, c0 + w) only.
// part: GATHER_THREADS floats of shared memory.
__device__ __forceinline__ void mean_columns(const float* __restrict__ msg,
                                             const int* rows, int cnt,
                                             int dm, int c0, int w,
                                             float* part,
                                             float* __restrict__ mbar) {
  const int t = threadIdx.x;
  const float inv = 1.0f / static_cast<float>(cnt);
  if (w >= GATHER_THREADS) {  // few rows: a thread per column
    for (int c = c0 + t; c < c0 + w; c += GATHER_THREADS) {
      float s = 0.0f;
      for (int m = 0; m < cnt; ++m)
        s += msg[static_cast<size_t>(rows[m]) * dm + c];
      for (int m = 0; m < cnt; ++m)
        mbar[static_cast<size_t>(rows[m]) * dm + c] = s * inv;
    }
    return;
  }
  const int groups = GATHER_THREADS / w;  // >= 1
  const int g = t / w, c = c0 + t % w;
  if (g < groups) {
    float s = 0.0f;
    for (int m = g; m < cnt; m += groups)
      s += msg[static_cast<size_t>(rows[m]) * dm + c];
    part[t] = s;
  }
  __syncthreads();
  if (t < w) {
    float s = 0.0f;
    for (int q = 0; q < groups; ++q) s += part[q * w + t];
    part[t] = s * inv;  // read by the writes below, after the barrier
  }
  __syncthreads();
  for (int e = t; e < cnt * w; e += GATHER_THREADS)
    mbar[static_cast<size_t>(rows[e / w]) * dm + c0 + e % w] = part[e % w];
}

__global__ void __launch_bounds__(GATHER_THREADS)
flush_gather_kernel(const int* __restrict__ ids, const float* __restrict__ msg,
                    const float* __restrict__ ts,
                    const float* __restrict__ mem, float* __restrict__ last,
                    int rows, int dm, int d, int n_dump,
                    float* __restrict__ mbar, float* __restrict__ h_g,
                    int* __restrict__ orow) {
  extern __shared__ int smem_i[];
  int* ids_s = smem_i;         // [rows]
  int* match = ids_s + rows;   // [rows]
  __shared__ int n_match, pos;
  __shared__ float part[GATHER_THREADS];

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
      const int at = base + __popc(m & ((1u << lane) - 1u));
      if (eq) match[at] = j;
      if (eq && j == i) pos = at;
      base += __popc(m);
    }
    if (lane == 0) n_match = base;
  }
  __syncthreads();
  const int cnt = n_match;
  const bool first = live && match[0] == i;  // block-uniform
  if (live) {
    const int k = pos;
    const int c0 = static_cast<int>(static_cast<long long>(k) * dm / cnt);
    const int c1 =
        static_cast<int>(static_cast<long long>(k + 1) * dm / cnt);
    if (c1 > c0) mean_columns(msg, match, cnt, dm, c0, c1 - c0, part, mbar);
  } else {
    for (int c = threadIdx.x; c < dm; c += blockDim.x)
      mbar[static_cast<size_t>(i) * dm + c] = 0.0f;
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    h_g[static_cast<size_t>(i) * d + c] = mem[static_cast<size_t>(id) * d + c];
  if (threadIdx.x == 0) {
    orow[i] = first ? id : -1;
    if (first) {
      float tmax = ts[i];
      for (int m = 1; m < cnt; ++m) tmax = fmaxf(tmax, ts[match[m]]);
      last[id] = fmaxf(last[id], tmax);
    }
    if (i == 0) last[n_dump] = 0.0f;
  }
}

}  // namespace

// ids (rows,) int32 in [0, n_dump]; msg (rows, dm); ts (rows,); mem
// (n_dump + 1, d) and last (n_dump + 1,), updated in place; wx (dm, 3 d),
// wh (d, 3 d), bx, bh (3 d,); writes mbar (rows, dm), h_g (rows, d) and
// orow (rows,) int32. float32, contiguous.
extern "C" int fused_flush(const void* ids, const void* msg, const void* ts,
                           void* mem, void* last, const void* wx,
                           const void* wh, const void* bx, const void* bh,
                           int rows, int dm, int d, int n_dump, void* mbar,
                           void* h_g, void* orow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mem_f = static_cast<float*>(mem);
  float* last_f = static_cast<float*>(last);
  if (rows == 0) {  // nothing pending: only the dump row is cleared
    cudaMemsetAsync(mem_f + static_cast<size_t>(n_dump) * d, 0,
                    sizeof(float) * d, s);
    cudaMemsetAsync(last_f + n_dump, 0, sizeof(float), s);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t shmem = sizeof(int) * 2 * rows;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flush_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flush_gather_kernel<<<rows, GATHER_THREADS, shmem, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(msg),
      static_cast<const float*>(ts), mem_f, last_f, rows, dm, d, n_dump,
      static_cast<float*>(mbar), static_cast<float*>(h_g),
      static_cast<int*>(orow));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const gru::GateArgs p{
      static_cast<const float*>(mbar), static_cast<const float*>(h_g),
      static_cast<const float*>(wx),   static_cast<const float*>(wh),
      static_cast<const float*>(bx),   static_cast<const float*>(bh),
      nullptr,                         rows,
      dm,                              d,
      mem_f,                           nullptr,
      nullptr,                         static_cast<const int*>(orow),
      n_dump};
  return gru::launch_gates<false, true>(p, s);
}
