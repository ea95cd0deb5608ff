// Temporal neighbor sampling over a device-resident T-CSR.
//
// Replaces the TPU kernel `_sample_kernel` of
// src/repro/kernels/neighbor_sample.py (entry `neighbor_sample_fwd`).
//
// One thread per query row. The thread bisects (bisect_left) the node's
// time-sorted segment [indptr[n], indptr[n+1]) of `bat` for the key
// batch_of + 1, then gathers the K-wide window [end-(w+1)K, end-wK) of
// nbr / t / eidx; slots before the segment start are -1 / -1.0. The
// export front-pads the event arrays by K * depth, so every window below
// the export depth is in bounds; a deeper window only reads slots it
// masks.
//
// Bound on an H100: dependent latency, not bandwidth. A row makes about
// log2(segment) serial probes (each an L2 or HBM round trip) and moves
// under 100 bytes; at R = 600 rows the whole call moves under 100 KB. The
// design keeps every probe of a row in one thread's registers, so a row
// costs one chain of loads and nothing else, and the 600 rows run in
// parallel across the card.
#include "common.cuh"

__global__ void neighbor_sample_kernel(
    const int* __restrict__ indptr, const int* __restrict__ nbr,
    const float* __restrict__ t, const int* __restrict__ eidx,
    const int* __restrict__ bat, const int* __restrict__ nodes,
    const int* __restrict__ batch_of, int batch_of_scalar,
    const int* __restrict__ window, int window_scalar, int rows, int k,
    int* __restrict__ ids_out, float* __restrict__ t_out,
    int* __restrict__ e_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int node = nodes[r];
  const int start = indptr[node];
  const int key = (batch_of ? batch_of[r] : batch_of_scalar) + 1;
  const int win = window ? window[r] : window_scalar;
  int lo = start, hi = indptr[node + 1];
  while (lo < hi) {  // bisect_left; lo, hi >= 0 so >> 1 is floor division
    const int mid = (lo + hi) >> 1;
    if (bat[mid] < key) lo = mid + 1; else hi = mid;
  }
  const int base = lo - (win + 1) * k;
  for (int j = 0; j < k; ++j) {
    const int idx = base + j;
    const bool ok = idx >= start;
    const size_t o = static_cast<size_t>(r) * k + j;
    ids_out[o] = ok ? nbr[idx] : -1;
    t_out[o] = ok ? t[idx] : -1.0f;
    e_out[o] = ok ? eidx[idx] : -1;
  }
}

extern "C" int neighbor_sample(
    const void* indptr, const void* nbr, const void* t, const void* eidx,
    const void* bat, const void* nodes, const void* batch_of,
    int batch_of_scalar, const void* window, int window_scalar, int rows,
    int k, void* ids_out, void* t_out, void* e_out, void* stream) {
  if (rows == 0) return 0;
  const int threads = 128;
  neighbor_sample_kernel<<<(rows + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(nbr),
      static_cast<const float*>(t), static_cast<const int*>(eidx),
      static_cast<const int*>(bat), static_cast<const int*>(nodes),
      static_cast<const int*>(batch_of), batch_of_scalar,
      static_cast<const int*>(window), window_scalar, rows, k,
      static_cast<int*>(ids_out), static_cast<float*>(t_out),
      static_cast<int*>(e_out));
  return static_cast<int>(cudaGetLastError());
}
