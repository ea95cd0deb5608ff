// Temporal neighbor attention, forward and backward.
//
// Replaces the TPU kernels `_attn_kernel` (entry `temporal_attn`) and
// `_attn_bwd_kernel` (entry `temporal_attn_bwd`) of
// src/repro/kernels/temporal_attn.py.
//
// Layout as the JAX package's: q (B, H, D); k, v (B, K, H, D); mask
// (B, K) bool; out (B, H, D). One warp per (row, head) pair; the lanes
// stride over D, so every k / v row read is one coalesced segment. K is
// small (10 on the slice), so the K scores of a pair live in shared memory
// beside the warp and each is one warp reduction. Masked slots are skipped
// (their -1e30 score underflows to an exact 0 weight in the reference), and
// a row with no valid neighbor gives exactly 0.
//
// The backward recomputes the softmax from (q, k, v, mask), as the TPU
// kernel does, then
//   dv = att (x) g,  datt = g.v,  ds = att * (datt - sum(att * datt)),
//   dq = sum_k ds k * scale,  dk = ds (x) q * scale.
// Each pair owns its outputs, so there are no atomics and the result is
// deterministic.
//
// Bound on an H100: memory. At the slice's shapes (B = 600, H = 2,
// D = 86, K = 10) the forward reads q, k, v and writes out, about 9 MB
// (2.7 us at 3.35 TB/s), against 4 MFLOP of arithmetic; the backward
// moves about 18 MB. The design reads each operand once, keeps the
// scores in shared memory, and writes each output once.
#include <math.h>

#include "common.cuh"

constexpr int kWarps = 8;  // (row, head) pairs per block

// Softmax weights of one (row, head) into att[0..kn): exact zeros for
// masked slots, all zeros if the row has no valid neighbor. Scores are
// q.k / sqrt(D) in the forward (as the reference) and q.k * scale in the
// backward (as the TPU backward kernel).
__device__ void softmax_weights(const float* __restrict__ qp,
                                const float* __restrict__ k,
                                const bool* __restrict__ mrow, int b, int h,
                                int heads, int kn, int dh, bool mul_scale,
                                float* att) {
  const int lane = threadIdx.x & 31;
  const float rs = sqrtf(static_cast<float>(dh));
  float m = -INFINITY;
  for (int j = 0; j < kn; ++j) {
    if (!mrow[j]) continue;  // warp-uniform
    const float* kp = k + ((static_cast<size_t>(b) * kn + j) * heads + h) * dh;
    float p = 0.0f;
    for (int c = lane; c < dh; c += 32) p = fmaf(qp[c], kp[c], p);
    p = warp_sum(p);
    p = mul_scale ? p * (1.0f / rs) : p / rs;
    if (lane == 0) att[j] = p;
    m = fmaxf(m, p);
  }
  __syncwarp();
  float den = 0.0f;
  for (int j = 0; j < kn; ++j)
    if (mrow[j]) den += expf(att[j] - m);
  __syncwarp();
  if (lane == 0)
    for (int j = 0; j < kn; ++j)
      att[j] = mrow[j] ? expf(att[j] - m) / den : 0.0f;
  __syncwarp();
}

__global__ void attn_fwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const bool* __restrict__ mask, int rows,
                                int heads, int kn, int dh,
                                float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= rows * heads) return;  // warp-uniform; only warp syncs follow
  const int b = pair / heads, h = pair % heads;
  float* att = smem + warp * kn;
  const float* qp = q + static_cast<size_t>(pair) * dh;
  softmax_weights(qp, k, mask + static_cast<size_t>(b) * kn, b, h, heads, kn,
                  dh, false, att);
  float* op = out + static_cast<size_t>(pair) * dh;
  for (int c = lane; c < dh; c += 32) {
    float acc = 0.0f;
    for (int j = 0; j < kn; ++j)
      acc = fmaf(att[j],
                 v[((static_cast<size_t>(b) * kn + j) * heads + h) * dh + c],
                 acc);
    op[c] = acc;
  }
}

__global__ void attn_bwd_kernel(const float* __restrict__ g,
                                const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const bool* __restrict__ mask, int rows,
                                int heads, int kn, int dh,
                                float* __restrict__ dq,
                                float* __restrict__ dk,
                                float* __restrict__ dv) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= rows * heads) return;
  const int b = pair / heads, h = pair % heads;
  float* att = smem + warp * 2 * kn;
  float* ds = att + kn;
  const bool* mrow = mask + static_cast<size_t>(b) * kn;
  const float* qp = q + static_cast<size_t>(pair) * dh;
  const float* gp = g + static_cast<size_t>(pair) * dh;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  softmax_weights(qp, k, mrow, b, h, heads, kn, dh, true, att);

  // datt_j = g.v_j, then ds_j = att_j (datt_j - sum_i att_i datt_i)
  float sad = 0.0f;
  for (int j = 0; j < kn; ++j) {
    float p = 0.0f;
    if (mrow[j]) {
      const float* vp =
          v + ((static_cast<size_t>(b) * kn + j) * heads + h) * dh;
      for (int c = lane; c < dh; c += 32) p = fmaf(gp[c], vp[c], p);
      p = warp_sum(p);
    }
    if (lane == 0) ds[j] = p;
    sad += att[j] * p;
  }
  __syncwarp();
  if (lane == 0)
    for (int j = 0; j < kn; ++j) ds[j] = att[j] * (ds[j] - sad);
  __syncwarp();

  for (int c = lane; c < dh; c += 32) {
    const float gc = gp[c], qc = qp[c];
    float acc = 0.0f;
    for (int j = 0; j < kn; ++j) {
      const size_t o = ((static_cast<size_t>(b) * kn + j) * heads + h) * dh + c;
      acc = fmaf(ds[j], k[o], acc);
      dv[o] = att[j] * gc;
      dk[o] = ds[j] * qc * scale;
    }
    dq[static_cast<size_t>(pair) * dh + c] = acc * scale;
  }
}

extern "C" int temporal_attn_fwd(const void* q, const void* k, const void* v,
                                 const void* mask, int rows, int heads,
                                 int kn, int dh, void* out, void* stream) {
  const int pairs = rows * heads;
  if (pairs == 0) return 0;
  attn_fwd_kernel<<<(pairs + kWarps - 1) / kWarps, 32 * kWarps,
                    sizeof(float) * kWarps * kn,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const bool*>(mask), rows,
      heads, kn, dh, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int temporal_attn_bwd(const void* g, const void* q, const void* k,
                                 const void* v, const void* mask, int rows,
                                 int heads, int kn, int dh, void* dq,
                                 void* dk, void* dv, void* stream) {
  const int pairs = rows * heads;
  if (pairs == 0) return 0;
  attn_bwd_kernel<<<(pairs + kWarps - 1) / kWarps, 32 * kWarps,
                    sizeof(float) * kWarps * 2 * kn,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const bool*>(mask), rows, heads, kn, dh,
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv));
  return static_cast<int>(cudaGetLastError());
}
