// Temporal neighbor attention, forward and backward, for Hopper.
//
// Replaces the TPU kernels `_attn_kernel` (entry `temporal_attn_fwd`) and
// `_attn_bwd_kernel` (entry `temporal_attn_bwd`) of
// src/repro/kernels/temporal_attn.py.
//
// Layout as the JAX package's: q (B, H, D); k, v (B, K, H, D); mask
// (B, K) bool; out (B, H, D); float32. Scores are q.k / sqrt(D) in the
// forward (as the reference) and q.k * scale, scale = 1 / sqrt(D), in the
// backward (as the TPU backward kernel). Masked slots get exactly zero
// weight; a row with no valid neighbor gives exactly 0 in every output.
// The backward recomputes the softmax from (q, k, v, mask), then
//   datt = g.v,  ds = att * (datt - sum(att * datt)),
//   dq = sum_j ds_j k_j * scale,  dk_j = ds_j q * scale,  dv_j = att_j g.
//
// Bound on an H100: memory. At the TGN path's shape (B 600, H 2, D 86,
// K 10) the forward moves about 9 MB (q, k, v read, out written; 2.7 us at
// 3.35 TB/s, 2.0 us counting only the valid slots' k and v), the backward
// about 18 MB, against a few MFLOP. One row's working set is contiguous
// (q[b] 688 B, k[b] and v[b] 6,880 B each), so the kernel is held back by
// latency, not by bytes: a design that walks the K neighbors one after
// another waits through K dependent round trips. This one:
//   - stages the row asynchronously: a block owns one row (600 blocks of
//     128 threads at the path's shape, all resident at once); one thread
//     issues one 1-D bulk copy (TMA, `cp.async.bulk`) for each of q[b],
//     k[b], v[b] (and g[b] in the backward), all on one mbarrier, so
//     every load is in flight before any arithmetic starts; warp 0 reads
//     the mask meanwhile into a list of the valid slots (a ballot). Where
//     H * D is not a multiple of 4 or a pointer is not 16-byte aligned,
//     the same kernel stages with 4-byte `cp.async` instead (bulk copies
//     need 16-byte sizes and addresses);
//   - computes from shared memory across lanes: the (slot, head) dot
//     products in parallel, each split over a group of GROUP lanes (lane
//     `l` sums columns l, l + GROUP, ... with FMAs) and combined by a
//     butterfly of shuffles; max, exp and sum per head by one warp with
//     shuffles; the context (and dq, dk, dv) with lanes on (h, c), four
//     columns a thread and 16-byte stores where alignment allows. Masked
//     slots are skipped in the arithmetic and written as literal zeros;
//   - writes every output element exactly once: no atomics, no zero-fill
//     launch, deterministic.
// When a row's slots do not fit in shared memory at once (K 64, H 4, D 128
// needs 256 KB for k and v), the block walks contiguous slices of them
// (k[b, j0:j1] is contiguous) with an online softmax; the backward then
// takes two passes over the slices (the softmax statistics, then the
// gradients, the last slice kept staged).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TPR = 128;   // threads of a block, which owns one row
constexpr int WPR = TPR / 32;
constexpr int GROUP = 4;   // lanes of one (slot, head) dot product
static_assert(TPR % 32 == 0 && 32 % GROUP == 0, "block shape");

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* g;  // backward only
  const bool* mask;
  float* out;  // forward: out; backward: dq
  float* dk;
  float* dv;
  int rows, heads, kn, dh, hd;
  int ks;   // slots staged at a time
  int nsl;  // slices of ks slots
};

// Byte offsets of a block's shared memory; the mbarrier sits at 0.
struct Layout {
  int q, g, k, v, acc, sc, da, st, list, ok, total;
};

inline long long up16(long long x) {
  return (x + 15) & ~15LL;
}

// The layout for `ks` staged slots; `acc` holds the accumulators carried
// between slices (multi-slice only).
inline long long layout(Layout* L, int hd, int heads, int ks, bool bwd,
                        bool multi) {
  long long o = 16, at[10];
  const long long f = 4;
  at[0] = o; o = up16(o + f * hd);                                   // q
  at[1] = o; if (bwd) o = up16(o + f * hd);                          // g
  at[2] = o; o = up16(o + f * ks * static_cast<long long>(hd));      // k
  at[3] = o; o = up16(o + f * ks * static_cast<long long>(hd));      // v
  at[4] = o; if (multi) o = up16(o + f * hd);                        // acc
  at[5] = o; o = up16(o + f * ks * heads);                           // sc
  at[6] = o; if (bwd) o = up16(o + f * ks * heads);                  // da
  at[7] = o; o = up16(o + f * 4 * heads);                 // m, l, t, alpha
  at[8] = o; o = up16(o + f * (ks + 1));                   // list, count
  at[9] = o; o = up16(o + ks);                                       // ok
  if (L && o < (1LL << 30)) {
    L->q = at[0]; L->g = at[1]; L->k = at[2]; L->v = at[3];
    L->acc = at[4]; L->sc = at[5]; L->da = at[6]; L->st = at[7];
    L->list = at[8]; L->ok = at[9]; L->total = static_cast<int>(o);
  }
  return o;
}

// The row's views of the block's shared memory.
struct Row {
  float *q, *g, *k, *v, *acc, *sc, *da, *m, *l, *t, *alpha;
  int* list;  // valid slots of the slice, their count at list[ks]
  unsigned char* ok;
};

__device__ __forceinline__ Row row_views(unsigned char* base,
                                         const Layout& L, const Args& a) {
  Row s;
  s.q = reinterpret_cast<float*>(base + L.q);
  s.g = reinterpret_cast<float*>(base + L.g);
  s.k = reinterpret_cast<float*>(base + L.k);
  s.v = reinterpret_cast<float*>(base + L.v);
  s.acc = reinterpret_cast<float*>(base + L.acc);
  s.sc = reinterpret_cast<float*>(base + L.sc);
  s.da = reinterpret_cast<float*>(base + L.da);
  s.m = reinterpret_cast<float*>(base + L.st);
  s.l = s.m + a.heads;
  s.t = s.l + a.heads;
  s.alpha = s.t + a.heads;
  s.list = reinterpret_cast<int*>(base + L.list);
  s.ok = base + L.ok;
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1)
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

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(void* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int W>
__device__ __forceinline__ void load(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

// Stage slots [j0, j0 + nj) of row b, contiguous in k and v (and q[b],
// g[b] with `qg`). VEC: one bulk copy per tensor, issued by thread 0, all
// on the mbarrier `bar`; else 4-byte cp.async by every thread.
template <bool VEC, bool BWD>
__device__ __forceinline__ void stage(const Args& a, unsigned char* base,
                                      const Layout& L, int b, int j0, int nj,
                                      bool qg, uint32_t bar) {
  const size_t kv0 = (static_cast<size_t>(b) * a.kn + j0) * a.hd;
  const uint32_t kv_n = static_cast<uint32_t>(nj * a.hd);
  const uint32_t q_n = qg ? static_cast<uint32_t>(a.hd) : 0u;
  const size_t q0 = static_cast<size_t>(b) * a.hd;
  float* qs = reinterpret_cast<float*>(base + L.q);
  float* gs = reinterpret_cast<float*>(base + L.g);
  float* ks = reinterpret_cast<float*>(base + L.k);
  float* vs = reinterpret_cast<float*>(base + L.v);
  if constexpr (VEC) {
    if (threadIdx.x == 0) {
      // the generic-proxy reads of the previous slice come before these
      // asynchronous writes (a __syncthreads precedes every restage)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, 4u * (2u * kv_n + (BWD ? 2u : 1u) * q_n));
      if (q_n) {
        bulk_load(qs, a.q + q0, 4u * q_n, bar);
        if (BWD) bulk_load(gs, a.g + q0, 4u * q_n, bar);
      }
      if (kv_n) {
        bulk_load(ks, a.k + kv0, 4u * kv_n, bar);
        bulk_load(vs, a.v + kv0, 4u * kv_n, bar);
      }
    }
  } else {
    for (uint32_t i = threadIdx.x; i < q_n; i += blockDim.x) {
      cp_async4(qs + i, a.q + q0 + i);
      if (BWD) cp_async4(gs + i, a.g + q0 + i);
    }
    for (uint32_t i = threadIdx.x; i < kv_n; i += blockDim.x) {
      cp_async4(ks + i, a.k + kv0 + i);
      cp_async4(vs + i, a.v + kv0 + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

template <bool VEC>
__device__ __forceinline__ void stage_wait(uint32_t bar, uint32_t& phase) {
  if constexpr (VEC) {
    mbar_wait(bar, phase);
    phase ^= 1u;
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
}

// The valid slots of the slice as a list (warp 0, a ballot per 32 slots),
// their count at list[ks], and a flag per slot.
__device__ __forceinline__ void slot_list(const Args& a, const Row& s,
                                          int b, int j0, int nj, int t) {
  if (t >= 32) return;
  int cnt = 0;
  for (int c = 0; c < nj; c += 32) {
    const int j = c + t;
    const bool m = j < nj && a.mask[static_cast<size_t>(b) * a.kn + j0 + j];
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (m) s.list[cnt + __popc(bal & ((1u << t) - 1u))] = j;
    if (j < nj) s.ok[j] = m;
    cnt += __popc(bal);
  }
  if (t == 0) s.list[a.ks] = cnt;
}

// Scores of the valid (slot, head) pairs, GROUP lanes a pair: lane l of a
// group sums columns l, l + GROUP, ... by FMA, then a butterfly over the
// group. Forward: sc = q.k / f, f = sqrt(D) (as the reference divides).
// Backward: sc = q.k * f, f = 1 / sqrt(D), and da = g.v.
template <bool BWD>
__device__ __forceinline__ void scores(const Args& a, const Row& s, int t,
                                       float f) {
  const int n = s.list[a.ks], pairs = n * a.heads;
  const int gi = t / GROUP, lg = t % GROUP;
  for (int p0 = 0; p0 < pairs; p0 += TPR / GROUP) {
    const int sg = p0 + gi;
    float p = 0.0f, p2 = 0.0f;
    int h = 0, j = 0;
    if (sg < pairs) {
      h = sg / n;
      j = s.list[sg - h * n];
      const float* qp = s.q + h * a.dh;
      const float* kp = s.k + j * a.hd + h * a.dh;
      for (int c = lg; c < a.dh; c += GROUP) p = fmaf(qp[c], kp[c], p);
      if (BWD) {
        const float* gp = s.g + h * a.dh;
        const float* vp = s.v + j * a.hd + h * a.dh;
        for (int c = lg; c < a.dh; c += GROUP) p2 = fmaf(gp[c], vp[c], p2);
      }
    }
#pragma unroll
    for (int off = GROUP / 2; off > 0; off >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, off);
      if (BWD) p2 += __shfl_xor_sync(0xffffffffu, p2, off);
    }
    if (sg < pairs && lg == 0) {
      s.sc[h * a.ks + j] = BWD ? p * f : p / f;
      if (BWD) s.da[h * a.ks + j] = p2;
    }
  }
}

// Softmax statistics of the slice, one warp a head: the running max m,
// the sum l of exp(sc - m) (rescaled by alpha = exp(m_old - m_new)), in
// the backward also t = sum exp(sc - m) datt; sc becomes exp(sc - m), or
// the weights themselves (divided by l) with `normalize` (one slice).
template <bool BWD>
__device__ __forceinline__ void head_stats(const Args& a, const Row& s,
                                           int t, bool normalize) {
  const int n = s.list[a.ks], lane = t & 31;
  for (int h = t >> 5; h < a.heads; h += WPR) {
    float* sh = s.sc + h * a.ks;
    const float* dah = s.da + h * a.ks;
    const float m_old = s.m[h];
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, sh[s.list[i]]);
    mx = warp_max(mx);
    const float m_new = fmaxf(m_old, mx);
    const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
    float sum = 0.0f, ts = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const int j = s.list[i];
      const float p = expf(sh[j] - m_new);
      sh[j] = p;
      sum += p;
      if (BWD) ts = fmaf(p, dah[j], ts);
    }
    sum = warp_sum(sum);
    if (BWD) ts = warp_sum(ts);
    if (normalize)
      for (int i = lane; i < n; i += 32) sh[s.list[i]] /= sum;
    if (lane == 0) {
      s.l[h] = s.l[h] * alpha + sum;
      if (BWD) s.t[h] = s.t[h] * alpha + ts;
      s.m[h] = m_new;
      s.alpha[h] = alpha;
    }
  }
}

// Forward context of a slice, lanes on (h, c), W columns a thread:
// acc = acc * alpha + sum_j w_j v_j; the last slice writes out (divided by
// l when the weights were not normalized).
template <bool VEC>
__device__ __forceinline__ void context(const Args& a, const Row& s, int t,
                                        int b, bool first, bool last,
                                        bool multi) {
  constexpr int W = VEC ? 4 : 1;
  const int n = s.list[a.ks];
  for (int e = t * W; e < a.hd; e += TPR * W) {
    const int ha = e / a.dh, hb = (e + W - 1) / a.dh, cut = (ha + 1) * a.dh;
    float acc[W];
#pragma unroll
    for (int u = 0; u < W; ++u)
      acc[u] = multi && !first ? s.acc[e + u] * s.alpha[e + u < cut ? ha : hb]
                               : 0.0f;
    const float* wa = s.sc + ha * a.ks;
    const float* wb = s.sc + hb * a.ks;
    for (int i = 0; i < n; ++i) {
      const int j = s.list[i];
      const float xa = wa[j], xb = wb[j];
      float vv[W];
      load<W>(s.v + j * a.hd + e, vv);
#pragma unroll
      for (int u = 0; u < W; ++u)
        acc[u] = fmaf(e + u < cut ? xa : xb, vv[u], acc[u]);
    }
    if (!last) {
#pragma unroll
      for (int u = 0; u < W; ++u) s.acc[e + u] = acc[u];
      continue;
    }
    if (multi) {
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const float l = s.l[e + u < cut ? ha : hb];
        acc[u] = l > 0.0f ? acc[u] / l : 0.0f;
      }
    }
    store<W>(a.out + static_cast<size_t>(b) * a.hd + e, acc);
  }
}

// Backward, one warp a head: the weights att = exp(sc - m) / l (sc already
// exp(sc - m) unless the scores were recomputed, `fresh`) into sc, and
// ds * scale = att (datt - t / l) * scale into da.
__device__ __forceinline__ void head_grads(const Args& a, const Row& s,
                                           int t, bool fresh, float scale) {
  const int n = s.list[a.ks], lane = t & 31;
  for (int h = t >> 5; h < a.heads; h += WPR) {
    float* sh = s.sc + h * a.ks;
    float* dah = s.da + h * a.ks;
    const float m = s.m[h], l = s.l[h];
    const float tot = l > 0.0f ? s.t[h] / l : 0.0f;
    for (int i = lane; i < n; i += 32) {
      const int j = s.list[i];
      const float att = (fresh ? expf(sh[j] - m) : sh[j]) / l;
      sh[j] = att;
      dah[j] = att * (dah[j] - tot) * scale;
    }
  }
}

// Backward gradients of a slice, lanes on (h, c): dq accumulated over the
// slices (written with the last, `store`), dk and dv of the slice's slots
// written once each, literal zeros for masked slots.
template <bool VEC>
__device__ __forceinline__ void grads(const Args& a, const Row& s, int t,
                                      int b, int j0, int nj, bool init,
                                      bool store_dq) {
  constexpr int W = VEC ? 4 : 1;
  const int n = s.list[a.ks];
  for (int e = t * W; e < a.hd; e += TPR * W) {
    const int ha = e / a.dh, hb = (e + W - 1) / a.dh, cut = (ha + 1) * a.dh;
    float acc[W];
#pragma unroll
    for (int u = 0; u < W; ++u) acc[u] = init ? 0.0f : s.acc[e + u];
    const float* wa = s.da + ha * a.ks;
    const float* wb = s.da + hb * a.ks;
    for (int i = 0; i < n; ++i) {
      const int j = s.list[i];
      const float xa = wa[j], xb = wb[j];
      float kk[W];
      load<W>(s.k + j * a.hd + e, kk);
#pragma unroll
      for (int u = 0; u < W; ++u)
        acc[u] = fmaf(e + u < cut ? xa : xb, kk[u], acc[u]);
    }
    if (store_dq) {
      store<W>(a.out + static_cast<size_t>(b) * a.hd + e, acc);
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u) s.acc[e + u] = acc[u];
    }
  }
  const size_t o = (static_cast<size_t>(b) * a.kn + j0) * a.hd;
  for (int x = t * W; x < nj * a.hd; x += TPR * W) {
    const int j = x / a.hd, e = x - j * a.hd;
    float rk[W], rv[W];
    if (s.ok[j]) {
      const int ha = e / a.dh, hb = (e + W - 1) / a.dh;
      const int cut = (ha + 1) * a.dh;
      const float dsa = s.da[ha * a.ks + j], dsb = s.da[hb * a.ks + j];
      const float ata = s.sc[ha * a.ks + j], atb = s.sc[hb * a.ks + j];
      float qq[W], gg[W];
      load<W>(s.q + e, qq);
      load<W>(s.g + e, gg);
#pragma unroll
      for (int u = 0; u < W; ++u) {
        rk[u] = (e + u < cut ? dsa : dsb) * qq[u];
        rv[u] = (e + u < cut ? ata : atb) * gg[u];
      }
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u) rk[u] = rv[u] = 0.0f;
    }
    store<W>(a.dk + o + x, rk);
    store<W>(a.dv + o + x, rv);
  }
}

// Block prologue: the mbarrier, and each row's statistics reset.
__device__ __forceinline__ void prologue(const Args& a, const Row& s, int t,
                                         uint32_t bar) {
  if (threadIdx.x == 0) mbar_init(bar);
  for (int h = t; h < a.heads; h += TPR) {
    s.m[h] = -INFINITY;
    s.l[h] = 0.0f;
    s.t[h] = 0.0f;
  }
  __syncthreads();
}

template <bool VEC>
__global__ void __launch_bounds__(TPR) attn_fwd_kernel(Args a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x, b = blockIdx.x;
  const bool multi = a.nsl > 1;
  const Row s = row_views(smem, L, a);
  const uint32_t bar = smem_addr(smem);
  const float rs = sqrtf(static_cast<float>(a.dh));
  prologue(a, s, t, bar);
  uint32_t phase = 0;
  for (int sl = 0; sl < a.nsl; ++sl) {
    const int j0 = sl * a.ks, nj = min(a.ks, a.kn - j0);
    if (sl > 0) __syncthreads();  // the previous slice is read
    stage<VEC, false>(a, smem, L, b, j0, nj, sl == 0, bar);
    slot_list(a, s, b, j0, nj, t);
    stage_wait<VEC>(bar, phase);
    scores<false>(a, s, t, rs);
    __syncthreads();
    head_stats<false>(a, s, t, !multi);
    __syncthreads();
    context<VEC>(a, s, t, b, sl == 0, sl == a.nsl - 1, multi);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(TPR) attn_bwd_kernel(Args a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x, b = blockIdx.x;
  const Row s = row_views(smem, L, a);
  const uint32_t bar = smem_addr(smem);
  const float scale = 1.0f / sqrtf(static_cast<float>(a.dh));
  prologue(a, s, t, bar);
  uint32_t phase = 0;
  // pass 1: the softmax statistics (and the last slice left staged)
  for (int sl = 0; sl < a.nsl; ++sl) {
    const int j0 = sl * a.ks, nj = min(a.ks, a.kn - j0);
    if (sl > 0) __syncthreads();
    stage<VEC, true>(a, smem, L, b, j0, nj, sl == 0, bar);
    slot_list(a, s, b, j0, nj, t);
    stage_wait<VEC>(bar, phase);
    scores<true>(a, s, t, scale);
    __syncthreads();
    head_stats<true>(a, s, t, false);
    __syncthreads();
  }
  // pass 2, last slice first: weights, ds, then dq, dk, dv
  for (int sl = a.nsl - 1; sl >= 0; --sl) {
    const int j0 = sl * a.ks, nj = min(a.ks, a.kn - j0);
    const bool fresh = sl != a.nsl - 1;
    if (fresh) {
      __syncthreads();
      stage<VEC, true>(a, smem, L, b, j0, nj, false, bar);
      slot_list(a, s, b, j0, nj, t);
      stage_wait<VEC>(bar, phase);
      scores<true>(a, s, t, scale);
      __syncthreads();
    }
    head_grads(a, s, t, fresh, scale);
    __syncthreads();
    grads<VEC>(a, s, t, b, j0, nj, !fresh, sl == 0);
  }
}

int max_smem() {
  static const int bytes = [] {
    int dev = 0, v = 48 * 1024;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
    return v;
  }();
  return bytes;
}

template <bool VEC, bool BWD>
cudaError_t launch(const Args& a, const Layout& L, cudaStream_t stream) {
  auto kernel = BWD ? attn_bwd_kernel<VEC> : attn_fwd_kernel<VEC>;
  // above 48 KB a kernel needs the attribute; set once per instantiation
  // (the port drives one card a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem());
  if (attr != cudaSuccess) return attr;
  kernel<<<a.rows, TPR, L.total, stream>>>(a, L);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Slots per slice: all K if a row fits in shared memory, else the most
// that fit.
template <bool BWD>
int run(Args a, cudaStream_t stream) {
  if (a.rows == 0 || a.hd == 0) return 0;
  const bool vec = a.hd % 4 == 0 && a.dh >= 2 && aligned16(a.q) &&
                   aligned16(a.k) && aligned16(a.v) && aligned16(a.out) &&
                   (!BWD || (aligned16(a.g) && aligned16(a.dk) &&
                             aligned16(a.dv)));
  const long long cap = max_smem();
  int ks = a.kn;
  if (layout(nullptr, a.hd, a.heads, ks, BWD, false) > cap)
    while (ks > 1 && layout(nullptr, a.hd, a.heads, ks, BWD, true) > cap)
      --ks;
  const bool multi = ks < a.kn;
  Layout L{};
  if (layout(&L, a.hd, a.heads, ks, BWD, multi) > cap)
    return static_cast<int>(cudaErrorInvalidValue);  // H * D too large
  a.ks = ks;
  a.nsl = ks > 0 ? (a.kn + ks - 1) / ks : 1;
  return static_cast<int>(vec ? launch<true, BWD>(a, L, stream)
                              : launch<false, BWD>(a, L, stream));
}

}  // namespace

extern "C" int temporal_attn_fwd(const void* q, const void* k, const void* v,
                                 const void* mask, int rows, int heads,
                                 int kn, int dh, void* out, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), nullptr,
         static_cast<const bool*>(mask), static_cast<float*>(out), nullptr,
         nullptr, rows, heads, kn, dh, heads * dh, 0, 0};
  return run<false>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int temporal_attn_bwd(const void* g, const void* q, const void* k,
                                 const void* v, const void* mask, int rows,
                                 int heads, int kn, int dh, void* dq,
                                 void* dk, void* dv, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(g),
         static_cast<const bool*>(mask), static_cast<float*>(dq),
         static_cast<float*>(dk), static_cast<float*>(dv), rows, heads, kn,
         dh, heads * dh, 0, 0};
  return run<true>(a, static_cast<cudaStream_t>(stream));
}
