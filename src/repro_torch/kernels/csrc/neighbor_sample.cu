// Temporal neighbor sampling over a device-resident T-CSR, for Hopper.
//
// Replaces the TPU kernel `_sample_kernel` of
// src/repro/kernels/neighbor_sample.py (entry `neighbor_sample_fwd`).
//
// For each query row: `end` = bisect_left of the key batch_of + 1 in the
// node's time-sorted segment [indptr[n], indptr[n+1]) of `bat`, then the
// K-wide window [end-(w+1)K, end-wK) of nbr / t / eidx; slots before the
// segment start are -1 / -1.0. Two forms, one kernel:
//   - nodes: the rows are `nodes`;
//   - roles: the rows are src ++ dst ++ neg of a batch of B edges. A row
//     is alive if its id is >= 0 and `valid` is set for its slot; a dead
//     row samples node 0, and its ids and edge rows come out -1 while its
//     times are left as sampled (the host planner's grid, and the JAX
//     package's `sample_batch_neighbors`), so a TGN step samples in one
//     launch.
// `batch_of` and `window` are each a scalar, a pointer read by every row
// (step 0: a device scalar, never copied to the host) or one per row.
//
// Bound on an H100: dependent latency, not bandwidth. The path's call (600
// rows, K 10) moves under 100 KB; its time is the longest chain of loads
// that wait on each other: nodes -> indptr -> the search -> the window. A
// bisect makes that chain ~log2(segment) probes long (16 on the path's
// hubs of 45,855 events). This design shortens it:
//   - TPR threads own a row (a warp, or a block of TPR threads);
//   - the search is TPR-ary: in each round every thread probes one of TPR
//     split points that cut [lo, hi) into TPR + 1 near-equal parts. The
//     probes ascend over a sorted segment, so the count of probes below
//     the key (a ballot, or a block's barrier count) names the part that
//     holds `end`. A round is one round trip, since its loads are
//     independent; a segment of n events takes at most
//     ceil(log_{TPR+1}(n + 1)) rounds: 4 for 45,855 at TPR 32. A part of at most TPR events is
//     probed whole, so the last round ends the search exactly;
//   - the window is copied across the row's threads (thread j: slot j),
//     so each output row is one coalesced store per array. In a warp's
//     last round (K <= 32) the window's candidates load beside the probes
//     and a shuffle picks them once the ballot lands, so the window adds
//     no round trip of its own.
// At the path's 600 rows this takes 2.48 us, against 6.43 us for one
// thread a row with a bisect and a latency floor of 1.67 us (an empty
// launch plus 6 dependent L2 loads), on an NVIDIA H100 80GB HBM3 at
// 700 W; studies/neighbor_sample.py times the other widths.
#include "common.cuh"

namespace {

constexpr int TPR = 32;   // threads of a row: a warp, or a whole block
constexpr int RPB = 8;    // rows of a block (each a warp when TPR is 32)
static_assert((TPR == 32 && RPB >= 1) || (TPR % 32 == 0 && RPB == 1),
              "a row is a warp or a whole block");

struct Args {
  const int* indptr;
  const int* nbr;
  const float* t;
  const int* eidx;
  const int* bat;
  const int* nodes;       // nodes form: (rows,); null in the roles form
  const int* src;         // roles form: (b,) each; row r is role r / b,
  const int* dst;         // slot r % b
  const int* neg;
  const bool* valid;
  int b;
  const int* batch_of;    // null: batch_of_scalar for every row
  int batch_of_step;      // 1: one a row; 0: one for all rows
  int batch_of_scalar;
  const int* window;
  int window_step;
  int window_scalar;
  int rows;
  int k;
  int* ids_out;
  float* t_out;
  int* e_out;
};

// How many of the row's TPR predicates hold.
__device__ __forceinline__ int count_true(bool p) {
  if constexpr (TPR == 32) return __popc(__ballot_sync(0xffffffffu, p));
  else return __syncthreads_count(p);
}

// One window slot: the neighbor id, time and edge row of event `idx`, or
// -1 / -1.0 for a slot before the segment (!ok); a dead row's id and edge
// row are -1 too.
struct Slot {
  int id;
  float t;
  int e;
};

__device__ __forceinline__ Slot slot_at(const Args& a, int idx, bool ok,
                                        bool alive) {
  return {ok && alive ? a.nbr[idx] : -1, ok ? a.t[idx] : -1.0f,
          ok && alive ? a.eidx[idx] : -1};
}

__device__ __forceinline__ void store(const Args& a, size_t o,
                                      const Slot& s) {
  a.ids_out[o] = s.id;
  a.t_out[o] = s.t;
  a.e_out[o] = s.e;
}

__device__ __forceinline__ Slot shfl(const Slot& s, int from) {
  return {__shfl_sync(0xffffffffu, s.id, from),
          __shfl_sync(0xffffffffu, s.t, from),
          __shfl_sync(0xffffffffu, s.e, from)};
}

// Split point i (0 <= i < TPR) of [lo, lo + n), n = q (TPR + 1) + rem:
// lo + floor((i + 1) n / (TPR + 1)), in 32 bits. Ascending in i, within
// [lo, lo + n - 1] for n >= 1, and every element of a part n <= TPR.
__device__ __forceinline__ int split(int lo, int q, int rem, int i) {
  return lo + (i + 1) * q + (i + 1) * rem / (TPR + 1);
}

__global__ void __launch_bounds__(TPR * RPB)
    neighbor_sample_kernel(Args a) {
  const int lane = TPR == 32 ? threadIdx.x & 31 : threadIdx.x;
  const int r = blockIdx.x * RPB + (TPR == 32 ? threadIdx.x >> 5 : 0);
  if (r >= a.rows) return;  // the whole row's threads at once
  int node;
  bool alive = true;
  if (a.nodes) {
    node = a.nodes[r];
  } else {
    const int role = (r >= a.b) + (r >= 2 * a.b), slot = r - role * a.b;
    const int id = (role == 0 ? a.src : role == 1 ? a.dst : a.neg)[slot];
    const bool valid = a.valid[slot];  // loaded beside id, not after it
    alive = id >= 0 && valid;
    node = alive ? id : 0;
  }
  const int key =
      (a.batch_of ? a.batch_of[r * a.batch_of_step] : a.batch_of_scalar) + 1;
  const int win = a.window ? a.window[r * a.window_step] : a.window_scalar;
  const int start = a.indptr[node];
  int lo = start, hi = a.indptr[node + 1];
  const size_t o = static_cast<size_t>(r) * a.k;
  // invariant: bat < key before lo, bat >= key from hi on; lo and hi are
  // the same in all of the row's threads, so every round is taken by all
  while (lo < hi) {
    const unsigned n = hi - lo;
    const int q = n / (TPR + 1), rem = n % (TPR + 1);
    const int probe = a.bat[split(lo, q, rem, lane)];
    if (TPR == 32 && n <= TPR && a.k <= TPR) {
      // The last round: it probes every event of the part, so it ends the
      // search. The window's candidates, the n + K <= 64 events from
      // lo - (w+1)K, load beside the probes, two a lane; slot j is
      // candidate (end - lo) + j, fetched by a shuffle.
      const int from = lo - (win + 1) * a.k, lim = hi - win * a.k;
      const int p0 = from + lane, p1 = p0 + 32;
      const Slot s0 = slot_at(a, p0, p0 >= start && p0 < lim, alive);
      const Slot s1 = slot_at(a, p1, p1 >= start && p1 < lim, alive);
      const int c = count_true(probe < key);
      const int e = (c > 0 ? split(0, q, rem, c - 1) + 1 : 0) + lane;
      const Slot w0 = shfl(s0, e & 31), w1 = shfl(s1, e & 31);
      if (lane < a.k) store(a, o + lane, e < 32 ? w0 : w1);
      return;
    }
    const int c = count_true(probe < key);
    const int next_lo = c > 0 ? split(lo, q, rem, c - 1) + 1 : lo;
    hi = c < TPR ? split(lo, q, rem, c) : hi;
    lo = next_lo;
  }
  // an empty segment, a search that ended on a split point, a block row or
  // K > 32: the window after the search
  const int base = lo - (win + 1) * a.k;
  for (int j = lane; j < a.k; j += TPR)
    store(a, o + j, slot_at(a, base + j, base + j >= start, alive));
}

}  // namespace

// `nodes` non-null: the nodes form over `rows` rows; null: the roles form
// over rows = 3 b rows of src / dst / neg / valid.
extern "C" int neighbor_sample(
    const void* indptr, const void* nbr, const void* t, const void* eidx,
    const void* bat, const void* nodes, const void* src, const void* dst,
    const void* neg, const void* valid, int b, const void* batch_of,
    int batch_of_step, int batch_of_scalar, const void* window,
    int window_step, int window_scalar, int rows, int k, void* ids_out,
    void* t_out, void* e_out, void* stream) {
  if (rows == 0) return 0;
  const Args a{static_cast<const int*>(indptr),
               static_cast<const int*>(nbr),
               static_cast<const float*>(t),
               static_cast<const int*>(eidx),
               static_cast<const int*>(bat),
               static_cast<const int*>(nodes),
               static_cast<const int*>(src),
               static_cast<const int*>(dst),
               static_cast<const int*>(neg),
               static_cast<const bool*>(valid),
               b,
               static_cast<const int*>(batch_of),
               batch_of_step,
               batch_of_scalar,
               static_cast<const int*>(window),
               window_step,
               window_scalar,
               rows,
               k,
               static_cast<int*>(ids_out),
               static_cast<float*>(t_out),
               static_cast<int*>(e_out)};
  neighbor_sample_kernel<<<(rows + RPB - 1) / RPB, TPR * RPB, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
