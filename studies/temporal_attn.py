#!/usr/bin/env python3
"""Design study of the temporal attention kernels on one NVIDIA GPU.

    python3 studies/temporal_attn.py

Builds variants of ``src/repro_torch/kernels/csrc/temporal_attn.cu`` into
``build/study/`` (ignored by git) by substituting its constants: the
kernel as it is (a block of TPR = 128 threads a row, GROUP = 4 lanes a dot
product), TPR 64 / 256 and GROUP 2 / 8, and ``#pragma unroll 4`` on the
dot-product and context / dq loops (the same arithmetic order). Two floors
beside them: an empty launch of one block a row, and a kernel that only
stages the forward's rows (the same bulk copies) and writes q + k + v.
Every variant is checked against the plain version (1e-5) and timed at the
TGN path's shape (``chip_smoke.path_batch``'s batch, its sampled mask) in
turns, by ``chip_smoke.device_ms``. Last, a copy of the kernel stamped with
``clock64`` and ``%globaltimer`` at each phase's end prints where a block's
cycles go. Needs a card, ``nvcc`` and the repository's ``src`` on the path;
it imports no JAX.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/study"
P, I = ctypes.c_void_p, ctypes.c_int

FLOOR = r'''
#include <stdint.h>
#include "common.cuh"
__global__ void empty_kernel() {}
__global__ void stage_kernel(const float* q, const float* k, const float* v,
                             int hd, int kn, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float* qs = reinterpret_cast<float*>(smem + 16);
  float* ks = qs + hd;
  float* vs = ks + kn * hd;
  const size_t b = blockIdx.x;
  if (threadIdx.x == 0) {
    const uint32_t qn = 4u * hd, kvn = 4u * kn * hd;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(qn + 2 * kvn) : "memory");
    const float* src[3] = {q + b * hd, k + b * kn * hd, v + b * kn * hd};
    const uint32_t dst[3] = {bar + 16, bar + 16 + qn, bar + 16 + qn + kvn};
    for (int i = 0; i < 3; ++i)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst[i]), "l"(src[i]),
          "r"(i ? kvn : qn), "r"(bar) : "memory");
  }
  __syncthreads();
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar) : "memory");
  for (int i = threadIdx.x; i < hd; i += blockDim.x)
    out[b * hd + i] = qs[i] + ks[i] + vs[i];
}
extern "C" int launch_empty(int blocks, int threads) {
  empty_kernel<<<blocks, threads>>>();
  return cudaGetLastError();
}
extern "C" int launch_stage(const void* q, const void* k, const void* v,
                            int rows, int hd, int kn, void* out) {
  const int smem = 16 + 4 * hd * (1 + 2 * kn);
  cudaFuncSetAttribute(stage_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stage_kernel<<<rows, 128, smem>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), hd, kn, static_cast<float*>(out));
  return cudaGetLastError();
}
'''

# phase stamps: thread 0 of blocks < 1024 records clock64 at each phase's
# end (after a block barrier) and %globaltimer at the start and the end
STAMPS = r'''
__device__ unsigned long long g_clk[2][1024][8];
__device__ unsigned long long g_gt[2][1024][2];
#define STAMP(k, i) \
  if (threadIdx.x == 0 && blockIdx.x < 1024) g_clk[k][blockIdx.x][i] = clock64();
#define GT(k, i)                                                    \
  if (threadIdx.x == 0 && blockIdx.x < 1024) {                      \
    unsigned long long g_;                                          \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));          \
    g_gt[k][blockIdx.x][i] = g_;                                    \
  }
extern "C" int read_stamps(void* clk, void* gt) {
  cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));
  cudaMemcpyFromSymbol(gt, g_gt, sizeof(g_gt));
  return cudaGetLastError();
}
'''
FWD_PHASES = ("prologue", "copies issued, mask listed", "rows landed",
              "scores", "softmax", "context")
BWD_PHASES = ("prologue", "copies issued, mask listed", "rows landed",
              "scores and datt", "softmax statistics", "weights and ds",
              "dq, dk, dv")


def substituted(src: str, tpr: int, group: int, unroll: bool) -> str:
    out = re.sub(r"constexpr int TPR = \d+;", f"constexpr int TPR = {tpr};",
                 src)
    out = re.sub(r"constexpr int GROUP = \d+;",
                 f"constexpr int GROUP = {group};", out)
    if unroll:
        for loop in ("for (int c = lg; c < a.dh; c += GROUP)",
                     "for (int i = 0; i < n; ++i) {"):
            assert out.count(loop) == 2, loop
            out = out.replace(loop, "\n#pragma unroll 4\n" + loop)
    return out


def stamped(src: str) -> str:
    """The kernel with STAMP after each phase (a barrier added after the
    last one) and GT at each block's start and end."""
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + STAMPS, 1)
    f0 = src.index("attn_fwd_kernel(Args a")
    b0 = src.index("attn_bwd_kernel(Args a")
    e0 = src.index("\nint max_smem()")
    head, fwd, bwd, tail = src[:f0], src[f0:b0], src[b0:e0], src[e0:]

    def mark(text, k, anchors):
        for i, anchor in enumerate(anchors):
            assert text.count(anchor) == 1, anchor
            j = text.index(anchor) + len(anchor)
            stamp = f"\n    STAMP({k}, {i});"
            if i == 0:
                stamp += f" GT({k}, 0);"
            if i == len(anchors) - 1:
                stamp = f"\n    __syncthreads();{stamp} GT({k}, 1);"
            text = text[:j] + stamp + text[j:]
        return text

    fwd = mark(fwd, 0, [
        "const Row s = row_views(smem, L, a);",
        "prologue(a, s, t, bar);",
        "slot_list(a, s, b, j0, nj, t);",
        "stage_wait<VEC>(bar, phase);",
        "scores<false>(a, s, t, rs);\n    __syncthreads();",
        "head_stats<false>(a, s, t, !multi);\n    __syncthreads();",
        "context<VEC>(a, s, t, b, sl == 0, sl == a.nsl - 1, multi);"])
    bwd = mark(bwd, 1, [              # pass 2's restage is indented deeper
        "const Row s = row_views(smem, L, a);",
        "prologue(a, s, t, bar);",
        "sl == 0, bar);\n    slot_list(a, s, b, j0, nj, t);",
        "\n    stage_wait<VEC>(bar, phase);",
        "\n    scores<true>(a, s, t, scale);\n    __syncthreads();",
        "head_stats<true>(a, s, t, false);\n    __syncthreads();",
        "head_grads(a, s, t, fresh, scale);\n    __syncthreads();",
        "grads<VEC>(a, s, t, b, j0, nj, !fresh, sl == 0);"])
    return head + fwd + bwd + tail


def build(sources: dict) -> dict:
    """One nvcc per source, all started together; returns loaded libraries
    and prints the registers and spills of each variant's kernels."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [m.group(1) for m in re.finditer(r"Used (\d+) registers", log)]
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"build {name}: registers {regs}, spill stores {spills}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.kernels import ref
    from repro_torch.tig.data import synthetic_tig

    if not torch.cuda.is_available():
        print("temporal_attn study: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    src = (CSRC / "temporal_attn.cu").read_text()
    variants = {"tree": (128, 4, False), "tpr64": (64, 4, False),
                "tpr256": (256, 4, False), "group2": (128, 2, False),
                "group8": (128, 8, False), "tpr256_group8": (256, 8, False),
                "unroll": (128, 4, True)}
    sources = {n: substituted(src, *v) for n, v in variants.items()}
    sources["stamped"] = stamped(src)
    sources["floor"] = FLOOR
    libs = build(sources)

    dev = torch.device("cuda")
    g = synthetic_tig("wikipedia-s", scale=10.0)
    tcsr, _, s, nodes = chip_smoke.path_batch(torch, dev, g, TIG)
    mask = ref.sample_ref(tcsr["indptr"], tcsr["nbr"], tcsr["t"],
                          tcsr["eidx"], tcsr["bat"], nodes, s,
                          TIG.num_neighbors)[0] >= 0
    rows, kn = mask.shape
    h = TIG.n_heads
    d = TIG.dim // h
    gen = torch.Generator(device=dev).manual_seed(0)
    q, g_out = (torch.randn((rows, h, d), generator=gen, device=dev)
                for _ in range(2))
    k, v = (torch.randn((rows, kn, h, d), generator=gen, device=dev)
            for _ in range(2))
    out, dq, dk, dv = (torch.empty_like(x) for x in (q, q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    print(f"path's shape: B {rows}, K {kn}, H {h}, D {d}; "
          f"{int(mask.sum())} of {mask.numel()} slots valid")

    def fwd(lib):
        return lib.temporal_attn_fwd(q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), mask.data_ptr(), rows, h,
                                     kn, d, out.data_ptr(), stream)

    def bwd(lib):
        return lib.temporal_attn_bwd(g_out.data_ptr(), q.data_ptr(),
                                     k.data_ptr(), v.data_ptr(),
                                     mask.data_ptr(), rows, h, kn, d,
                                     dq.data_ptr(), dk.data_ptr(),
                                     dv.data_ptr(), stream)

    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.temporal_attention_ref(*xs, mask)
    want_g = torch.autograd.grad(want, xs, g_out)
    kernel_libs = {n: libs[n] for n in [*variants, "stamped"]}
    for name, lib in kernel_libs.items():
        lib.temporal_attn_fwd.argtypes = [P, P, P, P, I, I, I, I, P, P]
        lib.temporal_attn_bwd.argtypes = [P, P, P, P, P, I, I, I, I, P, P,
                                          P, P]
        if fwd(lib) or bwd(lib):
            raise RuntimeError(f"{name}: a launch failed")
        torch.cuda.synchronize()
        err = chip_smoke.max_err([out, dq, dk, dv], [want.detach(), *want_g])
        print(f"check {name}: max abs err {err:.3g}")
        if err > chip_smoke.TOL:
            raise AssertionError(f"{name} differs from the plain version")

    times = {n: ([], []) for n in variants}
    order = list(variants)
    for rnd in range(2):                     # in turns, forth and back
        for name in order if rnd == 0 else order[::-1]:
            lib = libs[name]
            times[name][0].append(chip_smoke.device_ms(lambda: fwd(lib)))
            times[name][1].append(chip_smoke.device_ms(lambda: bwd(lib)))
    for name, (f, b) in times.items():
        print(f"time {name} (TPR {variants[name][0]}, GROUP "
              f"{variants[name][1]}{', unrolled' if variants[name][2] else ''}"
              f"): forward {[round(x * 1e3, 3) for x in f]} us, backward "
              f"{[round(x * 1e3, 3) for x in b]} us")
    floor = libs["floor"]
    floor.launch_empty.argtypes = [I, I]
    floor.launch_stage.argtypes = [P, P, P, I, I, I, P]
    empty = chip_smoke.device_ms(lambda: floor.launch_empty(rows, 128))
    staged = chip_smoke.device_ms(lambda: floor.launch_stage(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rows, h * d, kn,
        out.data_ptr()))
    print(f"floor: empty launch of {rows} blocks {empty * 1e3:.3f} us; the "
          f"forward's staging alone {staged * 1e3:.3f} us")

    lib = libs["stamped"]
    lib.read_stamps.argtypes = [P, P]
    for _ in range(10):
        fwd(lib)
        bwd(lib)
    torch.cuda.synchronize()
    clk = np.zeros((2, 1024, 8), np.uint64)
    gt = np.zeros((2, 1024, 2), np.uint64)
    lib.read_stamps(clk.ctypes.data, gt.ctypes.data)
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
    n = min(rows, 1024)
    valid = mask.sum(-1).cpu().numpy()[:n]
    for kk, label, phases in ((0, "forward", FWD_PHASES),
                              (1, "backward", BWD_PHASES)):
        c = clk[kk, :n, :len(phases) + 1].astype(np.int64)
        d_c = np.diff(c, axis=1)
        tot = c[:, -1] - c[:, 0]
        print(f"{label}: cycles a block (SM clock {sm}), median / max over "
              f"{n} blocks")
        for i, name in enumerate(phases):
            print(f"  {name:28s} {np.median(d_c[:, i]):7.0f} "
                  f"{d_c[:, i].max():7.0f}")
        print(f"  {'total':28s} {np.median(tot):7.0f} {tot.max():7.0f} "
              f"(rows with all {kn} slots valid {np.median(tot[valid == kn]):.0f}"
              f", rows with none {np.median(tot[valid == 0]):.0f})")
        t0 = gt[kk, :n, 0].astype(np.int64)
        t1 = gt[kk, :n, 1].astype(np.int64)
        print(f"  globaltimer: blocks start within {t0.max() - t0.min()} ns,"
              f" the last ends {t1.max() - t0.min()} ns after the first "
              f"starts; median block {np.median(t1 - t0):.0f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
