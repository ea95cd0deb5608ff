#!/usr/bin/env python3
"""Design study of the neighbor sampling kernel on one NVIDIA GPU.

    python3 studies/neighbor_sample.py

Builds variants of ``src/repro_torch/kernels/csrc/neighbor_sample.cu``
into ``build/study/`` (ignored by git) by substituting its constants and
lines: the threads of a row TPR (a warp: 32; a block: 64, 128, 256) and,
for a warp a row, the rows of a block RPB (1, 4, 8); "guess", which opens
the search of a long segment with a guess from its end keys (one round
trip for bat[lo] and bat[hi - 1], then TPR probes TPR apart around the
interpolated position); "split64", the split points from one 64-bit
product each (the kernel's are 32-bit); and "late_window", which loads
the window after the search (the kernel loads its candidates beside a
warp's last round of probes and picks them by shuffles). The roles
form is timed at the same batch beside the nodes form, and as first
written ("roles_before": a division for the role, and the `valid` load
issued only after the id's). Every variant is held bitwise to ``ref.sample_ref`` at
the TGN path's batch (``chip_smoke.path_batch``) and on segments at each
width's round boundaries, then timed there in turns, forth and back, by
``chip_smoke.device_ms``.

Then the latency floor: an empty launch of each variant's grid, and a
pointer chase (one thread, each load's address the value of the last)
over a random cycle the size of the path's ``bat`` (in L2), of 16 KB (in
L1) and of 256 MB (past L2: device memory), in ns a load. The floor of a
design is its empty launch plus its longest dependent chain at the path's
batch (nodes, indptr, the search's rounds, the window) times the L2 load
latency. Last, a copy of the kernel stamped with ``clock64`` as each
phase's loads land (and ``%globaltimer`` at each row's start and end)
prints where a row's cycles go. Needs a card, ``nvcc`` and the
repository's ``src`` on the path; it imports no JAX.
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
__global__ void empty_kernel() {}
// each launch walks on from where the last one stopped (*out), so a
// cycle larger than L2 is never walked warm
__global__ void chase_kernel(const int* next, int steps, int* out) {
  int j = *out;
  for (int i = 0; i < steps; ++i) j = next[j];
  *out = j;
}
extern "C" int launch_empty(int blocks, int threads) {
  empty_kernel<<<blocks, threads>>>();
  return cudaGetLastError();
}
extern "C" int launch_chase(const void* next, int steps, void* out) {
  chase_kernel<<<1, 1>>>(static_cast<const int*>(next), steps,
                         static_cast<int*>(out));
  return cudaGetLastError();
}
'''

# the guess: one round trip for the segment's end keys, then TPR probes TPR
# apart around the interpolated position; the plain rounds finish
GUESS = r'''
  if (hi - lo > TPR) {
    const int b0 = a.bat[lo], b1 = a.bat[hi - 1];
    if (key <= b0) {
      hi = lo;
    } else if (key > b1) {
      lo = hi;
    } else {
      const int n = hi - lo;
      const int g = lo + static_cast<int>(
          static_cast<long long>(key - b0) * (n - 1) / (b1 - b0));
      auto at = [&](int i) {
        return min(max(g + (i - TPR / 2) * TPR, lo), hi - 1);
      };
      const int c = count_true(a.bat[at(lane)] < key);
      const int next_lo = c > 0 ? at(c - 1) + 1 : lo;
      hi = c < TPR ? at(c) : hi;
      lo = next_lo;
    }
  }
'''
ANCHOR = "  int lo = start, hi = a.indptr[node + 1];\n"

# the window loaded after the search, not beside a warp's last round
LATE = ("if (TPR == 32 && n <= TPR && a.k <= TPR) {",
        "if (false && n <= TPR) {")

# the roles form's row lookup as first written: a division for the role,
# and `valid` read only once `id` had landed (&& short-circuits a load)
ROLES_BEFORE = (
    """    const int role = (r >= a.b) + (r >= 2 * a.b), slot = r - role * a.b;
    const int id = (role == 0 ? a.src : role == 1 ? a.dst : a.neg)[slot];
    const bool valid = a.valid[slot];  // loaded beside id, not after it
    alive = id >= 0 && valid;
""",
    """    const int role = r / a.b, slot = r - role * a.b;
    const int id = (role == 0 ? a.src : role == 1 ? a.dst : a.neg)[slot];
    alive = id >= 0 && a.valid[slot];
""")

# the split before it was cut to 32 bits: one 64-bit product a split point
SPLIT64 = ("lo + (i + 1) * q + (i + 1) * rem / (TPR + 1)",
           "lo + static_cast<int>(static_cast<long long>(i + 1) * "
           "(q * (TPR + 1) + rem) / (TPR + 1))")

# phase stamps: lane 0 of rows < 1024 records clock64 when a phase's loads
# have landed (a branch on the loaded value orders the read after them)
# and %globaltimer at the row's start and end
STAMPS = r'''
__device__ unsigned long long g_clk[1024][8];
__device__ unsigned long long g_gt[1024][2];
#define STAMP(i)                                 \
  if (lane == 0 && r < 1024) g_clk[r][i] = clock64();
#define GT(i)                                                       \
  if (lane == 0 && r < 1024) {                                      \
    unsigned long long g_;                                          \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));          \
    g_gt[r][i] = g_;                                                \
  }
extern "C" int read_stamps(void* clk, void* gt) {
  cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));
  cudaMemcpyFromSymbol(gt, g_gt, sizeof(g_gt));
  return cudaGetLastError();
}
'''
PHASES = ("node and key", "indptr", "round 1", "round 2", "round 3",
          "round 4+", "last round, window")


def stamped(src: str) -> str:
    """The kernel with a stamp after each phase: the rounds before the last
    (past the fourth on one stamp), then the last round with the window
    (or the window after the search)."""
    marks = (
        ('#include "common.cuh"\n', '#include "common.cuh"\n' + STAMPS),
        ("  if (r >= a.rows) return;  // the whole row's threads at once\n",
         "  if (r >= a.rows) return;\n  STAMP(0); GT(0);\n"),
        ("  const int start = a.indptr[node];\n",
         "  if (node != -7 && key != -7) STAMP(1);\n"
         "  const int start = a.indptr[node];\n"),
        (ANCHOR, ANCHOR + "  if (hi != -7) STAMP(2);\n  int round_ = 0;\n"),
        ("    lo = next_lo;\n",
         "    lo = next_lo;\n    if (lo != -7) STAMP(3 + min(round_++, 3));\n"),
        ("      return;\n", "      STAMP(7); GT(1);\n      return;\n"),
        ("alive));\n}\n", "alive));\n  STAMP(7); GT(1);\n}\n"),
    )
    for anchor, text in marks:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, text)
    return src

VARIANTS = {          # name: (TPR, RPB, guess)
    "warp_r8": (32, 8, False),
    "warp_r1": (32, 1, False),
    "warp_r4": (32, 4, False),
    "tpr64": (64, 1, False),
    "tpr128": (128, 1, False),
    "tpr256": (256, 1, False),
    "warp_r8_guess": (32, 8, True),
}


def substituted(src: str, tpr: int, rpb: int, guess: bool) -> str:
    out = re.sub(r"constexpr int TPR = \d+;", f"constexpr int TPR = {tpr};",
                 src)
    out = re.sub(r"constexpr int RPB = \d+;", f"constexpr int RPB = {rpb};",
                 out)
    if guess:
        assert out.count(ANCHOR) == 1
        out = out.replace(ANCHOR, ANCHOR + GUESS)
    return out


def search(bat, lo: int, hi: int, key: int, tpr: int, guess: bool):
    """The variant's search over bat[lo:hi] on the host, as the kernel
    runs it: returns (end, round trips)."""
    import numpy as np

    def narrow(lo, hi, pos):
        c = int((bat[pos] < key).sum())
        return (pos[c - 1] + 1 if c else lo), (pos[c] if c < tpr else hi)

    lanes = np.arange(tpr)
    trips = 0
    if guess and hi - lo > tpr:
        trips += 2
        b0, b1 = int(bat[lo]), int(bat[hi - 1])
        if key <= b0:
            hi = lo
        elif key > b1:
            lo = hi
        else:
            g = lo + (key - b0) * (hi - lo - 1) // (b1 - b0)
            lo, hi = narrow(lo, hi, np.clip(g + (lanes - tpr // 2) * tpr,
                                            lo, hi - 1))
    while lo < hi:
        lo, hi = narrow(lo, hi, lo + (lanes + 1) * (hi - lo) // (tpr + 1))
        trips += 1
    return lo, trips


def build(sources: dict) -> dict:
    """One nvcc per source, all started together; returns loaded libraries
    and prints each variant's registers and spills."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"ns_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o",
             str(OUT / f"ns_{name}.so"), str(OUT / f"ns_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [m.group(1) for m in re.finditer(r"Used (\d+) registers", log)]
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"build {name}: registers {regs}, spill stores {spills}")
        libs[name] = ctypes.CDLL(str(OUT / f"ns_{name}.so"))
    return libs


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import KERNELS
    from repro_torch.tig.data import synthetic_tig

    if not torch.cuda.is_available():
        print("neighbor_sample study: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    src = (CSRC / "neighbor_sample.cu").read_text()
    assert src.count(SPLIT64[0]) == 1 and src.count(LATE[0]) == 1
    variants = dict(VARIANTS, split64=VARIANTS["warp_r8"],
                    late_window=VARIANTS["warp_r8"])
    sources = {n: substituted(src, *v) for n, v in VARIANTS.items()}
    sources["split64"] = sources["warp_r8"].replace(*SPLIT64)
    sources["late_window"] = sources["warp_r8"].replace(*LATE)
    assert src.count(ROLES_BEFORE[0]) == 1
    sources["roles_before"] = sources["warp_r8"].replace(*ROLES_BEFORE)
    sources["stamped"] = stamped(src)
    sources["floor"] = FLOOR
    libs = build(sources)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = synthetic_tig("wikipedia-s", scale=10.0)
    tcsr, _, s, nodes = chip_smoke.path_batch(torch, dev, g, TIG)
    k, rows = TIG.num_neighbors, nodes.shape[0]
    ts = ("indptr", "nbr", "t", "eidx", "bat")
    seg = np.diff(tcsr["indptr"].cpu().numpy())[nodes.cpu().numpy()]
    print(f"path's batch: {rows} rows, K {k}, {len(np.unique(nodes.cpu()))}"
          f" distinct nodes; segment median {np.median(seg):.0f}, max "
          f"{seg.max()}; bisect probes (ceil log2(seg + 1)) mean "
          f"{np.ceil(np.log2(seg + 1.0)).mean():.2f}, max "
          f"{int(np.ceil(np.log2(seg.max() + 1.0)))}")

    # each width's round boundaries, (TPR + 1)^r +- 1, and the path's hub
    hub_len = sorted({0, 1, int(seg.max())} | {
        (v[0] + 1) ** r + d for v in VARIANTS.values() for r in (1, 2, 3, 4)
        if (v[0] + 1) ** r <= 1 << 21 for d in (-1, 0, 1)})
    htc = chip_smoke.hub_tcsr(torch, dev, hub_len, pad=4 * k)
    top = 3 + max(hub_len) // 60
    rng = np.random.default_rng(0)
    h_nodes = torch.from_numpy(np.repeat(np.arange(len(hub_len)), 64)
                               .astype(np.int32)).to(dev)
    h_batch = torch.from_numpy(np.concatenate(
        [np.r_[0, top, rng.integers(0, top, 62)] for _ in hub_len])
        .astype(np.int32)).to(dev)

    def launch(lib, tc, nd, batch_of, out):
        per_row = isinstance(batch_of, torch.Tensor)
        return lib.neighbor_sample(
            *(tc[x].data_ptr() for x in ts), nd.data_ptr(), None, None,
            None, None, 0, batch_of.data_ptr() if per_row else None,
            int(per_row), 0 if per_row else batch_of, None, 0, 0,
            nd.shape[0], k, *(o.data_ptr() for o in out), stream)

    def outputs(n):
        return (torch.empty((n, k), dtype=torch.int32, device=dev),
                torch.empty((n, k), dtype=torch.float32, device=dev),
                torch.empty((n, k), dtype=torch.int32, device=dev))

    out, h_out = outputs(rows), outputs(h_nodes.shape[0])
    want = ref.sample_ref(*(tcsr[x] for x in ts), nodes, s, k)
    h_want = ref.sample_ref(*(htc[x] for x in ts), h_nodes, h_batch, k)
    for name in [*variants, "stamped"]:
        lib = libs[name]
        lib.neighbor_sample.argtypes = list(KERNELS["neighbor_sample"]
                                            .argtypes)
        if (launch(lib, tcsr, nodes, s, out)
                or launch(lib, htc, h_nodes, h_batch, h_out)):
            raise RuntimeError(f"{name}: a launch failed")
        torch.cuda.synchronize()
        for got, ref_out, label in ((out, want, "path"),
                                    (h_out, h_want, "round boundaries")):
            if not all(torch.equal(x, y) for x, y in zip(got, ref_out)):
                raise AssertionError(f"{name} differs from sample_ref at "
                                     f"the {label}")
        print(f"check {name}: bitwise equal to sample_ref at the path and "
              f"on segments of {hub_len} events, 64 batch indices each")

    times = {n: [] for n in variants}
    order = list(variants)
    for rnd in range(2):                     # in turns, forth and back
        for name in order if rnd == 0 else order[::-1]:
            lib = libs[name]
            times[name].append(chip_smoke.device_ms(
                lambda: launch(lib, tcsr, nodes, s, out)))

    # the roles form at the path's batch (the same 600 rows), beside the
    # nodes form, with its row lookup as it is and as first written
    prog = chip_smoke.path_batch(torch, dev, g, TIG)[1]
    raw = [torch.from_numpy(prog[x][s]).to(dev)
           for x in ("src", "dst", "neg", "valid")]

    def launch_roles(lib):
        return lib.neighbor_sample(
            *(tcsr[x].data_ptr() for x in ts), None,
            *(x.data_ptr() for x in raw), raw[0].shape[0], None, 0, s,
            None, 0, 0, rows, k, *(o.data_ptr() for o in out), stream)

    libs["roles_before"].neighbor_sample.argtypes = list(
        KERNELS["neighbor_sample"].argtypes)
    roles_want = ref.sample_roles_ref(*(tcsr[x] for x in ts), *raw, s, k)
    roles_t = {n: [] for n in ("warp_r8", "roles_before")}
    nodes_t = []
    for rnd in range(2):
        for name in (roles_t if rnd == 0 else list(roles_t)[::-1]):
            if launch_roles(libs[name]):
                raise RuntimeError(f"{name}: the roles launch failed")
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, roles_want)):
                raise AssertionError(f"{name}: the roles form differs")
            roles_t[name].append(chip_smoke.device_ms(
                lambda: launch_roles(libs[name])))
            nodes_t.append(chip_smoke.device_ms(
                lambda: launch(libs["warp_r8"], tcsr, nodes, s, out)))

    def us(xs):
        return [round(x * 1e3, 3) for x in xs]

    print(f"roles form at the path's batch: {us(roles_t['warp_r8'])} us; "
          f"as first written {us(roles_t['roles_before'])} us; the nodes "
          f"form beside them {us(nodes_t)} us")

    floor = libs["floor"]
    floor.launch_empty.argtypes = [I, I]
    floor.launch_chase.argtypes = [P, I, P]
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    gen = np.random.default_rng(0)
    latency = {}
    for label, n, steps in (("L1, 16 KB", 4096, 20000),
                            ("bat's size", tcsr["bat"].shape[0], 20000),
                            ("device memory, 256 MB", 1 << 26, 5000)):
        perm = gen.permutation(n)
        nxt = np.empty(n, np.int32)
        nxt[perm] = np.roll(perm, -1)          # one cycle through all
        chase = torch.from_numpy(nxt).to(dev)
        ms = chip_smoke.call_ms(lambda: floor.launch_chase(
            chase.data_ptr(), steps, sink.data_ptr()), iters=5, warmup=2)
        latency[label] = ms * 1e6 / steps
        print(f"pointer chase over {label} ({n * 4 / 2**20:.2f} MiB): "
              f"{latency[label]:.1f} ns a dependent load")
    l2 = latency["bat's size"]
    bat = tcsr["bat"].cpu().numpy()
    indptr = tcsr["indptr"].cpu().numpy()
    for name, (tpr, rpb, guess) in variants.items():
        blocks = (rows + rpb - 1) // rpb
        empty = chip_smoke.device_ms(
            lambda: floor.launch_empty(blocks, tpr * rpb))
        trips = []
        for nd in nodes.cpu().numpy():
            lo, hi = int(indptr[nd]), int(indptr[nd + 1])
            end, n = search(bat, lo, hi, s + 1, tpr, guess)
            assert end == lo + np.searchsorted(bat[lo:hi], s + 1, "left")
            trips.append(n)
        # nodes, indptr, the search, the window (but for late_window and
        # the blocks, the window's loads go with a warp's last round)
        chain = 2 + max(trips) + (name == "late_window" or tpr > 32)
        print(f"time {name} (TPR {tpr}, RPB {rpb}"
              f"{', guess' if guess else ''}): "
              f"{[round(x * 1e3, 3) for x in times[name]]} us; empty launch "
              f"of {blocks} x {tpr * rpb} {empty * 1e3:.3f} us; search "
              f"round trips mean {np.mean(trips):.2f}, max {max(trips)}; "
              f"chain {chain} dependent loads; floor "
              f"{empty * 1e3 + chain * l2 / 1e3:.3f} us")
    old_chain = 3 + int(np.ceil(np.log2(seg.max() + 1.0)))
    print(f"one thread a row, a bisect (PR 11's design): chain {old_chain} "
          f"dependent loads on the longest row; times from chip_smoke.py")

    lib = libs["stamped"]
    lib.read_stamps.argtypes = [P, P]
    for _ in range(10):
        launch(lib, tcsr, nodes, s, out)
    torch.cuda.synchronize()
    clk = np.zeros((1024, 8), np.uint64)
    gt = np.zeros((1024, 2), np.uint64)
    lib.read_stamps(clk.ctypes.data, gt.ctypes.data)
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
    c = clk[:rows].astype(np.int64)
    hub = seg == seg.max()
    print(f"cycles a row (SM clock {sm}) from its start, median over "
          f"{rows} rows / over the {int(hub.sum())} rows of the hub")
    for i, name in enumerate(PHASES, start=1):
        have = c[:, i] > 0
        if not (have & hub).any():
            continue
        print(f"  {name:16s} {np.median(c[have, i] - c[have, 0]):8.0f} "
              f"{np.median(c[have & hub, i] - c[have & hub, 0]):8.0f}")
    t0, t1 = gt[:rows, 0].astype(np.int64), gt[:rows, 1].astype(np.int64)
    print(f"  globaltimer: rows start within {t0.max() - t0.min()} ns, the "
          f"last ends {t1.max() - t0.min()} ns after the first starts; "
          f"median row {np.median(t1 - t0):.0f} ns, hub rows "
          f"{np.median((t1 - t0)[hub]):.0f} ns")
    return 0


if __name__ == "__main__":
    sys.exit(main())
