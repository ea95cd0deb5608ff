#!/usr/bin/env python3
"""The selective scan's two forms in turns, on one NVIDIA GPU.

    python3 studies/selective_scan.py

Builds the port's kernels (``build.build_all``) and prints what ``ptxas``
says of the scan's kernels (registers, spills), an opcode count of each
one's SASS (``cuobjdump -sass``) and, for the chunked kernel, the length
of its state loop (the instructions a thread issues a state and run of
16 tokens), and the blocks resident an SM. Then,
at ``chip_smoke.SCAN_SHAPES`` (phase 17's shapes, inputs as phase 17 makes
them), it calls the per-state form and the chunked form on the same
inputs, holds each against ``ref.selective_scan_ref`` at phase 17's
limits, and times them in turns, state, chunked, chunked, state
(``chip_smoke.call_ms``: CUDA events over back-to-back launches through
the kernel entry into outputs allocated once, so that no wrapper's host
work enters the time), with the device time of each from
``torch.profiler`` (``chip_smoke.device_ms``) and phase 17's bound. Needs
a card, ``nvcc`` and the repository's ``src`` on the path; it imports no
JAX.

    python3 studies/selective_scan.py --variants [--sass-out FILE]
    python3 studies/selective_scan.py --parent <checkout of the parent>

also builds variants of the chunked form (``VARIANTS``: the source with
a few lines replaced, into ``build/study/``, ignored by git: the accurate
``expf`` in place of ``ex2.approx``, the exponentials software-pipelined
across states, 8 threads x 8 tokens, and two diagnostics, wrong by
design, without the exponentials or the b / c shared loads) and times
each in turns against the chunked form at phase 17's shapes (or
``--shapes``), holding each to phase 17's limits and controls; ``--sass-out`` writes the scan library's SASS to a file;
``--parent`` does the same for another checkout's chunked form (its
``src/repro_torch/kernels/csrc``), parent, this, this, parent.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def sass_functions(lib: Path) -> dict:
    """{kernel symbol: [(address, opcode), ...]} of a built library's
    SASS, or {} where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            name = s.split(":", 1)[1].strip()
            out[name] = []
        elif name and s.startswith("/*") and "*/" in s:
            addr, rest = s[2:].split("*/", 1)
            words = rest.replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0] not in ("}", "{"):     # not an encoding
                out[name].append((int(addr, 16), words[0],
                                  words[1] if len(words) > 1 else ""))
    return out


def innermost_shuffle_loop(code) -> list:
    """The opcodes of the shortest loop (a branch back to a lower address)
    that holds a SHFL: the chunked kernel's state loop."""
    best = None
    for addr, op, arg in code:
        if op.startswith("BRA") and arg.startswith("0x"):
            target = int(arg, 16)
            body = [o for a, o, _ in code if target <= a <= addr]
            if target < addr and any(o.startswith("SHFL") for o in body) \
                    and (best is None or len(body) < len(best)):
                best = body
    return best or []


# the state loop software-pipelined: each state forms the next one's
# exponentials between its own FMAs (states in pairs, two decay arrays)
PIPELINED_LOOP = """    // One state: da holds its decays; the next state's (when `more`) are
    // formed into dn between this one's FMAs, so that each warp's stream
    // mixes the SFU's work with the FMA pipe's.
    const auto step = [&](int k, const float (&da)[ITEMS],
                          float (&dn)[ITEMS], bool more) {
      const float ak = sa[lc * N + k];               // a_k log2(e)
      float ub[ITEMS], bc[ITEMS];
      load_items(bt + k * CHUNK + j * ITEMS, bc);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) ub[i] = __fmul_rn(u[i], bc[i]);
      // the run's pair from a zero state: the decay product is one
      // exponential of a_k times the run's summed dt
      float pa = ex2(__fmul_rn(sdt, ak)), ph = ub[0];
#pragma unroll
      for (int i = 1; i < ITEMS; ++i) ph = fmaf(da[i], ph, ub[i]);
      // the carry into the first run; then the channel's inclusive scan
      const float cin = j == 0 ? carry[lc * N + k] : 0.0f;
      if (j == 0) ph = fmaf(pa, cin, ph);
#pragma unroll
      for (int d = 1; d < TPC; d <<= 1) {
        const float ua = __shfl_up_sync(FULL, pa, d * WARP_CH);
        const float uh = __shfl_up_sync(FULL, ph, d * WARP_CH);
        if (j >= d) {
          ph = fmaf(pa, uh, ph);
          pa = __fmul_rn(pa, ua);
        }
      }
      // ph: the state at the end of the run; h: the one before it
      float h = __shfl_up_sync(FULL, ph, WARP_CH);
      if (j == 0) h = cin;
      if (j == TPC - 1) carry[lc * N + k] = ph;
      load_items(ct + k * CHUNK + j * ITEMS, bc);
      const float an = more ? sa[lc * N + k + 1] : 0.0f;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        h = fmaf(da[i], h, ub[i]);
        yv[i] = fmaf(bc[i], h, yv[i]);
        if (more) dn[i] = ex2(__fmul_rn(dv[i], an));
      }
    };
    float da0[ITEMS], da1[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      da0[i] = ex2(__fmul_rn(dv[i], sa[lc * N]));
    static_assert(N % 2 == 0, "states in pairs");
#pragma unroll 1
    for (int k = 0; k < N; k += 2) {
      step(k, da0, da1, true);
      step(k + 1, da1, da0, k + 2 < N);
    }
"""
# name: (old, new) replacements in csrc/selective_scan.cu
VARIANTS = {
    "accurate expf": (
        ("? __fmul_rn(a[static_cast<size_t>(ch) * N + e % N], LOG2E)",
         "? a[static_cast<size_t>(ch) * N + e % N]"),
        ("da[i] = ex2(__fmul_rn(dv[i], ak));",
         "da[i] = expf(__fmul_rn(dv[i], ak));"),
        ("float pa = ex2(__fmul_rn(sdt, ak))",
         "float pa = expf(__fmul_rn(sdt, ak))")),
    "pipelined exponentials": (
        (("#pragma unroll 1\n    for (int k = 0; k < N; ++k) {",
          "    // y through the stage's x rows"), PIPELINED_LOOP),),
    # diagnostics, wrong by design: what the time is without a part
    "diagnostic: no exponentials": (
        ("da[i] = ex2(__fmul_rn(dv[i], ak));",
         "da[i] = __fmul_rn(dv[i], ak);"),
        ("float pa = ex2(__fmul_rn(sdt, ak))",
         "float pa = __fmul_rn(sdt, ak)")),
    "diagnostic: no b / c shared loads": (
        ("load_items(bt + k * CHUNK + j * ITEMS, bc);",
         "for (int i = 0; i < ITEMS; ++i) bc[i] = dv[i];"),
        ("load_items(ct + k * CHUNK + j * ITEMS, bc);",
         "for (int i = 0; i < ITEMS; ++i) bc[i] = u[i];")),
    "diagnostic: neither": (),
    "8 threads x 8 tokens, 6 blocks an SM": (
        ("constexpr int ITEMS = 16; ", "constexpr int ITEMS = 8; "),
        ("constexpr int MIN_BLOCKS = 4; ", "constexpr int MIN_BLOCKS = 6; ")),
}
VARIANTS["diagnostic: neither"] = (
    VARIANTS["diagnostic: no exponentials"]
    + VARIANTS["diagnostic: no b / c shared loads"])


def resident(lib: ctypes.CDLL) -> str:
    """Blocks of the chunked form resident an SM, per dtype and n."""
    fn = lib.selective_scan_chunked_resident
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return ", ".join(f"{'bf16' if bf else 'f32'} n {n}: {fn(n, bf)}"
                     for bf in (1, 0) for n in (16, 8))


def build_variant(name: str, subs, csrc: Path | None = None):
    """The scan's source (this checkout's, or the one in ``csrc``) with
    ``subs`` applied, built with the port's flags; its
    ``selective_scan_fwd`` entry."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc

    csrc = csrc or CSRC
    src = (csrc / "selective_scan.cu").read_text()
    for old, new in subs:      # old: a text, or (from, up to) texts
        first, last = old if isinstance(old, tuple) else (old, None)
        if src.count(first) != 1:
            raise RuntimeError(f"variant {name}: {first!r} is not in the "
                               f"source once")
        a = src.index(first)
        z = src.index(last, a) if last else a + len(first)
        src = src[:a] + new + src[z:]
    out = ROOT / "build" / "study" / "".join(
        ch if ch.isalnum() else "_" for ch in name)
    out.mkdir(parents=True, exist_ok=True)
    (out / "common.cuh").write_text((csrc / "common.cuh").read_text())
    (out / "scan.cu").write_text(src)
    log = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out / "scan.so"),
                          str(out / "scan.cu")], capture_output=True,
                         text=True)
    if log.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{log.stdout}"
                           f"{log.stderr}")
    regs = [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
            if "chunked" in ln or ("registers" in ln and "Used" in ln)]
    print(f"variant {name}: built; ptxas " + " | ".join(regs[-8:]))
    lib = ctypes.CDLL(str(out / "scan.so"))
    print(f"  resident blocks an SM: {resident(lib)}")
    fn = lib.selective_scan_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def kernel_label(symbol: str) -> str:
    form = "chunked" if "chunked_kernel" in symbol else "state"
    dtype = "bf16" if "bfloat16" in symbol else "f32"
    n = "16" if "Li16E" in symbol else "8"
    return f"{form} {dtype} n {n}"


def compare(torch, cs, label, spec, gen, dev, entries) -> bool:
    """Inputs for one of phase 17's shapes; each of the two ``entries``
    (name: launcher taking the kernel entry's arguments) against the plain
    version and phase 17's controls, then timed in turns, first, second,
    second, first. Returns whether both are within the limits and fail
    every control."""
    from repro_torch.kernels import ref

    b, s, di, n, dt_name, with_state = spec
    dtype = getattr(torch, dt_name)
    args, state = cs.scan_inputs(torch, gen, dev, b, s, di, n, dtype,
                                 with_state)
    x, dt, bm, cm, a = args
    want = ref.selective_scan_ref(*args, state=state)
    controls = {}
    if dtype == torch.bfloat16 and s > 1:
        y32, h32 = ref.selective_scan_ref(x.float(), dt.float(), bm, cm, a,
                                          state=state)
        controls["dt x unrounded"] = (y32.to(dtype), h32)
    if with_state:
        controls["state ignored"] = ref.selective_scan_ref(*args)
    y, h = torch.empty_like(x), torch.empty((b, di, n), device=dev)
    ptrs = (x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), None if state is None else state.data_ptr(), b, s,
            di, n, int(dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs, ok, notes = [], True, []
    for name, launch in entries.items():
        def run(launch=launch):
            launch(*ptrs, y.data_ptr(), h.data_ptr(), stream)
        run()
        torch.cuda.synchronize()
        ry, rh = cs.scan_limit_ratio(torch, (y, h), want, parts=True)
        ctl = {c: cs.scan_limit_ratio(torch, (y, h), f)
               for c, f in controls.items()}
        ok &= max(ry, rh) <= 1.0 and all(r > 1.0 for r in ctl.values())
        notes.append(f"{name} y {ry:.3g} state {rh:.3g}"
                     + "".join(f", {c} {r:.3g}" for c, r in ctl.items()))
        runs.append(run)
    iters = 10 if s > 1024 else 50
    turns = [cs.call_ms(fn, iters=iters) * 1e3
             for fn in (runs[0], runs[1], runs[1], runs[0])]
    dev_us = [cs.device_ms(fn, iters=iters) * 1e3 for fn in runs]
    bound_ms, by = cs.scan_bound(b, s, di, n, x.element_size(), with_state)
    names = list(entries)
    print(f"{label} (B {b}, S {s}, di {di}, n {n}, {dt_name}"
          f"{', a state' if with_state else ''}): limit ratios "
          f"{'; '.join(notes)}; us {' / '.join(names + names[::-1])} "
          f"{' / '.join(f'{t:.2f}' for t in turns)}; device us "
          f"{' / '.join(f'{t:.2f}' for t in dev_us)}; bound "
          f"{bound_ms * 1e3:.3f} us by {by}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sass-out", type=Path)
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--shapes", nargs="*",
                    help="labels of SCAN_SHAPES to time the variants at")
    opts = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import selective_scan as sscan
    from repro_torch.kernels.build import KERNELS, build_all, library_path

    if not torch.cuda.is_available():
        print("selective_scan study: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    print(f"chunked form: {sscan.GROUP} channels a block, "
          f"{sscan.THREADS_PER_CHANNEL} threads a channel, {sscan.ITEMS} "
          f"tokens a thread, chunks of {sscan.CHUNK} (the threshold)")
    log = build_all().get("selective_scan.cu")
    for line in (log or "").splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    lib = library_path("selective_scan.cu")
    print(f"chunked form, resident blocks an SM: "
          f"{resident(ctypes.CDLL(str(lib)))}")
    for sym, code in sass_functions(lib).items():
        ops = collections.Counter(op for _, op, _ in code)
        top = ", ".join(f"{o} {c}" for o, c in ops.most_common(10))
        loop = collections.Counter(innermost_shuffle_loop(code))
        print(f"SASS {kernel_label(sym)}: {len(code)} instructions "
              f"({top})" + (
                  f"; the state loop {sum(loop.values())} instructions a "
                  f"state and run, {loop['MUFU.EX2']} MUFU.EX2, "
                  f"{sum(c for o, c in loop.items() if o.startswith('LDS'))}"
                  f" LDS, {sum(c for o, c in loop.items() if o.startswith('SHFL'))}"
                  f" SHFL" if loop else ""))
    if opts.sass_out:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        opts.sass_out.parent.mkdir(parents=True, exist_ok=True)
        opts.sass_out.write_text(subprocess.run(
            [tool, "-sass", str(lib)], check=True, capture_output=True,
            text=True).stdout)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    kern = KERNELS["selective_scan"]

    def form(f):
        def launch(*a):
            kern(*a[:11], f, *a[11:])
        return launch

    shapes = {label: spec for label, *spec in cs.SCAN_SHAPES}
    ok_all = True
    for label, spec in shapes.items():
        ok_all &= compare(torch, cs, label, spec, gen, dev,
                          {"state": form(0), "chunked": form(1)})
        torch.cuda.empty_cache()
    print(f"both forms within the limits, every control failing: {ok_all}")
    builds = ({"parent": ((), opts.parent / "src/repro_torch/kernels/csrc")}
              if opts.parent else {})
    if opts.variants:
        builds |= {name: (subs, None) for name, subs in VARIANTS.items()}
    for name, (subs, csrc) in builds.items():
        fn = build_variant(name, subs, csrc)

        def variant(*a, fn=fn):
            err = fn(*a[:11], 1, *a[11:])
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        for label in opts.shapes or shapes:
            good = compare(torch, cs, label, shapes[label], gen, dev,
                           {name: variant, "chunked": form(1)})
            print(f"  {name}: within the limits, every control failing: "
                  f"{good}")
            torch.cuda.empty_cache()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
