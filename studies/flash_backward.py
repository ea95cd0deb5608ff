#!/usr/bin/env python3
"""The flash backward's tensor-core forms on one NVIDIA GPU: their
build, the variants of them that were tried, and the kernels they
replaced.

    python3 studies/flash_backward.py [--parent <checkout>] [--variants]
                                      [--shapes LABEL ...]
                                      [--cases LABEL ...]

Builds the port's kernels (``build.build_all``) and prints what ``ptxas``
says of the backward's kernels (registers, spills) and an opcode count of
each one's SASS (``cuobjdump -sass``). Then, at the shapes of
``chip_smoke.FLASH_BWD_CASES`` (bf16 by ``wgmma`` at D 32, 64, 128 and
256, float32 as 3xTF32 by ``mma.sync``; inputs as phase 24 makes them;
``--cases`` picks some by label), it holds the kernel to phase 24's
limits (``chip_smoke.flash_bwd_ratio`` against ``flash_bwd_plain``) and
times it through the kernel entry into outputs and scratch allocated
once (``chip_smoke.call_ms``: CUDA events over back-to-back calls;
``chip_smoke.device_ms``: the profiler), beside the bound of phase 24
(in float32 the function's FLOPs three times at the TF32 rate).

``--parent`` builds another checkout's ``flash_attention.cu`` and
``flash_attention_bwd.cu`` (its ``src/repro_torch/kernels/csrc``) into
``build/study/`` (ignored by git): its forward must agree with this one's
bit for bit (o and the lse) at each shape, its backward is held to the
same limits and timed in turns, parent, this, this, parent, and where
``--same`` names the shape's head dim (bf16; 0 for float32) the two
backwards' outputs must agree bit for bit.
``--variants`` builds ``VARIANTS`` (this source with a few lines
replaced: the dK / dV walk's runs, and diagnostics that are wrong by
design) and times each in turns against this kernel at ``--shapes``
(labels of ``FLASH_BWD_CASES``; default the first two). Needs a card,
``nvcc`` and the repository's ``src`` on the path; it imports no JAX.
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


def _split_for(body: str) -> tuple:
    """Substitutions that put a split of float32 x into tf32 hi + lo with
    ``body`` in place of ``gru::Tf32x3::split`` at each of the float32
    form's nine calls."""
    return (('#include "gru_tile.cuh"\n',
             '#include "gru_tile.cuh"\n__device__ __forceinline__ void '
             'study_split(float x, uint32_t& hi, uint32_t& lo) {\n'
             + body + "}\n", 1),
            ("gru::Tf32x3::split(", "study_split(", 9))


# name: ((old text, new text, occurrences), ...) in flash_attention_bwd.cu
VARIANTS = {
    "one run a key tile": (
        ("constexpr int MIN_BLOCKS = 4 * 132;",
         "constexpr int MIN_BLOCKS = 1;", 1),),
    "runs for 8 waves": (
        ("constexpr int MIN_BLOCKS = 4 * 132;",
         "constexpr int MIN_BLOCKS = 8 * 132;", 1),),
    "runs of 32 steps at least": (
        ("constexpr int MIN_STEPS = 8;", "constexpr int MIN_STEPS = 32;", 1),),
    "exp2f for ex2.approx": (
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "  y = exp2f(x);", 1),),
    # diagnostics, wrong by design or slower by design: what a part costs
    "diagnostic: every tile masked": (
        ("const bool edge = (p.causal", "const bool edge = true || (p.causal",
         4),),
    "diagnostic: no lo parts in dK / dV": (
        ("          wgmma_ss<1>(part,\n"
         "                      gmma_desc(a + G::PDS_BYTES + kk * 32, 16, "
         "1024, 1), bd,\n                      1);\n", "", 1),),
    # D 256: what the lo parts and the first of a step's two barriers
    # cost (without it the consumers race on the shared parts)
    "diagnostic: no lo parts at D 256": (
        ("    wgmma_ss<1>(acc, gmma_desc(a + Wide::PART + kk * 32, 16, 1024, "
         "1), bd,\n                1);\n", "", 1),),
    "diagnostic: one barrier a step at D 256": (
        ("      pair_sync();\n      wgmma_wait<0>();",
         "      wgmma_wait<0>();", 1),
        ("    pair_sync();  // both consumers done with the last tile's dS "
         "parts\n", "", 1)),
    # float32 (3xTF32): the runs, and what the lo passes cost (one tf32
    # pass must fail the limit)
    "f32: one run a key tile": (
        ("constexpr int F_MIN_BLOCKS = 4 * 132;",
         "constexpr int F_MIN_BLOCKS = 1;", 1),),
    "f32: runs for 8 waves": (
        ("constexpr int F_MIN_BLOCKS = 4 * 132;",
         "constexpr int F_MIN_BLOCKS = 8 * 132;", 1),),
    "f32: 32-key dQ tiles at D 128": (
        ("  return nk > 16 ? 32 : 64;\n}", "  return nk > 8 ? 32 : 64;\n}",
         1),),
    "f32: truncating split": _split_for(
        "  hi = __float_as_uint(x) & 0xffffe000u;\n"
        "  lo = __float_as_uint(x - __uint_as_float(hi));\n"),
    "diagnostic: f32 no split instructions": _split_for(
        "  hi = __float_as_uint(x);\n  lo = hi;\n"),
    "diagnostic: f32 no dV / dK / dQ products": (
        ("      mma3(acc[2 * m], ah, al, u.x, w.x);\n"
         "      mma3(acc[2 * m + 1], ah, al, u.y, w.y);\n", "", 1),),
    "diagnostic: f32 one tf32 pass": (
        ("  gru::mma_tf32(c, al, bh0, bh1);\n  gru::mma_tf32(c, ah, bl0, "
         "bl1);\n", "", 1),
        ("  gru::mma_tf32(c0, al, bh0, bh1);\n  gru::mma_tf32(c1, ah, bl0, "
         "bl1);\n", "", 1)),
}


def sass_counts(lib: Path) -> dict:
    """{kernel symbol: Counter of opcodes} of a built library's SASS, or
    {} where the toolkit has no cuobjdump."""
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
            out[name] = collections.Counter()
        elif name and s.startswith("/*") and "*/" in s:
            words = s.split("*/", 1)[1].replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0] not in ("}", "{"):
                out[name][words[0].split(".")[0]] += 1
    return out


def build(name: str, csrc: Path, source: str, subs=()) -> Path:
    """``source`` of ``csrc`` with ``subs`` applied, built with the port's
    flags into ``build/study/<name>/``; prints ptxas's lines on its
    kernels and returns the library."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    text = (csrc / source).read_text()
    for old, new, count in subs:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} is not in the source "
                               f"{count} times")
        text = text.replace(old, new)
    out = ROOT / "build" / "study" / "".join(
        ch if ch.isalnum() else "_" for ch in name)
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    (out / source).write_text(text)
    lib = out / (Path(source).stem + ".so")
    log = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                          str(out / source)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}{log.stderr}")
    print_ptxas(name, log.stdout + log.stderr)
    return lib


def print_ptxas(name: str, log: str) -> None:
    """Registers and spills of the flash kernels from a build log
    (``-Xptxas=-v``)."""
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            sym = line.split("'")[1]
            kernel = next((k for k in ("bwd_dkdv_wg256", "bwd_dq_wg256",
                                       "bwd_dkdv_wg", "bwd_dq_wg",
                                       "bwd_dkdv_sum_f32", "bwd_dkdv_f32",
                                       "bwd_dq_f32",
                                       "bwd_dkdv_sum", "bwd_dkdv_tc",
                                       "bwd_dq_tc", "bwd_dkdv", "bwd_dq",
                                       "fa_bf16_kernel", "fa_f32_tc_kernel",
                                       "fa_f32_kernel")
                           if k in sym), None)
            if kernel and "ILi" in sym:
                kernel += (" NK " if "f32" in kernel else " D ") + sym.split(
                    "ILi")[1].split("E")[0] + (" VEC" if "Lb1" in sym else
                                               "")
        elif kernel and ("spill" in line or "Used" in line):
            print(f"  {name} {kernel}: {line.strip()}")


def bwd_entry(lib_path: Path):
    """The library's ``flash_attention_bwd`` as a launcher taking (q, k, v,
    o, lse, do, outputs, scratch) tensors and the call's shape; with the
    scratch size it asks of the library (none in a form without one)."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.flash_attention_bwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    scratch = getattr(lib, "flash_attention_bwd_scratch", None)
    if scratch is not None:
        scratch.argtypes, scratch.restype = [I] * 9, L
        fn.argtypes = [P] * 6 + [I] * 9 + [P, P, L, P, P, P, P]
    else:
        fn.argtypes = [P] * 6 + [I] * 9 + [P] * 5
    fn.restype = ctypes.c_int

    def make(torch, args, shape, dev):
        q, k, v, o, lse, do = args
        outs = [torch.empty_like(x) for x in (q, k, v)]
        delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)
        n = scratch(*shape) if scratch is not None else 0
        part = torch.empty(max(n, 1), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in args]

        def run():
            extra = ([delta.data_ptr(), part.data_ptr(), n]
                     if scratch is not None else [delta.data_ptr()])
            err = fn(*ptrs, *shape, *extra, *(x.data_ptr() for x in outs),
                     stream)
            if err:
                raise RuntimeError(f"{lib_path.name}: CUDA error {err}")
            return outs
        return run
    return make


def fwd_entry(lib_path: Path):
    """The library's ``flash_attention_fwd`` (q k v batch seq_q seq_k
    heads kv_heads head_dim causal window is_bf16 o lse stream)."""
    fn = ctypes.CDLL(str(lib_path)).flash_attention_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P] + [I] * 9 + [P, P, P]
    fn.restype = ctypes.c_int
    return fn


def compare(torch, cs, case, gen, dev, entries, parent_fwd=None,
            same=False) -> bool:
    """One phase-24 shape: each of ``entries`` (name: ``bwd_entry``) held
    to the limits and bitwise over two calls, then timed in turns (first,
    second, second, first); with ``parent_fwd``, the forward of the
    parent against this one's, bit for bit; with ``same``, the entries'
    outputs bit for bit. Returns whether every check held."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    label, b, sq, sk, h, hkv, d, window, causal, dtype = case
    dtype = getattr(torch, dtype)
    bf16 = dtype == torch.bfloat16
    q, do = (torch.randn((b, sq, h, d), generator=gen, device=dev)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    ok, notes = True, []
    if parent_fwd is not None:
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
        err = parent_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, sk,
                         h, hkv, d, int(causal), int(window or 0),
                         int(bf16),
                         o2.data_ptr(), lse2.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
        fwd_same = not err and torch.equal(o, o2) and torch.equal(lse, lse2)
        ok &= fwd_same
        notes.append(f"forward bitwise the parent's {fwd_same}")
    args = (q, k, v, o, lse, do)
    shape = (b, sq, sk, h, hkv, d, int(causal), int(window or 0), int(bf16))
    want = cs.flash_bwd_plain(torch, *args, causal, window)
    runs, outs = [], []
    for name, make in entries.items():
        run = make(torch, args, shape, dev)
        got = [x.clone() for x in run()]
        again = all(torch.equal(x, y) for x, y in zip(got, run()))
        ratio = cs.flash_bwd_ratio(torch, got, want, bf16)
        ok &= again and (ratio <= 1.0 or name.startswith("diagnostic"))
        notes.append(f"{name} {ratio:.3g} of the limit, two calls bitwise "
                     f"{again}")
        runs.append(run)
        outs.append(got)
    if same:
        equal = all(torch.equal(x, y) for x, y in zip(*outs))
        ok &= equal
        notes.append(f"outputs bitwise the {list(entries)[0]}'s {equal}")
    del outs
    iters = 3 if sq * sk > 1024 * 1024 else 20
    names = list(entries)
    order = [0, 1, 1, 0] if len(runs) > 1 else [0, 0]
    turns = [cs.call_ms(runs[i], iters=iters) * 1e3 for i in order]
    dev_us = [cs.device_ms(fn, iters=iters, rounds=3) * 1e3 for fn in runs]
    pairs = cs.causal_pairs(sq, window) if causal else sq * sk
    # float32: the function's FLOPs three times (3xTF32) at the TF32 rate
    flops = 2.5 * 4.0 * d * b * h * pairs
    bound_ms, by = cs.bound(
        q.element_size() * (4 * q.numel() + 2 * (k.numel() + v.numel()))
        + 4 * lse.numel(),
        flops if bf16 else 3 * flops,
        cs.BF16_FLOP_PER_S if bf16 else cs.TF32_FLOP_PER_S)
    split = breakdown(torch, runs[-1])
    print(f"{label} (B {b}, Sq {sq}, Sk {sk}, H {h}, Hkv {hkv}, D {d}, "
          f"window {window}, causal {causal}): {'; '.join(notes)}; us "
          f"{' / '.join(names[i] for i in order)} "
          f"{' / '.join(f'{t:.2f}' for t in turns)}; device us "
          f"{' / '.join(f'{t:.2f}' for t in dev_us)}; bound "
          f"{bound_ms * 1e3:.2f} us by {by}; {names[-1]}'s launches, "
          f"device us a call: "
          + ", ".join(f"{k} {t:.2f}" for k, t in split.items()))
    return ok


def breakdown(torch, fn, calls: int = 3) -> dict:
    """Device µs a call of each of ``fn``'s kernels, from one profiled
    run of ``calls`` calls (the profiler may lose records: a reading,
    not a check)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        name = re.search(r"bwd_\w+", ev.key)
        if t and name:
            out[name.group(0)] += t / calls
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--variants", nargs="*",
                    help="names of VARIANTS to build (none named: all)")
    ap.add_argument("--shapes", nargs="*",
                    help="labels of FLASH_BWD_CASES to time variants at")
    ap.add_argument("--cases", nargs="*",
                    help="labels of FLASH_BWD_CASES to run (default all)")
    ap.add_argument("--same", nargs="*", type=int, default=[],
                    help="head dims (0: float32) whose outputs must be "
                         "bitwise the parent's")
    opts = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels.build import CSRC, build_all, library_path

    if not torch.cuda.is_available():
        print("flash_backward study: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    print_ptxas("this", build_all().get("flash_attention_bwd.cu") or "")
    lib = library_path("flash_attention_bwd.cu")
    for sym, ops in sass_counts(lib).items():
        if "bwd_" in sym:
            top = ", ".join(f"{o} {c}" for o, c in ops.most_common(12))
            print(f"SASS {sym[-60:]}: {sum(ops.values())} instructions "
                  f"({top})")

    dev = torch.device("cuda")
    cases = [c for c in cs.FLASH_BWD_CASES
             if not opts.cases or c[0] in opts.cases]
    entries = {"this": bwd_entry(lib)}
    parent_fwd = None
    if opts.parent:
        pcsrc = opts.parent / "src/repro_torch/kernels/csrc"
        entries = {"parent": bwd_entry(build(
            "parent bwd", pcsrc, "flash_attention_bwd.cu")), **entries}
        parent_fwd = fwd_entry(build("parent fwd", pcsrc,
                                     "flash_attention.cu"))
    gen = torch.Generator(device=dev).manual_seed(24)
    ok = True
    for case in cases:
        key = case[6] if case[-1] == "bfloat16" else 0
        ok &= compare(torch, cs, case, gen, dev, entries, parent_fwd,
                      same=opts.parent is not None and key in opts.same)
        torch.cuda.empty_cache()
    print(f"every shape within the limits and bitwise: {ok}")
    if opts.variants is not None:
        chosen = [c for c in cases
                  if c[0] in (opts.shapes or [x[0] for x in cases[:2]])]
        for name, subs in VARIANTS.items():
            if opts.variants and name not in opts.variants:
                continue
            var = bwd_entry(build(name, CSRC, "flash_attention_bwd.cu", subs))
            for case in chosen:
                good = compare(torch, cs, case, gen, dev,
                               {name: var, "this": bwd_entry(lib)})
                print(f"  {name}: within the limits: {good}")
                torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
