#!/usr/bin/env python3
"""The flash forward's float32 form on one NVIDIA GPU: its build, the
variants of it that were tried, and the kernel it replaced.

    python3 studies/flash_forward.py [--parent <checkout>] [--variants
                                     [NAME ...]] [--cases LABEL ...]

Builds the port's kernels (``build.build_all``) and prints what ``ptxas``
says of the float32 forward's kernels (registers, spills) and an opcode
count of their SASS (``cuobjdump -sass``). Then, at the float32 shapes of
phases 11 and 20 (``chip_smoke.FLASH_CASES`` and ``FLASH_KEYS``;
``--cases`` picks some by label; inputs as those phases make them), it
holds the kernel to their float32 limit (1e-5 absolute of the plain
version, ``ref.flash_attention_probs @ v``), checks that two calls agree
bit for bit, and times it through the kernel entry into an output and an
lse allocated once (``chip_smoke.call_ms``: CUDA events over
back-to-back calls; ``chip_smoke.device_ms``: the profiler), beside its
bounds (the function's FLOPs three times at the TF32 rate, and once at
the CUDA cores' float32 FMA rate).

``--parent`` builds another checkout's ``flash_attention.cu`` (its
``src/repro_torch/kernels/csrc``) into ``build/study/`` (ignored by git),
holds it to the same limit and times it in turns: parent, this, this,
parent. ``--variants`` builds ``VARIANTS`` (this source with a few lines
replaced: tiles and chains, and diagnostics that are wrong by design)
and times each in turns against this kernel at the first case. Needs a
card, ``nvcc`` and the repository's ``src`` on the path; it imports no
JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "studies"))

# the lo passes of S (lo hi, hi lo) and of P V, and P V's hi pass
_S_LO = ("#pragma unroll\n        for (int j = 0; j < NT; ++j)\n"
         "          gru::mma_tf32(part[j], al, bh[j][0], bh[j][1]);\n"
         "#pragma unroll\n        for (int j = 0; j < NT; ++j)\n"
         "          gru::mma_tf32(part[j], ah, bl[j][0], bl[j][1]);\n")
_PV_LO = ("#pragma unroll\n        for (int n = 0; n < CG; ++n)\n"
          "          gru::mma_tf32(part[n], a.lo, bh[n][0], bh[n][1]);\n"
          "#pragma unroll\n        for (int n = 0; n < CG; ++n)\n"
          "          gru::mma_tf32(part[n], a.hi, bl[n][0], bl[n][1]);\n")
_PV_HI = ("#pragma unroll\n        for (int n = 0; n < CG; ++n)\n"
          "          gru::mma_tf32(part[n], a.hi, bh[n][0], bh[n][1]);\n")

# name: ((old text, new text, occurrences), ...) in flash_attention.cu
VARIANTS = {
    "S chains of 4 k-steps": (
        ("constexpr int F_CHAIN = 8;", "constexpr int F_CHAIN = 4;", 1),),
    "S chains of 16 k-steps": (
        ("constexpr int F_CHAIN = 8;", "constexpr int F_CHAIN = 16;", 1),),
    "P V groups of 16 n8 blocks": (
        ("static constexpr int CG = NK < 8 ? NK : 8;",
         "static constexpr int CG = NK < 16 ? NK : 16;", 1),),
    "32-key tiles at D 128": (
        ("static constexpr int BK = NK > 16 ? 32 : 64;",
         "static constexpr int BK = NK > 8 ? 32 : 64;", 1),),
    # diagnostics, wrong by design: what a part costs
    "diagnostic: one tf32 pass": ((_S_LO, "", 1), (_PV_LO, "", 1)),
    "diagnostic: no P V products": ((_PV_LO, "", 1), (_PV_HI, "", 1)),
}
# the float32 rows of phases 11 and 20
F32_CASES = ("starcoder2-3b training f32", "ragged f32", "ragged cross f32")


def compare(torch, cs, case, gen, dev, entries) -> bool:
    """One float32 shape: each of ``entries`` (name: the library's
    ``flash_attention_fwd``) held to the limit and bitwise over two
    calls, then timed in turns (first, second, second, first). Returns
    whether every check held."""
    from repro_torch.kernels import ref

    label, b, sq, sk, h, hkv, d, window, causal, _ = case
    q = torch.randn((b, sq, h, d), generator=gen, device=dev)
    k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=dev)
            for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ok, notes, runs, lses = True, [], [], []
    for name, fn in entries.items():
        o = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)

        def run(fn=fn, o=o, lse=lse, name=name):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, sk, h,
                     hkv, d, int(causal), int(window or 0), 0, o.data_ptr(),
                     lse.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return o

        got = run().clone()
        again = torch.equal(got, run())
        err = 0.0
        for bi, hs, qc, kc, vc in cs.head_chunks(q, k, v):
            att = ref.flash_attention_probs(qc, kc, causal=causal,
                                            window=window)
            err = max(err, float((got[bi:bi + 1, :, hs].transpose(1, 2)
                                  - att @ vc).abs().max()))
            del att
        ratio = err / cs.TOL
        ok &= again and (ratio <= 1.0 or name.startswith("diagnostic"))
        notes.append(f"{name} {ratio:.3g} of the limit, two calls bitwise "
                     f"{again}")
        runs.append(run)
        lses.append(lse)
        del got
    if len(lses) > 1:
        notes.append(f"max |lse difference| "
                     f"{float((lses[0] - lses[-1]).abs().max()):.3g}")
    iters = 3 if sq * sk > 1024 * 1024 else 20
    names = list(entries)
    order = [0, 1, 1, 0] if len(runs) > 1 else [0, 0]
    turns = [cs.call_ms(runs[i], iters=iters) * 1e3 for i in order]
    dev_us = [cs.device_ms(fn, iters=iters, rounds=3) * 1e3 for fn in runs]
    pairs = cs.causal_pairs(sq, window) if causal else sq * sk
    flops = 4.0 * d * b * h * pairs
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    tc_ms, by = cs.bound(nbytes, 3 * flops, cs.TF32_FLOP_PER_S)
    fma_ms, _ = cs.bound(nbytes, flops, cs.FP32_FLOP_PER_S)
    print(f"{label} (B {b}, Sq {sq}, Sk {sk}, H {h}, Hkv {hkv}, D {d}, "
          f"window {window}, causal {causal}): {'; '.join(notes)}; us "
          f"{' / '.join(names[i] for i in order)} "
          f"{' / '.join(f'{t:.2f}' for t in turns)}; device us "
          f"{' / '.join(f'{t:.2f}' for t in dev_us)}; bound "
          f"{tc_ms * 1e3:.2f} us by {by} (3xTF32), {fma_ms * 1e3:.2f} on "
          f"float32 FMA ({cs.card_line()})", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--variants", nargs="*",
                    help="names of VARIANTS to build (none named: all)")
    ap.add_argument("--cases", nargs="*",
                    help=f"labels of the float32 cases (default "
                         f"{', '.join(F32_CASES)})")
    opts = ap.parse_args()

    import torch

    import chip_smoke as cs
    from flash_backward import build, fwd_entry, print_ptxas, sass_counts
    from repro_torch.kernels.build import CSRC, build_all, library_path

    if not torch.cuda.is_available():
        print("flash_forward study: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    print_ptxas("this", build_all().get("flash_attention.cu") or "")
    lib = library_path("flash_attention.cu")
    for sym, ops in sass_counts(lib).items():
        if "fa_f32" in sym:
            top = ", ".join(f"{o} {c}" for o, c in ops.most_common(12))
            print(f"SASS {sym[-60:]}: {sum(ops.values())} instructions "
                  f"({top})")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    by_label = {c[0]: c for c in cs.FLASH_CASES + cs.FLASH_KEYS}
    cases = [by_label[n] for n in (opts.cases or F32_CASES)]
    entries = {"this": fwd_entry(lib)}
    if opts.parent:
        entries = {"parent": fwd_entry(build(
            "parent fwd", opts.parent / "src/repro_torch/kernels/csrc",
            "flash_attention.cu")), **entries}
    gen = torch.Generator(device=dev).manual_seed(11)
    ok = True
    for case in cases:
        ok &= compare(torch, cs, case, gen, dev, entries)
        torch.cuda.empty_cache()
    print(f"every shape within the limit and bitwise: {ok}")
    if opts.variants is not None:
        for name, subs in VARIANTS.items():
            if opts.variants and name not in opts.variants:
                continue
            var = fwd_entry(build(name, CSRC, "flash_attention.cu", subs))
            good = compare(torch, cs, cases[0], gen, dev,
                           {name: var, "this": fwd_entry(lib)})
            print(f"  {name}: within the limit: {good}")
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
