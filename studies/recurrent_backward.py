#!/usr/bin/env python3
"""The backward kernels of the two recurrences on one NVIDIA GPU: their
build, each launch's device time, and the kernels they replaced.

    python3 studies/recurrent_backward.py [--parent <checkout>]
                                          [--cases LABEL ...]
                                          [--variants [NAME ...]]

Builds the port's kernels (``build.build_all``) and prints what ``ptxas``
says of the WKV backward's and the selective scan backward's kernels
(registers, shared memory, spills). Then at each case of
``chip_smoke.WKV_BWD_CASES`` and ``SCAN_BWD_CASES`` (inputs as phase 24b
makes them), without stopping at a failure: the form that ran and each
launch's device µs a call (``chip_smoke.launch_split``), each gradient's
error over phase 24b's limit against the plain version (``recur_ratio``)
and against the kernel's own algebra in plain PyTorch
(``ref.rwkv6_bwd_chunked_ref``, ``ref.selective_scan_bwd_scanned_ref``),
two calls bitwise, and the device time a call (``chip_smoke.device_ms``).

``--parent`` builds another checkout's ``rwkv6_scan_bwd.cu`` and
``selective_scan_bwd.cu`` (its ``src/repro_torch/kernels/csrc``, with the
C interfaces the kernels had before the chunked designs: three launches
each, a boundary pass, a walk a chunk, the sums) into ``build/study/``
(ignored by git); at the two training calls (the first case of each
table) its launches' device µs are printed, its outputs compared with
this one's, and the two timed in turns, parent, this, this, parent.
``--variants`` builds ``VARIANTS`` (this source with a few lines
replaced; the diagnostics are wrong by design: what a part of a launch
costs) and times each at the training call against this kernel in turns,
variant, this, this, variant, with the variant's launches' µs. Needs a
card, ``nvcc`` and the repository's ``src`` on the path; it imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCES = ("rwkv6_scan_bwd.cu", "selective_scan_bwd.cu")

# name: (source, ((old text, new text, occurrences), ...))
VARIANTS = {
    "wkv diagnostic: grad's staging and sub-chunk setup only": (
        SOURCES[0],
        (("  const int d0 = 16 * ww + gq, d1 = d0 + 8;\n  const uint32_t gpa",
          "  if (n > 0) return;\n  const int d0 = 16 * ww + gq, d1 = d0 + "
          "8;\n  const uint32_t gpa", 1),)),
    "wkv diagnostic: no edge-state products": (
        SOURCES[0],
        (("    product<NV>(sa, base_a + L::V, 0, (a + 1) / 2,",
          "    product<NV>(sa, base_a + L::V, 0, 0,", 1),
         ("    product<3>(ga, base_a + L::O, (a + 1) / 2, 4,",
          "    product<3>(ga, base_a + L::O, 4, 4,", 1))),
    "wkv diagnostic: no m64n8 products": (
        SOURCES[0],
        (("    product8<3>(sdo, sa, base_a + L::O, SUB * a);\n"
          "    product8<NV>(gv, ga, base_a + L::V, SUB * a);\n", "", 1),
         ("    for (int kk = 0; kk < 4; ++kk) {\n      const uint64_t ad = ",
          "    for (int kk = 0; kk < 0; ++kk) {\n      const uint64_t ad = ",
          1))),
    "wkv diagnostic: no per-element pass": (
        SOURCES[0],
        (("    if (wt < D) {\n      const int d = wt;",
          "    if (n < 0) {\n      const int d = wt;", 1),
         ("    } else {\n      const int c = wt - D;",
          "    } else if (n < 0) {\n      const int c = wt - D;", 1))),
    "wkv: blocks in head-fastest order": (
        SOURCES[0],
        (("  const int ci = blockIdx.x % nc, bh = blockIdx.x / nc;",
          "  const int bh = blockIdx.x % (gridDim.x / nc),\n"
          "            ci = blockIdx.x / (gridDim.x / nc);", 2),)),
    "scan: sum blocks of 16 channels": (
        SOURCES[1],
        (("constexpr int SUM_CH = 32;", "constexpr int SUM_CH = 16;", 1),)),
    "scan diagnostic: grad's staging only": (
        SOURCES[1],
        (("  __syncthreads();\n  const int lane = threadIdx.x % 32, warp",
          "  __syncthreads();\n  if (nt > 0) return;\n  const int lane = "
          "threadIdx.x % 32, warp", 1),)),
    "scan diagnostic: no channel sums": (
        SOURCES[1],
        (("      channel_sum(pb, lane);\n      channel_sum(pc, lane);\n", "",
          1),
         ("    __syncthreads();\n    if (threadIdx.x < 2 * CHUNK) {",
          "    if (nt < 0) {", 1))),
    "scan diagnostic: sum's staging only": (
        SOURCES[1],
        (("  __syncthreads();\n  const int lane = threadIdx.x % 32;\n",
          "  __syncthreads();\n  if (t0 >= 0) return;\n  const int lane = "
          "threadIdx.x % 32;\n", 1),)),
}


def print_ptxas(name: str, log: str) -> None:
    """Registers, shared memory and spills of each kernel in a build log
    (``-Xptxas=-v``)."""
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1][:70]
        elif kernel and ("spill" in line or "Used" in line
                         or "wgmma" in line):
            print(f"  {name} {kernel}: {line.strip()}")


def build(name: str, csrc: Path, source: str, subs=()) -> Path:
    """``source`` of ``csrc`` with ``subs`` applied, built with the port's
    flags into ``build/study/<name>/``; prints ptxas's lines and returns
    the library."""
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
    for f in csrc.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    (out / source).write_text(text)
    lib = out / (Path(source).stem + ".so")
    log = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                          str(out / source)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}{log.stderr}")
    print_ptxas(name, log.stdout + log.stderr)
    return lib


def parent_wkv(torch, lib_path: Path):
    """The parent's ``rwkv6_wkv_bwd`` (r k v w u dout s0 ds_out batch heads
    seq in_bf16 chunks sb gb du_part dr dk dv dw du ds0 stream) as a call
    of ``rwkv6_bwd``'s arguments."""
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.rwkv6_wkv_bwd
    fn.argtypes = [P] * 8 + [I] * 5 + [P] * 10
    fn.restype = ctypes.c_int
    lib.rwkv6_wkv_bwd_chunk.restype = ctypes.c_int
    chunk = lib.rwkv6_wkv_bwd_chunk()

    def call(r, k, v, w, u, do, st, dst):
        b, s, h, d = r.shape
        nc = -(-s // chunk)
        f32 = dict(dtype=torch.float32, device=r.device)
        sb = torch.empty((b, h, nc, d, d), **f32)
        gb = torch.empty_like(sb)
        part = torch.empty((b, nc, h, d), **f32)
        outs = [torch.empty_like(x) for x in (r, k, v)] + [
            torch.empty((b, s, h, d), **f32), torch.empty((h, d), **f32),
            None if st is None else torch.empty((b, h, d, d), **f32)]
        ptr = [None if x is None else x.data_ptr() for x in outs]
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), do.data_ptr(),
                 None if st is None else st.data_ptr(),
                 None if dst is None else dst.data_ptr(), b, h, s,
                 int(r.dtype == torch.bfloat16), nc, sb.data_ptr(),
                 gb.data_ptr(), part.data_ptr(), *ptr,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent rwkv6_wkv_bwd: CUDA error {err}")
        return outs
    return call


def parent_scan(torch, lib_path: Path):
    """The parent's ``selective_scan_bwd`` (x dt b c a dy h0 dh_out batch
    seq channels state is_bf16 chunks groups hb gb part_db part_dc part_da
    dx ddt db dc da dh0 stream) as a call of ``selective_scan_bwd``'s
    arguments."""
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.selective_scan_bwd
    fn.argtypes = [P] * 8 + [I] * 7 + [P] * 12
    fn.restype = ctypes.c_int
    tiles = lib.selective_scan_bwd_tiles
    tiles.argtypes = [P, P]
    chunk, group = ctypes.c_int(), ctypes.c_int()
    tiles(ctypes.byref(chunk), ctypes.byref(group))

    def call(x, dt, b, c, a, dy, h0, dh):
        bsz, s, di = x.shape
        n = a.shape[1]
        nc, groups = -(-s // chunk.value), -(-di // group.value)
        f32 = dict(dtype=torch.float32, device=x.device)
        hb = torch.empty((bsz, nc, di, n), **f32)
        gb, pda = torch.empty_like(hb), torch.empty_like(hb)
        pdb = torch.empty((bsz, s, groups, n), **f32)
        pdc = torch.empty_like(pdb)
        outs = [torch.empty_like(x), torch.empty_like(x),
                torch.empty_like(b), torch.empty_like(c),
                torch.empty((di, n), **f32),
                None if h0 is None else torch.empty((bsz, di, n), **f32)]
        ptr = [None if z is None else z.data_ptr() for z in outs]
        err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                 a.data_ptr(), dy.data_ptr(),
                 None if h0 is None else h0.data_ptr(),
                 None if dh is None else dh.data_ptr(), bsz, s, di, n,
                 int(x.dtype == torch.bfloat16), nc, groups, hb.data_ptr(),
                 gb.data_ptr(), pdb.data_ptr(), pdc.data_ptr(),
                 pda.data_ptr(), *ptr,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent selective_scan_bwd: CUDA error {err}")
        return outs
    return call


def study(torch, cs, kind, case, args, call, plain, algebra, names,
          parent=None) -> bool:
    """One case: form and split, limits, bitwise repeat, time; with
    ``parent`` the parent's split, outputs and time in turns."""
    name = "rwkv6_bwd" if kind == "WKV" else "selective_scan_bwd"
    ok = True
    try:
        split, form = cs.launch_split(torch, name, lambda: call(*args))
        print(f"{kind} {case[0]}: form {form}; us a call by launch "
              + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
        got = call(*args)
        again = call(*args)
        same = all(x is None or torch.equal(x, y) for x, y in zip(got, again))
        ratios = cs.recur_ratio(torch, got, plain(), names)
        own = cs.recur_ratio(torch, got, algebra(), names)
        ms = cs.device_ms(lambda: call(*args))
        print(f"{kind} {case[0]}: over the limit against the plain version "
              + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items())
              + "; against its algebra "
              + ", ".join(f"{k} {v:.3g}" for k, v in own.items())
              + f"; bitwise twice {same}; device {ms * 1e3:.2f} us a call")
        ok = same and max(ratios.values()) <= 1.0
    except Exception as err:  # noqa: BLE001 - a study reports and goes on
        print(f"{kind} {case[0]}: FAILED {type(err).__name__}: {err}")
        return False
    if parent is not None:
        psplit = cs.launch_times(lambda: parent(*args))
        print(f"{kind} {case[0]} parent: us a call by launch "
              + ", ".join(f"{k} {v:.2f}" for k, v in psplit.items())
              + f" (sum {sum(psplit.values()):.2f})")
        pg = parent(*args)
        diff = ", ".join(
            f"{n} {float((p.double() - g.double()).abs().max()) / max(float(g.double().abs().max()), 1e-30):.3g}"
            for n, p, g in zip(names, pg, got) if g is not None)
        print(f"{kind} {case[0]}: |parent - this| / largest: {diff}")
        turns = []
        for fn in (parent, call, call, parent):
            turns.append(cs.device_ms(lambda: fn(*args)) * 1e3)
        print(f"{kind} {case[0]}: device us a call in turns parent / this / "
              f"this / parent: " + " / ".join(f"{t:.2f}" for t in turns)
              + f" ({cs.card_line()})")
    return ok


def swapped(kernel, lib_path: Path):
    """A context in which ``kernel`` (a ``build.KERNELS`` entry) calls the
    same symbol of another library."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        fn = getattr(ctypes.CDLL(str(lib_path)), kernel.symbol)
        fn.argtypes = list(kernel.argtypes)
        fn.restype = ctypes.c_int
        old, kernel._fn = kernel._fn, fn
        try:
            yield
        finally:
            kernel._fn = old
    return ctx()


def variant(torch, cs, name, lib, kernel, call, args) -> None:
    """A VARIANTS build at a training call: its launches' µs, and the
    device µs a call in turns, variant / this / this / variant."""
    with swapped(kernel, lib):
        split = cs.launch_times(lambda: call(*args))
    turns = []
    for which in ("variant", "this", "this", "variant"):
        if which == "variant":
            with swapped(kernel, lib):
                turns.append(cs.device_ms(lambda: call(*args)) * 1e3)
        else:
            turns.append(cs.device_ms(lambda: call(*args)) * 1e3)
    print(f"variant {name}: us a call by launch "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + "; in turns variant / this / this / variant "
          + " / ".join(f"{t:.2f}" for t in turns))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--cases", nargs="*",
                    help="labels of WKV_BWD_CASES / SCAN_BWD_CASES")
    ap.add_argument("--variants", nargs="*",
                    help="names of VARIANTS to build (none named: all)")
    opts = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.rwkv6_scan import rwkv6_bwd
    from repro_torch.kernels.selective_scan import selective_scan_bwd

    if not torch.cuda.is_available():
        print("recurrent_backward study: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    logs = build_all()
    for src in SOURCES:
        print_ptxas("this", logs.get(src) or "")
    pw = ps = None
    if opts.parent:
        pcsrc = opts.parent / "src/repro_torch/kernels/csrc"
        pw = parent_wkv(torch, build("parent wkv", pcsrc, SOURCES[0]))
        ps = parent_scan(torch, build("parent scan", pcsrc, SOURCES[1]))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(33)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ok = True
    for i, case in enumerate(cs.WKV_BWD_CASES):
        args = cs.wkv_bwd_inputs(torch, randn, case)
        if opts.cases and case[0] not in opts.cases:
            continue
        ok &= study(torch, cs, "WKV", case, args, rwkv6_bwd,
                    lambda: cs.wkv_bwd_plain(torch, *args),
                    lambda: cs.wkv_bwd_chunked(torch, *args),
                    ("dr", "dk", "dv", "dw", "du", "dstate0"),
                    pw if i == 0 else None)
        del args
        torch.cuda.empty_cache()
    for i, case in enumerate(cs.SCAN_BWD_CASES):
        args = cs.scan_bwd_inputs(torch, randn, case)
        if opts.cases and case[0] not in opts.cases:
            continue
        ok &= study(torch, cs, "scan", case, args, selective_scan_bwd,
                    lambda: cs.scan_bwd_plain(torch, *args),
                    lambda: ref.selective_scan_bwd_scanned_ref(
                        *args[:6], state=args[6], dstate=args[7]),
                    ("dx", "ddt", "db", "dc", "da", "dstate0"),
                    ps if i == 0 else None)
        del args
        torch.cuda.empty_cache()
    print(f"every case within the limits and bitwise: {ok} "
          f"({cs.card_line()})")
    if opts.variants is not None:
        from repro_torch.kernels.build import CSRC, KERNELS

        wargs = cs.wkv_bwd_inputs(torch, randn, cs.WKV_BWD_CASES[0])
        sargs = cs.scan_bwd_inputs(torch, randn, cs.SCAN_BWD_CASES[0])
        for name, (src, subs) in VARIANTS.items():
            if opts.variants and name not in opts.variants:
                continue
            lib = build(name, CSRC, src, subs)
            if src == SOURCES[0]:
                variant(torch, cs, name, lib, KERNELS["rwkv6_bwd"],
                        rwkv6_bwd, wargs)
            else:
                variant(torch, cs, name, lib, KERNELS["selective_scan_bwd"],
                        selective_scan_bwd, sargs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
