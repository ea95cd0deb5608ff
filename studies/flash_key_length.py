#!/usr/bin/env python3
"""The flash kernel with a key length of its own against the kernel it
grew from, on one NVIDIA GPU.

    python3 studies/flash_key_length.py --parent <checkout of the parent>

Builds the parent checkout's ``src/repro_torch/kernels/csrc/
flash_attention.cu`` (one sequence length ``seq``) with the port's
``nvcc`` flags into ``build/study/`` (ignored by git), and calls it and
this checkout's kernel (``seq_q`` and ``seq_k``) on the same inputs at
``chip_smoke.FLASH_CASES`` (phase 11: the causal LM paths' shapes) and at
the shapes of ``tests/test_torch_gpu.py``'s flash test where Sq = Sk
(causal or not, windows down to 1, ragged, bf16 at D 32 / 64 / 128 / 256
and float32). Where Sq = Sk the two must agree bit for bit. Each shape is
timed in turns, parent, this, this, parent (``chip_smoke.call_ms``, CUDA
events over back-to-back calls), both launched through ``ctypes`` into
one output allocated once, so that no wrapper's host work enters the
time. Needs a card, ``nvcc`` and the repository's ``src`` on the path;
it imports no JAX.
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

# tests/test_torch_gpu.py's flash shapes with Sq = Sk: (label, B, Sq, Sk,
# H, Hkv, D, window, causal, dtype), as chip_smoke.FLASH_CASES
TEST_CASES = tuple(
    (f"test {i}", b, s, s, h, hkv, d, w, c, dt) for i, (dt, b, s, h, hkv, d,
                                                       c, w) in enumerate((
        ("bfloat16", 1, 200, 4, 2, 128, True, 64),
        ("bfloat16", 2, 333, 6, 2, 128, True, None),
        ("bfloat16", 1, 130, 4, 1, 32, False, None),
        ("bfloat16", 1, 257, 8, 2, 32, True, 100),
        ("bfloat16", 1, 200, 4, 4, 128, False, 50),
        ("bfloat16", 1, 1, 4, 2, 128, True, None),
        ("bfloat16", 1, 300, 24, 2, 128, True, 128),
        ("bfloat16", 1, 300, 4, 2, 128, True, 1),
        ("bfloat16", 2, 333, 4, 2, 256, True, 100),
        ("bfloat16", 1, 200, 2, 1, 256, False, None),
        ("bfloat16", 1, 257, 5, 1, 64, True, 64),
        ("bfloat16", 1, 130, 4, 4, 64, False, 50),
        ("float32", 2, 77, 4, 2, 32, False, None),
        ("float32", 1, 77, 8, 2, 32, True, 16),
        ("float32", 1, 100, 4, 2, 21, True, 30),
        ("float32", 1, 150, 4, 2, 128, True, None))))


def parent_kernel(parent: Path):
    """The parent's ``flash_attention_fwd`` (q k v batch seq heads
    kv_heads head_dim causal window is_bf16 o stream), built here."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    out = ROOT / "build" / "study" / "flash_attention_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = parent / "src/repro_torch/kernels/csrc/flash_attention.cu"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).flash_attention_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, I, I, I, I, P, P]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels.build import KERNELS

    if not torch.cuda.is_available():
        print("flash_key_length: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    old = parent_kernel(args.parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    same_all = True
    for label, b, sq, sk, h, hkv, d, window, causal, dtype in (
            cs.FLASH_CASES + TEST_CASES):
        dtype = getattr(torch, dtype)
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, sk, hkv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        o_old, o_new = torch.empty_like(q), torch.empty_like(q)
        stream = torch.cuda.current_stream(dev).cuda_stream
        shape = (b, sq, h, hkv, d, int(causal), int(window or 0),
                 int(dtype == torch.bfloat16))
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())

        def parent():
            err = old(*ptrs, *shape, o_old.data_ptr(), stream)
            if err:
                raise RuntimeError(f"the parent's kernel: CUDA error {err}")

        def this():
            KERNELS["flash_attention"](*ptrs, b, sq, sk, *shape[2:],
                                       o_new.data_ptr(), stream)

        parent()
        this()
        same = torch.equal(o_old, o_new)
        same_all &= same
        iters = 5 if sq > 1024 else 50
        times = [cs.call_ms(fn, iters=iters) * 1e3
                 for fn in (parent, this, this, parent)]
        print(f"{label} (B {b}, S {sq}, H {h}, Hkv {hkv}, D {d}, window "
              f"{window}, causal {causal}, {str(dtype)[6:]}): bitwise equal "
              f"{same}; us parent / this / this / parent "
              f"{' / '.join(f'{t:.2f}' for t in times)}")
    print(f"every shape bitwise equal: {same_all}")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
