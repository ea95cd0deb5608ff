#!/usr/bin/env python3
"""LM training's phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 studies/lm_train.py [24] [25] [26] [27]

Builds the port's kernels (``build.build_all``), prints what ``ptxas``
says of the flash backward's kernels (registers, spills) and runs the
named phases of ``chip_smoke.py`` (all four by default) through its own
functions: 24 ``flash_bwd_checks`` (the backward against its plain
version at ``FLASH_BWD_CASES``, with the faulty versions, timed beside
SDPA's backward and its bound), 25 ``lm_train_agreement`` (REDUCED
training card vs CPU, in float32 and StarCoder2's bf16), 26
``lm_train_path`` (StarCoder2-3B training at full width, and the
witness of its first losses) and 27 ``lm_cli``. Needs a card, ``nvcc``
and the repository's ``src`` on the path; imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.build import KERNELS, build_all

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("phases", nargs="*", default=["24", "25", "26", "27"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build_all()
    print(f"build {time.perf_counter() - t0:.1f} s ({cs.card_line()})")
    name = ""
    for line in logs.get("flash_attention_bwd.cu", "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        if "registers" in line or "spill" in line:
            print(f"  {name[:70]}: {line.strip()}")
    if "24" in args.phases:
        cs.flash_bwd_checks(torch, torch.device("cuda"),
                            cs.FLASH_BWD_CASES)
    if "25" in args.phases:
        cs.lm_train_agreement(torch, KERNELS)
    if "26" in args.phases:
        cs.lm_train_path(torch, KERNELS)
    if "27" in args.phases:
        cs.lm_cli()
    print(cs.profile_loss_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
