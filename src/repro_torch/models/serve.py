"""Batched serving, as ``examples/serve_lm.py``: prefill a batch of prompts
one token at a time through ``serve_step`` (the recurrent state or the KV
cache fills up), then decode, greedy or sampled.

    PYTHONPATH=src python -m repro_torch.models.serve --arch starcoder2-3b \\
        --batch 4 --prompt-len 32 --gen 32 [--full] [--device cpu]

Without ``--full`` the arch's reduced config runs, as in ``serve_lm.py``;
``--full`` runs the published widths, for the card (float32 params:
RWKV6-1.6B about 6.3 GB, StarCoder2-3B about 12.7 GB). Params are random,
from seed 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models.model import init_cache, init_params, serve_step
from repro_torch.models.sampling import sample_tokens

__all__ = ["Generation", "generate", "main"]


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray        # (B, gen) generated token ids
    prefill_s: float          # prompt tokens through serve_step, synced
    decode_s: float           # the gen decode steps, synced


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg: ArchConfig, prompts, gen: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             device=None) -> Generation:
    """Prefill ``prompts`` (B, P) int, P >= 1, then decode ``gen`` tokens;
    ``prompt_len + gen`` calls of ``serve_step`` in all, token t at
    position t; a KV cache holds ``prompt_len + gen`` slots (at most the
    window). Tokens stay on the device until the end."""
    device = resolve_device(device)
    prompts = torch.as_tensor(np.asarray(prompts)).to(device)
    b, plen = prompts.shape
    if plen < 1:
        raise ValueError("generate needs at least one prompt token")
    cache = init_cache(cfg, b, plen + gen, device=device)

    def pos(t):
        return torch.full((b,), t, dtype=torch.int64, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for t in range(plen):
        logits, cache = serve_step(params, cache, {"token": prompts[:, t],
                                                   "pos": pos(t)},
                                   cfg, device=device)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    def pick(lg):
        return sample_tokens(lg, temperature=temperature,
                             top_k=top_k, top_p=top_p, generator=generator)

    out = []
    tok = pick(logits)
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        logits, cache = serve_step(params, cache,
                                   {"token": tok, "pos": pos(plen + i)},
                                   cfg, device=device)
        tok = pick(logits)
    tokens = (torch.stack(out, dim=1) if out
              else torch.zeros((b, 0), dtype=torch.int64)).cpu().numpy()
    _sync(device)
    decode_s = time.perf_counter() - t0
    return Generation(tokens=tokens, prefill_s=prefill_s, decode_s=decode_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples (with --top-k/--top-p)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced "
                         "config")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    draws = torch.Generator(device=device).manual_seed(0)
    params = init_params(draws, cfg, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    res = generate(params, cfg, prompts, args.gen,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, generator=draws, device=device)
    b = args.batch
    print(f"{args.arch} ({'full' if args.full else 'reduced'}, {device}): "
          f"prefill {args.prompt_len} toks x{b} in {res.prefill_s:.2f}s; "
          f"decoded {args.gen} toks x{b} in {res.decode_s:.2f}s "
          f"({b * args.gen / res.decode_s:.1f} tok/s)")
    print("first sequence:", res.tokens[0][:16].tolist(), "...")


if __name__ == "__main__":
    main()
