"""Per-family blocks, as ``repro/models/transformer.py``; so far the RWKV6
family. The attention, MoE, SSM (hybrid) and encoder-decoder families
raise ``NotImplementedError``: they are ROADMAP Queue 1 ("the rest of the
LM substrate"). The port runs on one card, so nothing is padded for tensor
parallelism.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_init
from repro_torch.models.rwkv import (rwkv_block_init, rwkv_channel_mix,
                                     rwkv_time_mix)

__all__ = ["block_init", "block_apply", "block_decode", "init_block_cache"]


def _only_rwkv(cfg: ArchConfig) -> None:
    if not cfg.rwkv:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port has only the RWKV6 blocks "
            f"so far; the attention, MoE, SSM and encoder-decoder families "
            f"are ROADMAP Queue 1 (the rest of the LM substrate)")


def block_init(gen: torch.Generator, cfg: ArchConfig, *,
               device=None) -> dict:
    """One decoder layer's params."""
    _only_rwkv(cfg)
    d = cfg.d_model
    p = rwkv_block_init(gen, d, cfg.d_ff, cfg.rwkv_head_dim, device)
    p["ln1"] = rmsnorm_init(d, device)
    p["ln2"] = rmsnorm_init(d, device)
    return p


def block_apply(p, cfg: ArchConfig, x):
    """Full-sequence layer application."""
    _only_rwkv(cfg)
    tm, _, _ = rwkv_time_mix(p["tm"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                             head_dim=cfg.rwkv_head_dim)
    x = x + tm
    cm, _ = rwkv_channel_mix(p["cm"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + cm


def init_block_cache(cfg: ArchConfig, batch: int, device=None) -> dict:
    """Per-layer decode state (zeros; stacked over layers by the caller).
    The token-shift carries are stored in bfloat16 whatever ``cfg.dtype``
    is, as in the JAX package."""
    _only_rwkv(cfg)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    nh = d // hd
    return {
        "wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                           device=device),
        "tm_shift": torch.zeros((batch, 1, d), dtype=torch.bfloat16,
                                device=device),
        "cm_shift": torch.zeros((batch, 1, d), dtype=torch.bfloat16,
                                device=device),
    }


def block_decode(p, cfg: ArchConfig, x, cache):
    """One-token layer step. x: (B, 1, d). Returns (x, new_cache)."""
    _only_rwkv(cfg)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    tm, wkv, tshift = rwkv_time_mix(
        p["tm"], h, head_dim=cfg.rwkv_head_dim, wkv_state=cache["wkv"],
        shift_state=cache["tm_shift"].to(h.dtype))
    x = x + tm
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    cm, cshift = rwkv_channel_mix(p["cm"], h,
                                  shift_state=cache["cm_shift"].to(h.dtype))
    x = x + cm
    new_cache = {"wkv": wkv, "tm_shift": tshift.to(torch.bfloat16),
                 "cm_shift": cshift.to(torch.bfloat16)}
    return x, new_cache
