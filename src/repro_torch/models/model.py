"""Public LM API of the port: init / forward / init_cache / serve_step, as
``repro/models/model.py`` for the decoder-only RWKV6 and dense families.

Layer parameters are stacked over a leading layer axis, as the JAX package
stacks them for ``jax.lax.scan``, so ``repro_torch.convert`` carries a JAX
param tree and decode cache across key for key; here a Python loop over
the layer axis takes the scan's place.

Entry points take ``device=None``, which means ``"cuda"``, and raise
without a card; params and caches must already lie on that device.

Batch layouts: forward ``{"tokens": (B, S)}`` (positions 0..S-1);
serve_step ``{"token": (B,), "pos": (B,)}`` with the cache of
``init_cache``. RWKV6's state holds no positions, so it reads no
``"pos"`` and ignores ``cache_len``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import draw, linear_init, rmsnorm, rmsnorm_init
from repro_torch.models.transformer import (block_apply, block_decode,
                                            block_init, init_block_cache)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["init_params", "forward", "init_cache", "serve_step",
           "compute_dtype"]


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack(trees: list) -> dict:
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _layer(tree: dict, i: int) -> dict:
    return tree_map(lambda x: x[i], tree)


def _check_on(name: str, tree: dict, device: torch.device) -> None:
    bad = {str(x.device) for x in tree_leaves(tree)
           if x.device.type != device.type}
    if bad:
        raise ValueError(f"{name} lie on {sorted(bad)}, the call runs on "
                         f"{device}; move them with repro_torch.tree.tree_map")


# ---------------------------------------------------------------- init

def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """Params under the JAX package's keys (``embed``, ``final_norm/g``,
    ``layers/tm/wr/w`` stacked over layers, ``lm_head/w``), drawn from
    ``gen`` on its own device and placed on ``device``."""
    device = resolve_device(device)
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": draw(gen, (cfg.vocab, d), d ** -0.5, device),
        "final_norm": rmsnorm_init(d, device),
    }
    params["layers"] = _stack([block_init(gen, cfg, device=device)
                               for _ in range(cfg.n_layers)])
    params["lm_head"] = linear_init(gen, d, cfg.vocab, device=device)
    return params


# ------------------------------------------------------------- forward

def _embed_tokens(params, cfg: ArchConfig, tokens):
    # gather, then cast: the same values as the JAX package's cast of the
    # whole table followed by the gather, without casting every row
    return params["embed"][tokens].to(compute_dtype(cfg))


def _logits(params, x):
    return x @ params["lm_head"]["w"].to(x.dtype)


def forward(params, batch, cfg: ArchConfig, device=None):
    """Returns logits (B, S, vocab) in the compute dtype. (The JAX
    package also returns an MoE aux loss, always 0 for these families.)"""
    device = resolve_device(device)
    _check_on("params", params, device)
    tokens = torch.as_tensor(batch["tokens"]).to(device)
    x = _embed_tokens(params, cfg, tokens)                 # (B, S, d)
    b, s = tokens.shape
    positions = torch.arange(s, device=device).broadcast_to(b, s)
    # the layers in order: the JAX package's scan over stacked params
    for i in range(cfg.n_layers):
        x = block_apply(_layer(params["layers"], i), cfg, x, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x)


# -------------------------------------------------------------- decode

def init_cache(cfg: ArchConfig, batch: int, cache_len=None,
               device=None) -> dict:
    """Decode state, stacked over layers: each leaf (L, B, ...). Dense:
    K and V caches of ``cache_len`` slots (the prompt plus the tokens to
    generate), at most ``cfg.window`` (a ring buffer then). RWKV6's state
    does not grow with the sequence and reads no ``cache_len``."""
    device = resolve_device(device)
    if not cfg.rwkv:
        if cache_len is None:
            raise ValueError(f"{cfg.name}: init_cache needs cache_len")
        if cfg.window is not None:
            cache_len = min(cache_len, cfg.window)
    one = init_block_cache(cfg, batch, cache_len, device)
    return tree_map(lambda x: x[None].repeat(
        (cfg.n_layers,) + (1,) * x.dim()), one)


def serve_step(params, cache, batch, cfg: ArchConfig, device=None):
    """One decode step: batch {"token": (B,), "pos": (B,)} ("pos", the
    token's absolute position, only for the dense family).

    Returns (logits (B, vocab), new_cache); the cache passed in is not
    changed."""
    device = resolve_device(device)
    _check_on("params", params, device)
    _check_on("cache", cache, device)
    tokens = torch.as_tensor(batch["token"]).to(device)[:, None]   # (B, 1)
    pos = None if cfg.rwkv else torch.as_tensor(batch["pos"]).to(
        device=device, dtype=torch.int64)
    x = _embed_tokens(params, cfg, tokens)
    new = []
    for i in range(cfg.n_layers):
        x, c = block_decode(_layer(params["layers"], i), cfg, x, pos,
                            _layer(cache, i))
        new.append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, 0]
    return _logits(params, x), _stack(new)
