"""Per-family blocks, as ``repro/models/transformer.py``; so far the RWKV6
family and the dense attention family (GQA, RoPE, optional sliding
window, ungated GELU FFN). The MoE, SSM (hybrid), encoder-decoder and
vision-language families raise ``NotImplementedError``: they are ROADMAP
Queue 1 ("the rest of the LM substrate"). The port runs on one card, so
nothing is padded for tensor parallelism.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       ffn_apply, ffn_init, linear,
                                       linear_init, rmsnorm, rmsnorm_init,
                                       rope_freqs)
from repro_torch.models.rwkv import (rwkv_block_init, rwkv_channel_mix,
                                     rwkv_time_mix)

__all__ = ["attn_init", "attn_apply", "attn_decode", "block_init",
           "block_apply", "block_decode", "init_block_cache"]


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.rwkv or (cfg.family == "dense" and cfg.rope == "rope"):
        return
    raise NotImplementedError(
        f"{cfg.name} ({cfg.family}, rope {cfg.rope!r}): the port has the "
        f"RWKV6 blocks and the dense RoPE attention blocks so far; the MoE, "
        f"SSM, encoder-decoder and vision-language families are ROADMAP "
        f"Queue 1 (the rest of the LM substrate)")


# ------------------------------------------------------------ attention

def attn_init(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": linear_init(gen, d, cfg.n_heads * dh, device=device),
        "wk": linear_init(gen, d, cfg.n_kv_heads * dh, device=device),
        "wv": linear_init(gen, d, cfg.n_kv_heads * dh, device=device),
        "wo": linear_init(gen, cfg.n_heads * dh, d,
                          scale=(cfg.n_heads * dh) ** -0.5, device=device),
    }


def _project_qkv(p, cfg: ArchConfig, x, positions):
    """x: (B, S, d); positions: (B, S). Returns q (B, S, H, Dh) and k, v
    (B, S, Hkv, Dh), RoPE applied to q and k."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], x).view(b, s, cfg.n_heads, dh)
    k = linear(p["wk"], x).view(b, s, cfg.n_kv_heads, dh)
    v = linear(p["wv"], x).view(b, s, cfg.n_kv_heads, dh)
    freqs = rope_freqs(dh, cfg.rope_theta, x.device)
    return apply_rope(q, positions, freqs), apply_rope(k, positions, freqs), v


def attn_apply(p, cfg: ArchConfig, x, positions):
    """Full-sequence causal self-attention (prompt scoring), through the
    flash attention op: the CUDA kernel on the card."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    ctx = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
    return linear(p["wo"], ctx.reshape(b, s, -1))


def attn_decode(p, cfg: ArchConfig, x, pos, k_cache, v_cache, slot, valid):
    """One-token attention. x: (B, 1, d); pos: (B,) absolute position;
    slot: (B,) cache write index (pos, or pos % cache_len for a ring);
    valid: (B, S_cache) live-slot mask after the write. Returns (out,
    k_cache, v_cache), the caches written out of place."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    bi = torch.arange(b, device=x.device)
    k_cache = k_cache.index_put((bi, slot), k[:, 0].to(k_cache.dtype))
    v_cache = v_cache.index_put((bi, slot), v[:, 0].to(v_cache.dtype))
    out = decode_attention(q[:, 0], k_cache, v_cache, valid)
    return linear(p["wo"], out.reshape(b, 1, -1)), k_cache, v_cache


# -------------------------------------------------------------- blocks

def block_init(gen: torch.Generator, cfg: ArchConfig, *,
               device=None) -> dict:
    """One decoder layer's params."""
    _check_ported(cfg)
    d = cfg.d_model
    if cfg.rwkv:
        p = rwkv_block_init(gen, d, cfg.d_ff, cfg.rwkv_head_dim, device)
        p["ln1"] = rmsnorm_init(d, device)
        p["ln2"] = rmsnorm_init(d, device)
        return p
    return {
        "ln1": rmsnorm_init(d, device),
        "ln2": rmsnorm_init(d, device),
        "attn": attn_init(gen, cfg, device),
        "ffn": ffn_init(gen, d, cfg.d_ff, cfg.act, device),
    }


def block_apply(p, cfg: ArchConfig, x, positions=None):
    """Full-sequence layer application; ``positions`` (B, S) feed RoPE
    (RWKV6 reads none)."""
    _check_ported(cfg)
    if cfg.rwkv:
        tm, _, _ = rwkv_time_mix(p["tm"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 head_dim=cfg.rwkv_head_dim)
        x = x + tm
        cm, _ = rwkv_channel_mix(p["cm"], rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x + cm
    x = x + attn_apply(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                       positions)
    return x + ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                         cfg.act)


def init_block_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     device=None) -> dict:
    """Per-layer decode state (zeros; stacked over layers by the caller).
    RWKV6: the WKV state and the token-shift carries, the carries in
    bfloat16 whatever ``cfg.dtype`` is, as in the JAX package;
    ``cache_len`` is not read. Dense: bfloat16 K and V caches of
    ``cache_len`` slots."""
    _check_ported(cfg)
    if cfg.rwkv:
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        return {
            "wkv": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32,
                               device=device),
            "tm_shift": torch.zeros((batch, 1, d), dtype=torch.bfloat16,
                                    device=device),
            "cm_shift": torch.zeros((batch, 1, d), dtype=torch.bfloat16,
                                    device=device),
        }
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def block_decode(p, cfg: ArchConfig, x, pos, cache):
    """One-token layer step. x: (B, 1, d); pos: (B,) absolute positions
    (RWKV6 reads none). Returns (x, new_cache)."""
    _check_ported(cfg)
    if cfg.rwkv:
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        tm, wkv, tshift = rwkv_time_mix(
            p["tm"], h, head_dim=cfg.rwkv_head_dim, wkv_state=cache["wkv"],
            shift_state=cache["tm_shift"].to(h.dtype))
        x = x + tm
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        cm, cshift = rwkv_channel_mix(
            p["cm"], h, shift_state=cache["cm_shift"].to(h.dtype))
        x = x + cm
        return x, {"wkv": wkv, "tm_shift": tshift.to(torch.bfloat16),
                   "cm_shift": cshift.to(torch.bfloat16)}

    cache_len = cache["k"].shape[1]
    idx = torch.arange(cache_len, device=x.device)[None, :]
    if cfg.window is not None and cache_len <= cfg.window:
        # ring buffer (SWA): slot j holds the latest position p <= pos with
        # p % cache_len == j, within the window by construction
        slot = pos % cache_len
        valid = idx <= torch.clamp(pos[:, None], max=cache_len - 1)
    else:
        slot = pos
        valid = idx <= pos[:, None]
        if cfg.window is not None:
            valid &= idx > (pos[:, None] - cfg.window)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, k_c, v_c = attn_decode(p["attn"], cfg, h, pos, cache["k"],
                                     cache["v"], slot, valid)
    x = x + attn_out
    x = x + ffn_apply(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return x, {"k": k_c, "v": v_c}
