"""Per-family blocks, as ``repro/models/transformer.py``; so far the RWKV6
family, the dense attention family (GQA, RoPE, optional sliding window,
optional qk-norm, plain or gated FFN), the decoder-only MoE family (the
same attention, a ``moe_apply`` FFN) and hymba's hybrid family (the same
attention and, in parallel on the same normed input, mamba's SSM heads,
their RMS-normed outputs averaged; its decode cache adds the conv and
SSM states). The encoder-decoder and vision-language families raise
``NotImplementedError``: they are ROADMAP Queue 1 ("the rest of the LM
substrate"). The port runs on one card, so nothing is padded for tensor
parallelism.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       ffn_apply, ffn_init, linear,
                                       linear_init, rmsnorm, rmsnorm_init,
                                       rope_freqs)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.rwkv import (rwkv_block_init, rwkv_channel_mix,
                                     rwkv_time_mix)
from repro_torch.models.ssm import mamba_apply, mamba_decode_step, mamba_init

__all__ = ["attn_init", "attn_apply", "attn_decode", "block_init",
           "block_apply", "block_decode", "init_block_cache"]


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.rwkv or (cfg.family in ("dense", "moe", "hybrid")
                    and cfg.rope == "rope"):
        return
    raise NotImplementedError(
        f"{cfg.name} ({cfg.family}, rope {cfg.rope!r}): the port has the "
        f"RWKV6 blocks and the dense, MoE and hybrid RoPE attention blocks "
        f"so far; the encoder-decoder and vision-language families are "
        f"ROADMAP Queue 1 (the rest of the LM substrate)")


# ------------------------------------------------------------ attention

def attn_init(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo``; with ``qk_norm`` the per-head
    RMSNorm gains ``qn`` and ``kn`` (Dh,)."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": linear_init(gen, d, cfg.n_heads * dh, device=device),
        "wk": linear_init(gen, d, cfg.n_kv_heads * dh, device=device),
        "wv": linear_init(gen, d, cfg.n_kv_heads * dh, device=device),
        "wo": linear_init(gen, cfg.n_heads * dh, d,
                          scale=(cfg.n_heads * dh) ** -0.5, device=device),
    }
    if cfg.qk_norm:
        p["qn"] = rmsnorm_init(dh, device)
        p["kn"] = rmsnorm_init(dh, device)
    return p


def _project_qkv(p, cfg: ArchConfig, x, positions):
    """x: (B, S, d); positions: (B, S). Returns q (B, S, H, Dh) and k, v
    (B, S, Hkv, Dh): q and k RMS-normed over each head (qk-norm) and then
    rotated (RoPE)."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], x).view(b, s, cfg.n_heads, dh)
    k = linear(p["wk"], x).view(b, s, cfg.n_kv_heads, dh)
    v = linear(p["wv"], x).view(b, s, cfg.n_kv_heads, dh)
    if "qn" in p:
        q = rmsnorm(p["qn"], q, cfg.norm_eps)
        k = rmsnorm(p["kn"], k, cfg.norm_eps)
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
    p = {
        "ln1": rmsnorm_init(d, device),
        "ln2": rmsnorm_init(d, device),
        "attn": attn_init(gen, cfg, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(gen, d, cfg.d_ff_expert, cfg.n_experts, cfg.act,
                            device)
    else:
        p["ffn"] = ffn_init(gen, d, cfg.d_ff, cfg.act, device)
    if cfg.ssm_state:           # hymba: parallel SSM heads
        p["ssm"] = mamba_init(gen, d, state=cfg.ssm_state,
                              conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                              device=device)
        p["ln_attn_out"] = rmsnorm_init(d, device)
        p["ln_ssm_out"] = rmsnorm_init(d, device)
    return p


def _fuse(p, cfg: ArchConfig, attn_out, ssm_out):
    """Hymba's head fusion: the mean of the RMS-normed attention and SSM
    outputs."""
    return 0.5 * (rmsnorm(p["ln_attn_out"], attn_out, cfg.norm_eps)
                  + rmsnorm(p["ln_ssm_out"], ssm_out, cfg.norm_eps))


def block_apply(p, cfg: ArchConfig, x, positions=None):
    """Full-sequence layer application; ``positions`` (B, S) feed RoPE
    (RWKV6 reads none). Returns (x, aux): the MoE router's aux loss, a
    float32 zero for the other families."""
    _check_ported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.rwkv:
        tm, _, _ = rwkv_time_mix(p["tm"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 head_dim=cfg.rwkv_head_dim)
        x = x + tm
        cm, _ = rwkv_channel_mix(p["cm"], rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x + cm, aux
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out = attn_apply(p["attn"], cfg, h, positions)
    if cfg.ssm_state:
        attn_out = _fuse(p, cfg, attn_out,
                         mamba_apply(p["ssm"], h, state=cfg.ssm_state))
    x = x + attn_out
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        b, s, d = h.shape
        y, aux = moe_apply(p["moe"], h.reshape(b * s, d), top_k=cfg.top_k,
                           act=cfg.act,
                           capacity_factor=cfg.capacity_factor)
        return x + y.view(b, s, d), aux
    return x + ffn_apply(p["ffn"], h, cfg.act), aux


def init_block_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     device=None) -> dict:
    """Per-layer decode state (zeros; stacked over layers by the caller).
    RWKV6: the WKV state and the token-shift carries, the carries in
    bfloat16 whatever ``cfg.dtype`` is, as in the JAX package;
    ``cache_len`` is not read. Dense: bfloat16 K and V caches of
    ``cache_len`` slots; hybrid also the conv state (B, K - 1, d_inner)
    in bfloat16 and the SSM state (B, d_inner, n) in float32, as in the
    JAX package."""
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
    c = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
         "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    if cfg.ssm_state:
        di = cfg.ssm_expand * cfg.d_model
        c["conv"] = torch.zeros((batch, cfg.ssm_conv - 1, di),
                                dtype=torch.bfloat16, device=device)
        c["ssm"] = torch.zeros((batch, di, cfg.ssm_state),
                               dtype=torch.float32, device=device)
    return c


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
    new_cache = {"k": k_c, "v": v_c}
    if cfg.ssm_state:
        ssm_out, (conv_s, ssm_s) = mamba_decode_step(
            p["ssm"], h, cache["conv"].to(h.dtype), cache["ssm"],
            state=cfg.ssm_state)
        new_cache["conv"] = conv_s.to(torch.bfloat16)
        new_cache["ssm"] = ssm_s
        attn_out = _fuse(p, cfg, attn_out, ssm_out)
    x = x + attn_out
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        # dropless while the decode batch is small (B k <= 4 E), else the
        # bounded decode capacity
        b = x.shape[0]
        dropless = b * cfg.top_k <= 4 * cfg.n_experts
        y, _ = moe_apply(p["moe"], h.reshape(b, -1), top_k=cfg.top_k,
                         act=cfg.act, dropless=dropless,
                         capacity_factor=cfg.decode_capacity_factor)
        x = x + y.view(b, 1, -1)
    else:
        x = x + ffn_apply(p["ffn"], h, cfg.act)
    return x, new_cache
