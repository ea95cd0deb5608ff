"""Per-family blocks, as ``repro/models/transformer.py``: the RWKV6
family, the dense attention family (GQA, RoPE, optional sliding window,
optional qk-norm, plain or gated FFN), the decoder-only MoE family (the
same attention, a ``moe_apply`` FFN), hymba's hybrid family (the same
attention and, in parallel on the same normed input, mamba's SSM heads,
their RMS-normed outputs averaged; its decode cache adds the conv and
SSM states), the encoder-decoder family (non-causal encoder blocks, and
decoder blocks with cross-attention over the encoder memory, no rotary
positions; its decode cache adds the memory's K and V) and the
vision-language family (M-RoPE over three position streams). The port
runs on one card, so nothing is padded for tensor parallelism.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_mrope, apply_rope,
                                       decode_attention, ffn_apply, ffn_init,
                                       linear, linear_init, rmsnorm,
                                       rmsnorm_init, rope_freqs)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.rwkv import (rwkv_block_init, rwkv_channel_mix,
                                     rwkv_time_mix)
from repro_torch.models.ssm import mamba_apply, mamba_decode_step, mamba_init

__all__ = ["attn_init", "project_kv", "attn_apply", "attn_decode",
           "block_init", "block_apply", "block_decode", "init_block_cache"]


# ------------------------------------------------------------ attention

def attn_init(gen: torch.Generator, cfg: ArchConfig, device=None, *,
              cross: bool = False) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo``; with ``qk_norm`` the per-head
    RMSNorm gains ``qn`` and ``kn`` (Dh,), but not in cross-attention."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": linear_init(gen, d, cfg.n_heads * dh, device=device),
        "wk": linear_init(gen, d, cfg.n_kv_heads * dh, device=device),
        "wv": linear_init(gen, d, cfg.n_kv_heads * dh, device=device),
        "wo": linear_init(gen, cfg.n_heads * dh, d,
                          scale=(cfg.n_heads * dh) ** -0.5, device=device),
    }
    if cfg.qk_norm and not cross:
        p["qn"] = rmsnorm_init(dh, device)
        p["kn"] = rmsnorm_init(dh, device)
    return p


def project_kv(p, cfg: ArchConfig, kv_x):
    """k, v (B, Sk, Hkv, Dh) of ``kv_x`` (B, Sk, d), before qk-norm and
    rotation: all of cross-attention's K and V."""
    b, sk, _ = kv_x.shape
    dh = cfg.resolved_head_dim
    return (linear(p["wk"], kv_x).view(b, sk, cfg.n_kv_heads, dh),
            linear(p["wv"], kv_x).view(b, sk, cfg.n_kv_heads, dh))


def _project_qkv(p, cfg: ArchConfig, x, positions, kv_x=None):
    """x: (B, S, d); positions: None, (B, S), or (B, 3, S) for M-RoPE;
    k and v from ``kv_x`` (B, Sk, d), x if None. Returns q (B, S, H, Dh)
    and k, v (B, Sk, Hkv, Dh): q and k RMS-normed over each head
    (qk-norm) and then rotated: RoPE (``rope="rope"``) or M-RoPE
    (``"mrope"``; 2-D positions are the same stream on all three axes),
    none with ``rope="none"`` or no positions."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], x).view(b, s, cfg.n_heads, dh)
    k, v = project_kv(p, cfg, x if kv_x is None else kv_x)
    if "qn" in p:
        q = rmsnorm(p["qn"], q, cfg.norm_eps)
        k = rmsnorm(p["kn"], k, cfg.norm_eps)
    if positions is None or cfg.rope not in ("rope", "mrope"):
        return q, k, v
    freqs = rope_freqs(dh, cfg.rope_theta, x.device)
    if cfg.rope == "rope":
        return (apply_rope(q, positions, freqs),
                apply_rope(k, positions, freqs), v)
    if positions.dim() == 2:
        positions = positions[:, None, :].expand(-1, 3, -1)
    sections = tuple(cfg.mrope_sections)
    return (apply_mrope(q, positions, freqs, sections),
            apply_mrope(k, positions, freqs, sections), v)


def attn_apply(p, cfg: ArchConfig, x, positions, *, causal: bool = True,
               kv_x=None):
    """Full-sequence attention through the flash attention op (the CUDA
    kernel on the card): self-attention, causal or not (an encoder),
    with the config's window; or, given ``kv_x`` (B, Sk, d),
    cross-attention of x's rows over it, non-causal, no window, no
    rotation, K and V cast to q's dtype (the encoder memory is bfloat16
    whatever the decoder computes in; the cast is exact)."""
    b, s, _ = x.shape
    if kv_x is not None:
        q, k, v = _project_qkv(p, cfg, x, None, kv_x=kv_x)
        ctx = ops.flash_attention(q, k.to(q.dtype), v.to(q.dtype),
                                  causal=False)
    else:
        q, k, v = _project_qkv(p, cfg, x, positions)
        ctx = ops.flash_attention(q, k, v, causal=causal, window=cfg.window)
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
               cross: bool = False, device=None) -> dict:
    """One layer's params; ``cross`` (an encoder-decoder's decoder layer)
    adds ``ln_cross`` and the cross-attention ``cross``."""
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
    if cross:
        p["ln_cross"] = rmsnorm_init(d, device)
        p["cross"] = attn_init(gen, cfg, device, cross=True)
    return p


def _fuse(p, cfg: ArchConfig, attn_out, ssm_out):
    """Hymba's head fusion: the mean of the RMS-normed attention and SSM
    outputs."""
    return 0.5 * (rmsnorm(p["ln_attn_out"], attn_out, cfg.norm_eps)
                  + rmsnorm(p["ln_ssm_out"], ssm_out, cfg.norm_eps))


def block_apply(p, cfg: ArchConfig, x, positions=None, *, enc_out=None,
                causal: bool = True):
    """Full-sequence layer application; ``positions`` (B, S), or (B, 3,
    S) for M-RoPE, feed the rotation (RWKV6 reads none); ``causal=False``
    for an encoder layer; a decoder layer with ``cross`` params attends
    over ``enc_out`` (B, S_enc, d) after its self-attention. Returns (x,
    aux): the MoE router's aux loss, a float32 zero for the other
    families."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.rwkv:
        tm, _, _ = rwkv_time_mix(p["tm"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 head_dim=cfg.rwkv_head_dim)
        x = x + tm
        cm, _ = rwkv_channel_mix(p["cm"], rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x + cm, aux
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out = attn_apply(p["attn"], cfg, h, positions, causal=causal)
    if cfg.ssm_state:
        attn_out = _fuse(p, cfg, attn_out,
                         mamba_apply(p["ssm"], h, state=cfg.ssm_state))
    x = x + attn_out
    if enc_out is not None and "cross" in p:
        h = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + attn_apply(p["cross"], cfg, h, None, kv_x=enc_out)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        b, s, d = h.shape
        y, aux = moe_apply(p["moe"], h.reshape(b * s, d), top_k=cfg.top_k,
                           act=cfg.act,
                           capacity_factor=cfg.capacity_factor)
        return x + y.view(b, s, d), aux
    return x + ffn_apply(p["ffn"], h, cfg.act), aux


def init_block_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     device=None, enc_len: int = 0) -> dict:
    """Per-layer decode state (zeros; stacked over layers by the caller).
    RWKV6: the WKV state and the token-shift carries, the carries in
    bfloat16 whatever ``cfg.dtype`` is, as in the JAX package;
    ``cache_len`` is not read. Dense: bfloat16 K and V caches of
    ``cache_len`` slots; hybrid also the conv state (B, K - 1, d_inner)
    in bfloat16 and the SSM state (B, d_inner, n) in float32;
    encoder-decoder with ``enc_len`` also the encoder memory's K and V
    (``enc_k``, ``enc_v``: (B, enc_len, Hkv, Dh) bfloat16, written by
    ``model.fill_enc_cache``), as in the JAX package. Without
    ``enc_len`` the decoder's steps skip cross-attention, as the JAX
    package's do."""
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
    if cfg.enc_dec and enc_len:
        enc = (batch, enc_len) + shape[2:]
        c["enc_k"] = torch.zeros(enc, dtype=torch.bfloat16, device=device)
        c["enc_v"] = torch.zeros(enc, dtype=torch.bfloat16, device=device)
    if cfg.ssm_state:
        di = cfg.ssm_expand * cfg.d_model
        c["conv"] = torch.zeros((batch, cfg.ssm_conv - 1, di),
                                dtype=torch.bfloat16, device=device)
        c["ssm"] = torch.zeros((batch, di, cfg.ssm_state),
                               dtype=torch.float32, device=device)
    return c


def block_decode(p, cfg: ArchConfig, x, pos, cache):
    """One-token layer step. x: (B, 1, d); pos: (B,) absolute positions
    (RWKV6 reads none). A decoder layer with ``cross`` params attends over
    the cache's ``enc_k`` / ``enc_v`` where it has them, which it returns
    unchanged. Returns (x, new_cache)."""
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
    new_cache = {**cache, "k": k_c, "v": v_c}
    if cfg.ssm_state:
        ssm_out, (conv_s, ssm_s) = mamba_decode_step(
            p["ssm"], h, cache["conv"].to(h.dtype), cache["ssm"],
            state=cfg.ssm_state)
        new_cache["conv"] = conv_s.to(torch.bfloat16)
        new_cache["ssm"] = ssm_s
        attn_out = _fuse(p, cfg, attn_out, ssm_out)
    x = x + attn_out
    if "cross" in p and "enc_k" in cache:
        b = x.shape[0]
        h = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        q = linear(p["cross"]["wq"], h).view(b, cfg.n_heads, -1)
        every = torch.ones(cache["enc_k"].shape[:2], dtype=torch.bool,
                           device=x.device)
        out = decode_attention(q, cache["enc_k"].to(h.dtype),
                               cache["enc_v"].to(h.dtype), every)
        x = x + linear(p["cross"]["wo"], out.reshape(b, 1, -1))
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
