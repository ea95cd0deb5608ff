"""Building blocks, as ``repro/models/layers.py``: linear layers and
RMSNorm (params stored in float32 and cast to the activations' dtype on
every call; the norm works in float32 and casts back), RoPE, M-RoPE,
the sinusoid table, the FFN (plain or gated), single-token attention
against a KV cache and mamba's depthwise causal convolution.
Activations are (B, S, ...), attention heads (B, S, H, Dh). Full-sequence
attention is the flash attention op
(``repro_torch.kernels.ops.flash_attention``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["linear_init", "linear", "rmsnorm_init", "rmsnorm", "draw",
           "rope_freqs", "apply_rope", "apply_mrope",
           "sinusoidal_positions", "ffn_init", "ffn_apply",
           "decode_attention", "causal_conv1d"]


def draw(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """Standard normal float32 draws times ``scale``, made on ``gen``'s
    device and moved to ``device``; on the ``meta`` device (the dry run's
    params: shapes only, the counterpart of ``jax.eval_shape``) an empty
    tensor, with nothing drawn."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return x.to(device)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                scale: Optional[float] = None, device=None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": draw(gen, (d_in, d_out), scale, device)}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype)


def rmsnorm_init(d: int, device=None) -> dict:
    return {"g": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"]).to(x.dtype)


# -------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim / 2,), float32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., H, Dh) with angles (..., Dh/2) broadcast over H; cos and
    sin are cast to x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    return _rotate(x, positions[..., None].float() * inv_freq)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                inv_freq: torch.Tensor, sections) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the frequency ladder split into
    per-axis sections (t, h, w), each rotating by its own position
    stream. x: (B, S, H, Dh); positions3: (B, 3, S) int; ``sections``
    sums to Dh / 2. With three equal streams it is ``apply_rope``."""
    if sum(sections) != inv_freq.shape[0]:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"{inv_freq.shape[0]} frequencies")
    parts, off = [], 0
    for axis, sec in enumerate(sections):
        parts.append(positions3[:, axis, :, None].float()
                     * inv_freq[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(parts, dim=-1))


def sinusoidal_positions(s: int, d: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """The classic sin / cos table (s, d), float32: position p, column i <
    d / 2 sin(p / 10000^(2 i / d)), column d / 2 + i its cos."""
    pos = torch.arange(offset, offset + s, dtype=torch.float32,
                       device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------- FFN

def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The FFN activation: SiLU for ``swiglu``, tanh-approximated GELU for
    ``geglu`` and ``gelu`` (as ``jax.nn.gelu(approximate=True)``), squared
    ReLU for ``relu_sq``."""
    if name == "swiglu":
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(name)


def ffn_init(gen: torch.Generator, d: int, d_ff: int, act: str,
             device=None) -> dict:
    """``wi`` and ``wo``, and for the gated activations (``swiglu``,
    ``geglu``) the gate ``wg``."""
    p = {"wi": linear_init(gen, d, d_ff, device=device)}
    if act in ("swiglu", "geglu"):
        p["wg"] = linear_init(gen, d, d_ff, device=device)
    p["wo"] = linear_init(gen, d_ff, d, scale=d_ff ** -0.5, device=device)
    return p


def ffn_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = _act(act, linear(p["wi"], x))
    if "wg" in p:                      # gated variants
        h = h * linear(p["wg"], x)
    return linear(p["wo"], h)


# -------------------------------------------------------------- attention

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """One new token per sequence against a KV cache, GQA in kv-major
    order (head h reads KV head h // G). q: (B, H, Dh); k_cache, v_cache:
    (B, S, Hkv, Dh), cast to q's dtype; valid: (B, S) bool, the live
    slots. Masked with -1e30, softmax in float32, the rest in q's dtype."""
    b, h, dh = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg,
                          k_cache.to(q.dtype)) * (dh ** -0.5)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    att = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", att, v_cache.to(q.dtype))
    return out.reshape(b, h, dh)


# ------------------------------------------------------------------ conv1d

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution (mamba's local mixing), formed as the
    JAX package forms it: the state and x concatenated, the K-wide
    windows gathered, one einsum in x's dtype.

    x: (B, S, D); w: (D, K); b: (D,); state: None (zeros) or the last K - 1
    inputs (B, K - 1, D) in x's dtype. Returns (y (B, S, D), new_state, the
    last K - 1 rows of the concatenation)."""
    bsz, s, d = x.shape
    kk = w.shape[1]
    if state is None:
        state = x.new_zeros((bsz, kk - 1, d))
    xp = torch.cat([state, x], dim=1)                   # (B, S+K-1, D)
    idx = (torch.arange(s, device=x.device)[:, None]
           + torch.arange(kk, device=x.device)[None, :])
    windows = xp[:, idx, :]                             # (B, S, K, D)
    y = torch.einsum("bskd,dk->bsd", windows, w.to(x.dtype)) + b.to(x.dtype)
    new_state = xp[:, -(kk - 1):, :] if kk > 1 else state
    return y, new_state
