"""Building blocks, as ``repro/models/layers.py``: linear layers and
RMSNorm (params stored in float32 and cast to the activations' dtype on
every call; the norm works in float32 and casts back), RoPE, the FFN and
single-token attention against a KV cache. Activations are (B, S, ...),
attention heads (B, S, H, Dh). Full-sequence attention is the flash
attention op (``repro_torch.kernels.ops.flash_attention``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["linear_init", "linear", "rmsnorm_init", "rmsnorm", "draw",
           "rope_freqs", "apply_rope", "ffn_init", "ffn_apply",
           "decode_attention"]


def draw(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """Standard normal float32 draws times ``scale``, made on ``gen``'s
    device and moved to ``device``."""
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


# --------------------------------------------------------------------- FFN

def _only_gelu(act: str) -> None:
    if act != "gelu":
        raise NotImplementedError(
            f"FFN activation {act!r}: the port has the ungated GELU FFN "
            f"(act='gelu') so far; the others come with their families "
            f"(ROADMAP Queue 1)")


def ffn_init(gen: torch.Generator, d: int, d_ff: int, act: str,
             device=None) -> dict:
    _only_gelu(act)
    return {"wi": linear_init(gen, d, d_ff, device=device),
            "wo": linear_init(gen, d_ff, d, scale=d_ff ** -0.5,
                              device=device)}


def ffn_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    _only_gelu(act)
    return linear(p["wo"], F.gelu(linear(p["wi"], x), approximate="tanh"))


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
