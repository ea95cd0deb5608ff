"""Linear layers and RMSNorm, as ``repro/models/layers.py``: params are
stored in float32 and cast to the activations' dtype on every call; the
norm works in float32 and casts back."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["linear_init", "linear", "rmsnorm_init", "rmsnorm", "draw"]


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
