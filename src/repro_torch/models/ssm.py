"""Mamba-style selective SSM (hymba's parallel SSM heads), as
``repro/models/ssm.py``.

A diagonal state space with input-dependent (selective) discretization:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t
    y_t = C_t . h_t + D x_t

A (d_inner, n) is the negative exponential of a learned log; B_t, C_t and
dt_t come from the input. The scan over tokens is ``ops.selective_scan``
(the CUDA kernel on the card, ``ref.selective_scan_ref`` on the CPU); the
state is (B, d_inner, n) float32. Decode is the same function at S 1 from
the carried conv and SSM states.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (causal_conv1d, draw, linear,
                                       linear_init)

__all__ = ["mamba_init", "mamba_apply", "mamba_decode_step"]


def mamba_init(gen: torch.Generator, d: int, *, state: int, conv: int,
               expand: int, device=None) -> dict:
    """The JAX package's keys and constants (``a_log = log(1..n)`` for
    every channel, ``dt_proj/b`` = -4.6 = softplus^-1(0.01), ``d_skip`` 1,
    ``conv_b`` 0); the random leaves drawn from ``gen``."""
    di = expand * d
    dt_rank = max(16, d // 16)
    a = torch.arange(1, state + 1, dtype=torch.float32).repeat(di, 1)
    return {
        "in_proj": linear_init(gen, d, 2 * di, device=device),
        "conv_w": draw(gen, (di, conv), conv ** -0.5, device),
        "conv_b": torch.zeros(di, dtype=torch.float32, device=device),
        "x_proj": linear_init(gen, di, dt_rank + 2 * state, device=device),
        "dt_proj": {
            "w": draw(gen, (dt_rank, di), dt_rank ** -0.5, device),
            "b": torch.full((di,), -4.6, dtype=torch.float32, device=device),
        },
        "a_log": torch.log(a).to(device),
        "d_skip": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": linear_init(gen, di, d, scale=di ** -0.5, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    each op in x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(p, xc, state_dim: int, dt_rank: int):
    """Project the conv output to (dt, B, C)."""
    proj = linear(p["x_proj"], xc)                       # (..., r + 2n)
    dt_low = proj[..., :dt_rank]
    b = proj[..., dt_rank: dt_rank + state_dim]
    c = proj[..., dt_rank + state_dim:]
    dt = _softplus(dt_low @ p["dt_proj"]["w"].to(xc.dtype)
                   + p["dt_proj"]["b"].to(xc.dtype))     # (..., di)
    return dt, b, c


def mamba_apply(p: dict, x: torch.Tensor, *, state: int,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """x: (B, S, d) -> y (B, S, d), and with ``return_state`` also
    (conv_state (B, K - 1, di) in x's dtype, ssm_state (B, di, n)
    float32). ``conv_state`` and ``ssm_state`` default to zeros."""
    dt_rank = p["dt_proj"]["w"].shape[0]
    xz = linear(p["in_proj"], x)                         # (B, S, 2 di)
    xr, z = xz.chunk(2, dim=-1)
    xc, conv_state = causal_conv1d(xr, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dt, bmat, cmat = _ssm_params(p, xc, state, dt_rank)
    a = -torch.exp(p["a_log"]).float()                   # (di, n)
    y, ssm_state = ops.selective_scan(xc, dt, bmat, cmat, a,
                                      state=ssm_state)
    y = y + xc * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = linear(p["out_proj"], y)
    if return_state:
        return out, (conv_state, ssm_state)
    return out


def mamba_decode_step(p: dict, x: torch.Tensor, conv_state, ssm_state, *,
                      state: int):
    """One token. x: (B, 1, d) -> (y (B, 1, d), (conv_state, ssm_state))."""
    return mamba_apply(p, x, state=state, conv_state=conv_state,
                       ssm_state=ssm_state, return_state=True)
