"""RWKV6 (Finch) blocks: time-mix (the WKV attention substitute) and
channel-mix, as ``repro/models/rwkv.py``.

The token-shift interpolation weights are per-channel learned constants,
with a low-rank data-dependent term only for the decay w (the JAX
package's simplification of the paper's ddlerp). The WKV core goes through
``repro_torch.kernels.ops.rwkv6``: the CUDA kernel for tensors on the
card, the plain chunked version on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (draw, linear, linear_init, rmsnorm,
                                       rmsnorm_init)

__all__ = ["rwkv_block_init", "rwkv_time_mix", "rwkv_channel_mix"]


def rwkv_block_init(gen: torch.Generator, d: int, d_ff: int, head_dim: int,
                    device=None) -> dict:
    n_heads = d // head_dim
    lora = max(32, d // 32)

    def full(value):
        return torch.full((d,), value, dtype=torch.float32, device=device)

    return {
        "tm": {
            "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
            "mix_w": full(0.5), "mix_g": full(0.5),
            "wr": linear_init(gen, d, d, device=device),
            "wk": linear_init(gen, d, d, device=device),
            "wv": linear_init(gen, d, d, device=device),
            "wg": linear_init(gen, d, d, device=device),
            "wo": linear_init(gen, d, d, device=device),
            # decay: w = exp(-exp(w0 + tanh(x A) B))  (data-dependent, LoRA)
            "w0": full(-1.8),
            "w_lora_a": draw(gen, (d, lora), 0.01, device),
            "w_lora_b": torch.zeros((lora, d), dtype=torch.float32,
                                    device=device),
            "u": draw(gen, (n_heads, head_dim), 0.1, device),
            "ln_x": rmsnorm_init(d, device),    # per-head group norm stand-in
        },
        "cm": {
            "mix_k": full(0.5), "mix_r": full(0.5),
            "wk": linear_init(gen, d, d_ff, device=device),
            "wv": linear_init(gen, d_ff, d, scale=d_ff ** -0.5,
                              device=device),
            "wr": linear_init(gen, d, d, device=device),
        },
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """xx_t = x_{t-1}; returns (xx, new_prev) with prev the (B, 1, d)
    carry."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    xx = torch.cat([prev, x[:, :-1]], dim=1)
    return xx, x[:, -1:]


def rwkv_time_mix(p: dict, x: torch.Tensor, *, head_dim: int,
                  wkv_state: Optional[torch.Tensor] = None,
                  shift_state: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> (y, new_wkv_state, new_shift_state)."""
    b, s, d = x.shape
    h = d // head_dim
    xx, new_shift = _token_shift(x, shift_state)

    def mixed(name):
        m = p[f"mix_{name}"].to(x.dtype)
        return x + (xx - x) * m

    r = linear(p["wr"], mixed("r"))
    k = linear(p["wk"], mixed("k"))
    v = linear(p["wv"], mixed("v"))
    g = linear(p["wg"], mixed("g"))
    xw = mixed("w")
    w_log = p["w0"].to(x.dtype) + torch.tanh(
        xw @ p["w_lora_a"].to(x.dtype)) @ p["w_lora_b"].to(x.dtype)
    w = torch.exp(-torch.exp(w_log.float()))               # (B,S,d) in (0,1)

    def heads(t):  # (B,S,d) -> (B,S,H,Dh), a view
        return t.view(b, s, h, head_dim)

    o, new_state = ops.rwkv6(heads(r), heads(k), heads(v), heads(w),
                             p["u"], state=wkv_state, return_state=True)
    o = o.reshape(b, s, d).to(x.dtype)
    o = rmsnorm(p["ln_x"], o)
    o = o * (g * torch.sigmoid(g))                         # silu
    return linear(p["wo"], o), new_state, new_shift


def rwkv_channel_mix(p: dict, x: torch.Tensor, *,
                     shift_state: Optional[torch.Tensor] = None):
    """Squared-ReLU channel mixing. Returns (y, new_shift_state)."""
    xx, new_shift = _token_shift(x, shift_state)
    xk = x + (xx - x) * p["mix_k"].to(x.dtype)
    xr = x + (xx - x) * p["mix_r"].to(x.dtype)
    kk = torch.square(torch.relu(linear(p["wk"], xk)))
    return torch.sigmoid(linear(p["wr"], xr)) * linear(p["wv"], kk), \
        new_shift
