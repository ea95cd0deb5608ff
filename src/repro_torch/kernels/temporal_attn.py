"""Temporal neighbor attention on the card: wrappers of the CUDA kernels
in ``csrc/temporal_attn.cu``, which replace the TPU kernels
``repro/kernels/temporal_attn.py:_attn_kernel`` (forward) and
``:_attn_bwd_kernel`` (backward), joined in one ``autograd.Function``.
Their plain version is ``ref.temporal_attention_ref`` and its autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["temporal_attn_fwd", "temporal_attn_bwd", "TemporalAttention",
           "GROUP"]

# Lanes that share one (slot, head) dot product in the kernels (ATTN_GROUP
# in csrc/temporal_attn.cu): lane l sums columns l, l + GROUP, ... and a
# butterfly of shuffles combines them. The CPU emulation of the kernels'
# arithmetic order reads it; change both together.
GROUP = 4


def _check_inputs(q, k, v, mask):
    dev = q.device
    b, h, d = q.shape if q.dim() == 3 else (-1, -1, -1)
    kn = k.shape[1] if k.dim() == 4 else -1
    check("q", q, torch.float32, (b, h, d), dev)
    check("k", k, torch.float32, (b, kn, h, d), dev)
    check("v", v, torch.float32, (b, kn, h, d), dev)
    check("mask", mask, torch.bool, (b, kn), dev)
    return b, h, kn, d


def temporal_attn_fwd(q, k, v, mask):
    """q: (B, H, D); k, v: (B, K, H, D) float32; mask: (B, K) bool, all
    contiguous on one card -> (B, H, D)."""
    b, h, kn, d = _check_inputs(q, k, v, mask)
    out = torch.empty_like(q)
    KERNELS["temporal_attn"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             mask.data_ptr(), b, h, kn, d, out.data_ptr(),
                             stream(q.device))
    return out


def temporal_attn_bwd(g, q, k, v, mask):
    """(dq, dk, dv) from the output cotangent ``g`` (B, H, D) and the
    forward inputs; the softmax is recomputed in the kernel."""
    b, h, kn, d = _check_inputs(q, k, v, mask)
    check("g", g, torch.float32, (b, h, d), q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    KERNELS["temporal_attn_bwd"](
        g.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), b, h, kn, d, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stream(q.device))
    return dq, dk, dv


class TemporalAttention(torch.autograd.Function):
    """Forward and backward kernels; nothing but the inputs is saved."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return temporal_attn_fwd(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = temporal_attn_bwd(g.contiguous(), q, k, v, mask)
        return dq, dk, dv, None
