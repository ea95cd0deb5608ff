"""The GRU cell on the card: wrappers of the CUDA kernels in
``csrc/fused_gru.cu``, which replace the TPU kernels
``repro/kernels/fused_gru.py:_gru_kernel`` (forward) and
``:_gru_bwd_kernel`` (backward), joined in one ``autograd.Function``.
Their plain versions are ``ref.gru_ref`` and ``ref.gru_bwd_ref`` (autograd
through it). Nothing is padded: the JAX package's 128-lane padding
(``repro/kernels/ops.py:gru``) is a TPU layout choice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["fused_gru_fwd", "fused_gru_bwd", "FusedGRU"]


def _check_inputs(x, h, wx, wh, bx, bh):
    dev = x.device
    rows, d_in = x.shape if x.dim() == 2 else (-1, -1)
    d_h = h.shape[-1] if h.dim() == 2 else -1
    f32 = torch.float32
    check("x", x, f32, (rows, d_in), dev)
    check("h", h, f32, (rows, d_h), dev)
    check("wx", wx, f32, (d_in, 3 * d_h), dev)
    check("wh", wh, f32, (d_h, 3 * d_h), dev)
    check("bx", bx, f32, (3 * d_h,), dev)
    check("bh", bh, f32, (3 * d_h,), dev)
    return rows, d_in, d_h


def fused_gru_fwd(x, h, wx, wh, bx, bh):
    """h' = GRU(x, h). x: (B, d_in), h: (B, d_h), wx: (d_in, 3 d_h),
    wh: (d_h, 3 d_h), bx, bh: (3 d_h,), float32, contiguous, on one card;
    gates [r | z | n]."""
    rows, d_in, d_h = _check_inputs(x, h, wx, wh, bx, bh)
    out = torch.empty_like(h)
    KERNELS["fused_gru"](x.data_ptr(), h.data_ptr(), wx.data_ptr(),
                         wh.data_ptr(), bx.data_ptr(), bh.data_ptr(), rows,
                         d_in, d_h, out.data_ptr(), stream(x.device))
    return out


def fused_gru_bwd(g, x, h, wx, wh, bx, bh):
    """``(dx, dh, dwx, dwh, dbx, dbh)`` from the output cotangent ``g``
    (B, d_h) and the forward's inputs; the gates are recomputed."""
    rows, d_in, d_h = _check_inputs(x, h, wx, wh, bx, bh)
    check("g", g, torch.float32, (rows, d_h), x.device)
    dgx = torch.empty((rows, 3 * d_h), dtype=torch.float32, device=x.device)
    dgh = torch.empty_like(dgx)
    dx, dh = torch.empty_like(x), torch.empty_like(h)
    dwx, dwh = torch.empty_like(wx), torch.empty_like(wh)
    dbx, dbh = torch.empty_like(bx), torch.empty_like(bh)
    KERNELS["fused_gru_bwd"](
        g.data_ptr(), x.data_ptr(), h.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), bx.data_ptr(), bh.data_ptr(), rows, d_in, d_h,
        dgx.data_ptr(), dgh.data_ptr(), dx.data_ptr(), dh.data_ptr(),
        dwx.data_ptr(), dwh.data_ptr(), dbx.data_ptr(), dbh.data_ptr(),
        stream(x.device))
    return dx, dh, dwx, dwh, dbx, dbh


class FusedGRU(torch.autograd.Function):
    """Forward and backward kernels; nothing but the inputs is saved."""

    @staticmethod
    def forward(ctx, x, h, wx, wh, bx, bh):
        ctx.save_for_backward(x, h, wx, wh, bx, bh)
        return fused_gru_fwd(x, h, wx, wh, bx, bh)

    @staticmethod
    def backward(ctx, g):
        return fused_gru_bwd(g.contiguous(), *ctx.saved_tensors)
