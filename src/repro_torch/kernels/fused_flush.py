"""Fused TGN message flush on the card: wrapper of the CUDA kernel in
``csrc/fused_flush.cu``, which replaces the TPU kernel
``repro/kernels/fused_flush.py:_flush_kernel``. Its plain version is
``ref.flush_ref``.

The forward writes into fresh copies of ``mem`` and ``last`` (out of
place), so the saved inputs stay intact for the backward; updating in
place (``mark_dirty``, or saving only the touched rows) is later work. The
backward recomputes ``ref.flush_ref`` under autograd from the saved
inputs, as the JAX package differentiates through its oracle
(``repro/kernels/ops.py:196``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["fused_flush_fwd", "FusedFlush"]


def fused_flush_fwd(ids, msg, ts, mem, last, wx, wh, bx, bh):
    """Segment-mean + GRU + mem/last scatter. ids: (R,) int32 in [0, N]
    (N = padding); msg: (R, dm); ts: (R,); mem: (N+1, d); last: (N+1,);
    wx: (dm, 3d); wh: (d, 3d); bx, bh: (3d,), all float32 on one card.
    Returns new ``(mem', last', mbar)``."""
    dev = msg.device
    rows, dm = msg.shape if msg.dim() == 2 else (-1, -1)
    n1, d = mem.shape if mem.dim() == 2 else (-1, -1)
    f32 = torch.float32
    check("msg", msg, f32, (rows, dm), dev)
    check("ids", ids, torch.int32, (rows,), dev)
    check("ts", ts, f32, (rows,), dev)
    check("mem", mem, f32, (n1, d), dev)
    check("last", last, f32, (n1,), dev)
    check("wx", wx, f32, (dm, 3 * d), dev)
    check("wh", wh, f32, (d, 3 * d), dev)
    check("bx", bx, f32, (3 * d,), dev)
    check("bh", bh, f32, (3 * d,), dev)
    mem_out = mem.clone()
    last_out = last.clone()
    mbar = torch.empty_like(msg)
    KERNELS["fused_flush"](
        ids.data_ptr(), msg.data_ptr(), ts.data_ptr(), mem.data_ptr(),
        last.data_ptr(), wx.data_ptr(), wh.data_ptr(), bx.data_ptr(),
        bh.data_ptr(), rows, dm, d, n1 - 1, mem_out.data_ptr(),
        last_out.data_ptr(), mbar.data_ptr(), stream(dev))
    return mem_out, last_out, mbar


# inputs of flush_ref that get a gradient: msg, wx, wh, bx, bh
_DIFF = (1, 5, 6, 7, 8)


class FusedFlush(torch.autograd.Function):
    """The flush kernel with the gradient of ``ref.flush_ref`` for
    ``msg, wx, wh, bx, bh``; ``ids, ts, mem, last`` are constants of the
    step (the model's carried state) and get none."""

    @staticmethod
    def forward(ctx, ids, msg, ts, mem, last, wx, wh, bx, bh):
        if any(ctx.needs_input_grad[i] for i in (2, 3, 4)):
            raise NotImplementedError(
                "fused_flush: ts, mem and last are step constants; detach "
                "them before the call")
        ctx.save_for_backward(ids, msg, ts, mem, last, wx, wh, bx, bh)
        mem_out, last_out, mbar = fused_flush_fwd(ids, msg, ts, mem, last,
                                                  wx, wh, bx, bh)
        ctx.mark_non_differentiable(last_out)
        return mem_out, last_out, mbar

    @staticmethod
    def backward(ctx, g_mem, _g_last, g_mbar):
        saved = list(ctx.saved_tensors)
        want = [i for i in _DIFF if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            for i in want:
                saved[i] = saved[i].detach().requires_grad_()
            mem_out, _last, mbar = ref.flush_ref(*saved)
            # mbar depends on msg alone: without a msg gradient it is a
            # constant and drops out
            pairs = [(o, g) for o, g in ((mem_out, g_mem), (mbar, g_mbar))
                     if o.requires_grad]
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [saved[i] for i in want],
                [g for _, g in pairs], allow_unused=True)
        out = [None] * 9
        for i, gr in zip(want, grads):
            out[i] = gr
        return tuple(out)
