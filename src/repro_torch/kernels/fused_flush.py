"""Fused TGN message flush on the card: wrapper of the CUDA kernels in
``csrc/fused_flush.cu``, which replace the TPU kernel
``repro/kernels/fused_flush.py:_flush_kernel``. Its plain version is
``ref.flush_ref``.

The forward updates ``mem`` and ``last`` in place, as the JAX kernel does
(``input_output_aliases``): it writes the touched rows and nothing else.
So the backward cannot recompute ``flush_ref`` from a saved ``mem``; it
works from the R touched rows (``flush_bwd_rows``), with two residuals of
the forward: ``h_g``, the memory rows the GRU read, and ``orow``, the row
each pending row wrote (-1: none).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS
from repro_torch.kernels.fused_gru import fused_gru_bwd

__all__ = ["fused_flush_fwd", "flush_fwd_ref", "flush_bwd_rows",
           "first_rows", "FusedFlush"]


def fused_flush_fwd(ids, msg, ts, mem, last, wx, wh, bx, bh):
    """Segment-mean + GRU + update of the touched ``mem`` / ``last`` rows,
    IN PLACE. ids: (R,) int32 in [0, N] (N = padding); msg: (R, dm); ts:
    (R,); mem: (N+1, d); last: (N+1,); wx: (dm, 3d); wh: (d, 3d); bx, bh:
    (3d,), all float32 on one card.

    Writes ``mem`` and ``last`` as ``ref.flush_ref`` would return them and
    returns ``(mem, last, mbar, h_g, orow)``: the two inputs themselves,
    the (R, dm) aggregated messages, ``h_g = mem[ids]`` as it was before
    the update (R, d), and ``orow`` (R,) int32 (``first_rows``)."""
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
    mbar = torch.empty_like(msg)
    h_g = torch.empty((rows, d), dtype=f32, device=dev)
    orow = torch.empty((rows,), dtype=torch.int32, device=dev)
    KERNELS["fused_flush"](
        ids.data_ptr(), msg.data_ptr(), ts.data_ptr(), mem.data_ptr(),
        last.data_ptr(), wx.data_ptr(), wh.data_ptr(), bx.data_ptr(),
        bh.data_ptr(), rows, dm, d, n1 - 1, mbar.data_ptr(), h_g.data_ptr(),
        orow.data_ptr(), stream(dev))
    return mem, last, mbar, h_g, orow


def first_rows(ids, n_dump: int):
    """(R,) int32: ``ids[i]`` where row i is the first occurrence of a live
    id, else -1 (JAX's ``ids_w`` with -1 for the dump row)."""
    ids = ids.long()
    dup = torch.tril(ids[:, None] == ids[None, :], diagonal=-1).any(1)
    return torch.where((ids < n_dump) & ~dup, ids, -1).to(torch.int32)


@torch.no_grad()
def flush_fwd_ref(ids, msg, ts, mem, last, wx, wh, bx, bh):
    """The plain version of ``fused_flush_fwd``'s contract, on any
    device: ``ref.flush_ref``'s values written into the touched rows of
    ``mem`` / ``last`` and their dump rows, in place; the same return."""
    n_dump = mem.shape[0] - 1
    h_g = mem[ids.long()]
    orow = first_rows(ids, n_dump)
    new_mem, new_last, mbar = ref.flush_ref(ids, msg, ts, mem, last, wx, wh,
                                            bx, bh)
    w = torch.cat([orow[orow >= 0].long(),
                   torch.full((1,), n_dump, device=ids.device)])
    mem[w] = new_mem[w]
    last[w] = new_last[w]
    return mem, last, mbar, h_g, orow


def flush_bwd_rows(g_mem, g_mbar, ids, mbar, h_g, orow, wx, wh, bx, bh, *,
                   n_dump: int, need_msg: bool = True):
    """The flush's backward from the R touched rows: ``(d_msg, dwx, dwh,
    dbx, dbh)`` for the cotangents ``g_mem`` (N+1, d) of ``mem'`` and
    ``g_mbar`` (R, dm) of ``mbar`` (either may be None: zero), with the
    forward's ``mbar``, ``h_g`` and ``orow``. ``d_msg`` is None unless
    ``need_msg``.

    Only a first occurrence's row reaches ``mem'``, so the GRU's
    cotangent is ``g_mem[ids[i]]`` there and 0 elsewhere; the GRU backward
    (``fused_gru_bwd`` on a CUDA tensor, autograd of ``ref.gru_ref`` on a
    CPU one) gives ``d_mbar`` and the weight grads (``h`` is a step
    constant). The segment mean's backward is one product, ``d_msg = A
    (d_mbar + g_mbar)`` with ``A[i, j] = [ids_i == ids_j, both live] /
    cnt_j`` (R x R, symmetric). Nothing with N rows is read but the
    gather ``g_mem[ids]``."""
    long_ids = ids.long()
    if g_mem is None:
        g_s = torch.zeros_like(h_g)
    else:
        g_s = torch.where(orow[:, None] >= 0, g_mem[long_ids], 0.0)
    if g_s.device.type == "cuda":
        d_mbar, _dh, dwx, dwh, dbx, dbh = fused_gru_bwd(
            g_s.contiguous(), mbar, h_g, wx, wh, bx, bh)
    else:
        d_mbar, _dh, dwx, dwh, dbx, dbh = ref.gru_bwd_ref(
            g_s, mbar, h_g, wx, wh, bx, bh)
    d_msg = None
    if need_msg:
        live = long_ids < n_dump
        eq = (long_ids[:, None] == long_ids[None, :]) & live[:, None]
        a = eq.to(mbar.dtype)
        a = a / a.sum(0).clamp(min=1.0)
        d_msg = a @ (d_mbar if g_mbar is None else d_mbar + g_mbar)
    return d_msg, dwx, dwh, dbx, dbh


class FusedFlush(torch.autograd.Function):
    """The flush kernel, in place on ``mem`` / ``last``
    (``ctx.mark_dirty``), with the gradient of ``ref.flush_ref`` for
    ``msg, wx, wh, bx, bh``; ``ids, ts, mem, last`` are constants of the
    step (the model's carried state) and get none. Nothing with N rows is
    saved."""

    @staticmethod
    def forward(ctx, ids, msg, ts, mem, last, wx, wh, bx, bh):
        if any(ctx.needs_input_grad[i] for i in (2, 3, 4)):
            raise NotImplementedError(
                "fused_flush: ts, mem and last are step constants; detach "
                "them before the call")
        mem, last, mbar, h_g, orow = fused_flush_fwd(ids, msg, ts, mem, last,
                                                     wx, wh, bx, bh)
        ctx.mark_dirty(mem, last)
        ctx.mark_non_differentiable(last)
        # an unused output's cotangent stays None, not an (N+1)-row zero
        ctx.set_materialize_grads(False)
        ctx.n_dump = mem.shape[0] - 1
        ctx.save_for_backward(ids, mbar, h_g, orow, wx, wh, bx, bh)
        return mem, last, mbar

    @staticmethod
    def backward(ctx, g_mem, _g_last, g_mbar):
        ids, mbar, h_g, orow, wx, wh, bx, bh = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_msg, *dw = flush_bwd_rows(g_mem, g_mbar, ids, mbar, h_g, orow, wx,
                                    wh, bx, bh, n_dump=ctx.n_dump,
                                    need_msg=need[1])
        return (None, d_msg, None, None, None,
                *(g if need[i] else None for i, g in zip((5, 6, 7, 8), dw)))
