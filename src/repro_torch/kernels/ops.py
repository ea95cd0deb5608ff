"""The kernel entry points the model calls, dispatched by device.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version in ``ref.py``; a tensor on the ``meta`` device (shapes
only, no data: the dry run, ``launch/dryrun.py``) goes to the meta route,
``meta.run``, which returns empty outputs of the kernel's shapes and
dtypes. Nothing else chooses: there is no backend switch and no fallback
from a kernel that fails to build or launch, and any other device raises.
Each entry point is one scope of a step cost counter
(``meta.scoped``, ``roofline/op_cost.py``), its backward another.

On the CPU autograd differentiates the plain versions. On the card every
kernel is differentiable through a ``torch.autograd.Function`` whose
backward is a kernel too (the GRU, the flush, the temporal attention;
flash attention, WKV and the selective scan where a gradient is wanted,
so that serving under ``torch.no_grad()`` launches the forward alone): a
kernel's output that autograd did not know would drop every gradient
through it.

The JAX package pads feature dims to 128 lanes and K to 8 sublanes here
(``repro/kernels/ops.py``); that is a TPU layout choice, not semantics, so
the port calls its kernels on the unpadded ``ref.py`` shapes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import meta, ref
from repro_torch.kernels.flash_attention import (check_key_length,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.fused_flush import FusedFlush
from repro_torch.kernels.fused_gru import FusedGRU
from repro_torch.kernels.neighbor_sample import (neighbor_sample_fwd,
                                                 sample_roles_fwd)
from repro_torch.kernels.rwkv6_scan import rwkv6_bwd, rwkv6_fwd
from repro_torch.kernels.selective_scan import (selective_scan_bwd,
                                                selective_scan_fwd)
from repro_torch.kernels.temporal_attn import TemporalAttention

__all__ = ["temporal_attention", "fused_flush", "neighbor_sample",
           "sample_roles", "rwkv6", "gru", "flash_attention",
           "selective_scan", "FlashAttention", "RWKV6", "SelectiveScan"]


def _route(x: torch.Tensor) -> str:
    """``"cuda"`` (the kernel), ``"cpu"`` (the plain version) or
    ``"meta"`` (the meta route), by ``x``'s device; any other raises."""
    if x.device.type in ("cuda", "cpu", "meta"):
        return x.device.type
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` on the card, differentiable: the forward kernel
    also writes each row's log-sum-exp, and the backward is the
    ``flash_attention_bwd`` kernel (dk and dv per KV head). Inputs in the
    model's layout, contiguous."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def _f32(x):
    """A cotangent as the backward kernels take it: float32, contiguous."""
    return x.float().contiguous()


class RWKV6(torch.autograd.Function):
    """``rwkv6`` on the card, differentiable: the forward kernel (chunked
    or sequential, as ``rwkv6_fwd`` picks), and the ``rwkv6_bwd`` kernel
    for the gradients of r, k, v, w, u and the initial state. Inputs as
    ``rwkv6_fwd`` takes them (model layout, contiguous, w and u float32);
    outputs ``(o, final state)``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, out_dtype):
        o, st = rwkv6_fwd(r, k, v, w, u, state, out_dtype=out_dtype)
        ctx.save_for_backward(r, k, v, w, u, state)
        return o, st

    @staticmethod
    def backward(ctx, do, dst):
        r, k, v, w, u, state = ctx.saved_tensors
        return (*rwkv6_bwd(r, k, v, w, u, _f32(do), state, _f32(dst)),
                None)


class SelectiveScan(torch.autograd.Function):
    """``selective_scan`` on the card, differentiable: the forward kernel
    (chunked or per-state, as ``selective_scan_fwd`` picks), and the
    ``selective_scan_bwd`` kernel for the gradients of x, dt, b, c, a and
    the initial state. Inputs as ``selective_scan_fwd`` takes them
    (contiguous, a float32); outputs ``(y, final state)``."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, state):
        y, h = selective_scan_fwd(x, dt, b, c, a, state)
        ctx.save_for_backward(x, dt, b, c, a, state)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, b, c, a, state = ctx.saved_tensors
        return selective_scan_bwd(x, dt, b, c, a, _f32(dy), state, _f32(dh))


@meta.scoped("gru")
def gru(x, h, wx, wh, bx, bh):
    """GRU cell h' = GRU(x, h), differentiable in all six arguments.
    x: (B, d_in), h: (B, d_h), wx: (d_in, 3 d_h), wh: (d_h, 3 d_h), bx,
    bh: (3 d_h,); gates [r | z | n]. On the card the forward and the
    backward are kernels (the backward recomputes the gates); on the CPU
    autograd goes through ``ref.gru_ref``."""
    route = _route(x)
    if route == "meta":
        return meta.run("gru", x, h, wx, wh, bx, bh)[0]
    if route == "cuda":
        return FusedGRU.apply(*(t.contiguous() for t in (x, h, wx, wh, bx,
                                                          bh)))
    return ref.gru_ref(x, h, wx, wh, bx, bh)


@meta.scoped("flash_attention")
def flash_attention(q, k, v, *, causal=True, window=None):
    """Causal or full attention with an optional sliding ``window`` (how
    many tokens a query may look back, itself included), in the model's
    layout: q (B, Sq, H, D), k and v (B, Sk, Hkv, D), head h reading KV
    head h // (H // Hkv); Sk = Sq where ``causal`` or ``window``, any Sk
    >= 1 otherwise (cross-attention). Float32 inside; returns (B, Sq, H,
    D) in q's dtype. Differentiable on both devices: on the card, where a
    gradient is wanted, through ``FlashAttention`` (the forward kernel
    with the log-sum-exp, the backward kernel); on the CPU, autograd
    through the plain version.

    (The JAX package's op takes (B, H, S, D) with equal head counts, plus
    ``block_q`` / ``block_k``, which are TPU tiles. On the CPU the plain
    version gets that layout: K and V repeated in kv-major order and the
    axes moved.)"""
    check_key_length(q.shape[1], k.shape[1], causal, window)
    route = _route(q)
    if route == "meta":
        return meta.run("flash_attention", q, k, v, causal=causal,
                        window=window)[0]
    if route == "cuda":
        args = (q.contiguous(), k.contiguous(), v.contiguous())
        if _wants_grad(*args):
            return FlashAttention.apply(*args, causal, window)
        return flash_attention_fwd(*args, causal=causal, window=window)
    group = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(group, dim=2),
        v.repeat_interleave(group, dim=2)))
    return ref.flash_attention_ref(qh, kh, vh, causal=causal,
                                   window=window).transpose(1, 2)


@meta.scoped("temporal_attention")
def temporal_attention(q, k, v, mask):
    """q: (B, H, D); k, v: (B, K, H, D); mask: (B, K) bool -> (B, H, D)."""
    route = _route(q)
    if route == "meta":
        return meta.run("temporal_attention", q, k, v, mask)[0]
    if route == "cuda":
        return TemporalAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), mask.contiguous())
    return ref.temporal_attention_ref(q, k, v, mask)


@meta.scoped("fused_flush")
def fused_flush(ids, msg, ts, mem, last, wx, wh, bx, bh):
    """The whole message flush (segment-mean + GRU + mem/last scatter);
    ``(mem', last', mbar)``. On the card the kernel writes ``mem`` and
    ``last`` in place and returns them (so a caller that keeps the old
    state passes a copy); on the CPU ``ref.flush_ref`` returns new
    tensors."""
    route = _route(msg)
    if route == "meta":
        return meta.run("fused_flush", ids, msg, ts, mem, last, wx, wh, bx,
                        bh)
    if route == "cuda":
        return FusedFlush.apply(*(x.contiguous() for x in (
            ids, msg, ts, mem, last, wx, wh, bx, bh)))
    return ref.flush_ref(ids, msg, ts, mem, last, wx, wh, bx, bh)


@meta.scoped("neighbor_sample")
def neighbor_sample(tcsr: dict, nodes, batch_of, k: int, window=0):
    """K most recent temporal neighbors from a staged T-CSR (``tcsr``
    holds indptr / nbr / t / eidx / bat). Returns ((R, k) ids, times, edge
    rows), -1 / -1.0 front-padded, oldest -> newest."""
    args = (tcsr["indptr"], tcsr["nbr"], tcsr["t"], tcsr["eidx"],
            tcsr["bat"], nodes, batch_of, k, window)
    route = _route(nodes)
    if route == "meta":
        return meta.run("neighbor_sample", nodes, k=k)
    if route == "cuda":
        return neighbor_sample_fwd(*args)
    return ref.sample_ref(*args)


@meta.scoped("sample_roles")
def sample_roles(tcsr: dict, src, dst, neg, valid, batch_of, k: int):
    """A step's neighbor grids in one call: ``neighbor_sample`` over the 3B
    rows src ++ dst ++ neg, where a row whose id is < 0 or whose slot is
    not ``valid`` samples node 0 and gets -1 ids and edge rows (its times
    as sampled). Returns (3B, k) ids, times, edge rows."""
    args = (tcsr["indptr"], tcsr["nbr"], tcsr["t"], tcsr["eidx"],
            tcsr["bat"], src, dst, neg, valid, batch_of, k)
    route = _route(src)
    if route == "meta":
        return meta.run("sample_roles", src, k=k)
    if route == "cuda":
        return sample_roles_fwd(*args)
    return ref.sample_roles_ref(*args)


@meta.scoped("rwkv6")
def rwkv6(r, k, v, w, u, *, state=None, chunk=64, return_state=True):
    """RWKV6 WKV recurrence in the model's layout. r, k, w: (B, S, H, Dk);
    v: (B, S, H, Dv); u: (H, Dk); state: optional (B, H, Dk, Dv). Returns
    ``(o, state)`` with o (B, S, H, Dv), or ``o`` alone without
    ``return_state``. (The JAX package's op takes (B, H, S, D); the plain
    versions keep that layout, and only the CPU branch moves the axes.)

    ``o`` is float32 when ``S % chunk`` or ``S <= chunk`` (the JAX
    package's XLA path then takes the token scan) and has ``r``'s dtype
    otherwise, on both devices. On the CPU ``chunk`` also picks the plain
    version (the chunked algebra, whose exponents stay in range only for
    |log w| * chunk below about 80, or the scan). On the card S >= 64
    goes to the chunked kernel (chunks of 64 on the tensor cores, every
    decay factor at most 1, any w in (0, 1]) and S < 64, decode, to the
    sequential one; ``chunk`` sets only the output dtype there. Where a
    gradient is wanted the card goes through ``RWKV6`` (the forward kernel,
    then the backward kernel); without one the forward kernel runs
    alone."""
    s = r.shape[1]
    route = _route(r)
    if route == "meta":
        o, st = meta.run("rwkv6", r, k, v, w, u, state, chunk=chunk)
    elif route == "cuda":
        out_dtype = torch.float32 if (s % chunk or s <= chunk) else r.dtype
        args = (*(x.contiguous() for x in (r, k, v, w.float(), u.float())),
                None if state is None else state.float().contiguous())
        if _wants_grad(*args):
            o, st = RWKV6.apply(*args, out_dtype)
        else:
            o, st = rwkv6_fwd(*args, out_dtype=out_dtype)
    else:
        o, st = ref.rwkv6_chunked_ref(
            *(x.transpose(1, 2) for x in (r, k, v, w)), u, state=state,
            chunk=chunk, return_state=True)
        o = o.transpose(1, 2)
    return (o, st) if return_state else o


@meta.scoped("selective_scan")
def selective_scan(x, dt, b, c, a, *, state=None):
    """Mamba's selective scan h = exp(dt a) h + (dt x) b, y = c . h over
    the tokens. x, dt: (B, S, di); b, c: (B, S, n), in the compute dtype;
    a: (di, n) float32; state: None (zeros) or (B, di, n) float32. Returns
    (y (B, S, di) in x's dtype, the final state float32). On the card the
    CUDA kernel (n 8 or 16; its chunked form from S 128, its per-state form
    below), through ``SelectiveScan`` (with the backward kernel) where a
    gradient is wanted; on the CPU ``ref.selective_scan_ref``."""
    route = _route(x)
    if route == "meta":
        return meta.run("selective_scan", x, dt, b, c, a, state)
    if route == "cuda":
        args = (*(t.contiguous() for t in (x, dt, b, c)),
                a.float().contiguous(),
                None if state is None else state.float().contiguous())
        if _wants_grad(*args):
            return SelectiveScan.apply(*args)
        return selective_scan_fwd(*args)
    return ref.selective_scan_ref(x, dt, b, c, a, state=state)
