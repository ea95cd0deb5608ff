"""The kernels' meta route and their cost scopes.

**Meta route.** ``kernels/ops.py`` dispatches by device: a CUDA tensor
goes to the hand-written kernel, a CPU tensor to its plain version, and a
tensor on the ``meta`` device here. ``run(name, *tensors, **static)``
returns empty ``meta`` outputs of the kernel's shapes and dtypes
(``_SPECS``); where a gradient is wanted it goes through ``MetaKernel``,
whose backward returns empty gradients. ``MetaKernel`` saves what the
card's ``autograd.Function`` saves (the flash forward's log-sum-exp, the
flush's gathered rows), so a tally of saved tensors on ``meta`` reads the
card's. It is not a fallback: a CUDA or CPU tensor never reaches it, and
it computes nothing. It gives a costed step of a full-size model with no
allocation (``launch/dryrun.py``).

**Cost scopes.** While a step cost counter is active
(``roofline/op_cost.OpCost``), every entry point of ``ops.py`` wrapped by
``scoped`` is one scope, and so is its backward: the aten ops dispatched
inside (the plain version's on the CPU; the wrapper's ``.contiguous()``,
casts and output allocations on the card and on ``meta``) are not
counted. The scope adds the kernel's own count instead:

* bytes: its operands and its results, as the JAX package's cost walker
  counts one fused op (the backward: the forward's operands, the
  cotangents it gets and the gradients it returns);
* FLOPs: what that walker counts for the JAX code the kernel stands in
  for at that place in the program, at the same shapes (``_FLOPS``,
  each formula beside its kernel).

So a step's count is the same on the CPU, on the card (whose ctypes
launches a dispatch mode cannot see) and on ``meta``: it reads the work,
not the implementation. Under a counter each scope hands back fresh,
contiguous tensors, outputs and gradients (a plain version may return a
transposed view where the kernel writes a contiguous output), so the ops
after it are the same on every device. With no counter active the entry points run as they
are.
"""

from __future__ import annotations

import functools
import inspect
from contextlib import nullcontext

import torch

__all__ = ["run", "MetaKernel", "scoped", "push_counter", "pop_counter",
           "nbytes"]

_COUNTERS: list = []     # active step cost counters, innermost last


def push_counter(counter) -> None:
    _COUNTERS.append(counter)


def pop_counter(counter) -> None:
    _COUNTERS.remove(counter)


def nbytes(x) -> int:
    """Bytes of a tensor, or of every tensor in a tuple / list / dict."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(nbytes(v) for v in x)
    return 0


# ------------------------------------------------------------ meta route

def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _like(x) -> torch.Tensor:
    return _empty(x.shape, x.dtype)


def _rwkv6_out(r, k, v, w, u, state, *, chunk):
    b, s, h, dk = r.shape
    dtype = torch.float32 if (s % chunk or s <= chunk) else r.dtype
    return (_empty((b, s, h, v.shape[-1]), dtype),
            _empty((b, h, dk, v.shape[-1]), torch.float32))


def _sample_out(rows: int, k: int):
    return (_empty((rows, k), torch.int32), _empty((rows, k), torch.float32),
            _empty((rows, k), torch.int32))


# name -> (outputs(*tensors, **static), saved(tensors, outputs)): the
# outputs the kernel returns, and what the card's autograd.Function saves
_SPECS = {
    "gru": (lambda x, h, wx, wh, bx, bh: (_like(h),),
            lambda ins, outs: ins),
    "flash_attention": (
        lambda q, k, v, **_: (_like(q),),
        lambda ins, outs: (*ins, *outs, _empty(
            (ins[0].shape[0], ins[0].shape[2], ins[0].shape[1]),
            torch.float32))),
    "temporal_attention": (lambda q, k, v, mask: (_like(q),),
                           lambda ins, outs: ins),
    "fused_flush": (
        lambda ids, msg, ts, mem, last, *w: (_like(mem), _like(last),
                                             _like(msg)),
        lambda ins, outs: (ins[0], outs[2],
                           _empty((ins[0].shape[0], ins[3].shape[1]),
                                  torch.float32),
                           _empty(ins[0].shape, torch.int32), *ins[5:])),
    "neighbor_sample": (lambda nodes, *_, k: _sample_out(nodes.shape[0], k),
                        lambda ins, outs: ()),
    "sample_roles": (lambda src, *_, k: _sample_out(3 * src.shape[0], k),
                     lambda ins, outs: ()),
    "rwkv6": (_rwkv6_out, lambda ins, outs: ins),
    "selective_scan": (
        lambda x, dt, b, c, a, state: (
            _like(x), _empty((x.shape[0], x.shape[2], b.shape[2]),
                             torch.float32)),
        lambda ins, outs: ins),
}
# outputs the card's Function marks non-differentiable, beside integer ones
_NONDIFF = {"fused_flush": (1,)}


class MetaKernel(torch.autograd.Function):
    """A kernel on ``meta``: empty outputs of its shapes and dtypes, what
    the card's Function saves saved, and empty gradients for the inputs
    that want one."""

    @staticmethod
    def forward(ctx, name, static, *tensors):
        make, saved = _SPECS[name]
        outs = make(*tensors, **static)
        ctx.save_for_backward(*saved(tensors, outs))
        ctx.inputs = [None if t is None else (t.shape, t.dtype)
                      for t in tensors]
        ctx.mark_non_differentiable(*[
            o for i, o in enumerate(outs)
            if not o.is_floating_point() or i in _NONDIFF.get(name, ())])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(
            _empty(*spec) if spec is not None and need else None
            for spec, need in zip(ctx.inputs, ctx.needs_input_grad[2:])))


def run(name: str, *tensors, **static):
    """The meta route of kernel ``name``: its outputs as a tuple, through
    ``MetaKernel`` where a gradient is wanted. ``tensors`` are the
    kernel's tensor inputs (None where optional), ``static`` its other
    arguments."""
    if any(t is not None and t.device.type != "meta" for t in tensors):
        raise ValueError(f"{name}: the meta route takes meta tensors only")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        return MetaKernel.apply(name, static, *tensors)
    return _SPECS[name][0](*tensors, **static)


# ----------------------------------------------------------- FLOP formulas
#
# Each formula takes ``need`` (does a tensor want a gradient) and the entry
# point's arguments; it returns (forward FLOPs, backward FLOPs). A dot of
# the JAX code costs 2 prod(result) prod(contracting) as the walker counts
# it; its backward one such dot for each operand that wants a gradient
# (XLA drops the others), except where that gradient contracts nothing (an
# outer product: XLA emits a multiply, which the walker does not count).

def _gru_flops(need, x, h, wx, wh, bx, bh):
    # repro/kernels/ref.py:gru_ref: x @ wx and h @ wh
    rows, d_in = x.shape
    d_h = h.shape[-1]
    dot_x = 2 * rows * d_in * 3 * d_h
    dot_h = 2 * rows * d_h * 3 * d_h
    bwd = dot_x * (need(x) + need(wx)) + dot_h * (need(h) + need(wh))
    return dot_x + dot_h, bwd


def _flush_flops(need, ids, msg, ts, mem, last, wx, wh, bx, bh):
    # repro/kernels/ref.py:flush_ref: the segment mean is scatters and a
    # gather; the GRU of the R touched rows, gru_ref(mbar, mem[ids]), is
    # the only dot work (mem is a step constant: no dh)
    rows, d_msg = msg.shape
    d = mem.shape[-1]
    dot_x = 2 * rows * d_msg * 3 * d
    dot_h = 2 * rows * d * 3 * d
    bwd = dot_x * (need(msg) + need(wx)) + dot_h * need(wh)
    return dot_x + dot_h, bwd


def _attn_flops(need, q, k, v, mask):
    # repro/kernels/ref.py:temporal_attention_ref: the scores q . k and
    # the context att . v, each 2 B H K D. Backward: the cotangent of the
    # weights (g . v over D) and dq (over K); dk and dv are outer products
    b, kn, h, d = k.shape
    dot = 2 * b * h * kn * d
    dq, dk = need(q), need(k)
    return 2 * dot, dot * ((dq or dk) + dq)


def _no_flops(need, *args, **kw):
    # sampling: a bisect and gathers, no dot
    return 0, 0


def _flash_flops(need, q, k, v, causal=True, window=None):
    # repro/models/layers.py:chunked_attention, the JAX LM path: query
    # chunks of min(512, Sq) rows against all Sk keys, or against window
    # + chunk keys where a window is set; the scores and the context, each
    # 2 B H Sq Sk' D, masked keys included (the kernel skips fully masked
    # tiles, so it does less: ~1/1.5 at (1, 8192) window 4096, ~1/2
    # causal). Its backward recomputes each chunk's scores
    # (jax.checkpoint over the chunk map) where there is more than one
    # chunk, then takes dq, dk, dv and the weights' cotangent, a product each
    b, sq, h, d = q.shape
    sk = k.shape[1]
    chunk = min(512, sq)
    keys = min(window + chunk, sk) if window is not None else sk
    dot = 2 * b * h * sq * keys * d
    dq, dk, dv = need(q), need(k), need(v)
    recompute = dot if sq > chunk else 0
    return 2 * dot, recompute + dot * (dq + dk + dv + (dq or dk))


def _rwkv6_flops(need, r, k, v, w, u, state=None, chunk=64,
                 return_state=True):
    # repro/kernels/ref.py:rwkv6_chunked_xla: for S a multiple of the
    # chunk C and S > C, per chunk the scores (C x C over Dk), the intra
    # product (C x C over Dv), the inter product r . s0 and the state
    # update k^T v (Dk x Dv over C); else the token scan rwkv6_ref, one
    # r . (S + u k v^T) a token, whose backward contracts for dr alone
    # (the state's cotangent is an outer product)
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    need_r = need(r) or need(w)
    need_k = need(k) or need(w)
    need_v = need(v)
    need_s = need_k or need_v or (state is not None and need(state))
    if s % chunk or s <= chunk:
        dot = 2 * b * h * s * dk * dv
        return dot, dot * need(r)
    scores = 2 * b * h * s * chunk * dk
    intra = 2 * b * h * s * chunk * dv
    inter = upd = 2 * b * h * s * dk * dv
    bwd = (scores * (need_r + need_k) + intra * ((need_r or need_k) + need_v)
           + inter * (need_r + need_s) + upd * (need_k + need_v))
    return scores + intra + inter + upd, bwd


def _scan_flops(need, x, dt, b, c, a, state=None):
    # repro/models/ssm.py:79, mamba's scan body: y = einsum("bdn,bn->bd",
    # h, c) a token; its backward contracts for dc alone (h's cotangent is
    # an outer product, and the chunks' recompute under jax.checkpoint
    # needs h, not y)
    bsz, s, di = x.shape
    dot = 2 * bsz * s * di * b.shape[-1]
    return dot, dot * need(c)


_FLOPS = {"gru": _gru_flops, "fused_flush": _flush_flops,
          "temporal_attention": _attn_flops, "neighbor_sample": _no_flops,
          "sample_roles": _no_flops, "flash_attention": _flash_flops,
          "rwkv6": _rwkv6_flops, "selective_scan": _scan_flops}


def flops(name: str, *args, need=lambda t: False, **kw) -> tuple:
    """(forward, backward) FLOPs of kernel ``name`` on ``args`` as the
    cost walker counts its JAX counterpart; ``need(t)``: does tensor
    ``t`` want a gradient."""
    def wants(t):
        return isinstance(t, torch.Tensor) and bool(need(t))
    return tuple(int(f) for f in _FLOPS[name](wants, *args, **kw))


# ----------------------------------------------------------------- scopes

def _leaves(arguments: dict) -> list:
    """The tensors among an entry point's arguments (a dict's values
    too), in order."""
    out = []
    for v in arguments.values():
        vals = v.values() if isinstance(v, dict) else (v,)
        out += [x for x in vals if isinstance(x, torch.Tensor)]
    return out


def _replace(arguments: dict, new: list) -> dict:
    """``arguments`` with its tensors replaced, in ``_leaves`` order."""
    it = iter(new)

    def swap(x):
        return next(it) if isinstance(x, torch.Tensor) else x

    return {k: ({kk: swap(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else swap(v))
            for k, v in arguments.items()}


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A new tensor object over contiguous data: the same storage where it
    was contiguous already (so an in-place output stays in place)."""
    c = t.contiguous()
    return c if c is not t else t.detach()


class _Call:
    def __init__(self, counter, name, fn, arguments, fwd, bwd, in_bytes):
        self.counter, self.name, self.fn = counter, name, fn
        self.arguments, self.fwd, self.bwd = arguments, fwd, bwd
        self.in_bytes = in_bytes


class _Scoped(torch.autograd.Function):
    """A differentiable entry point under a counter: the forward is one
    scope, and its backward (autograd through whatever the entry point
    built: the plain version's ops, the card's or the meta route's
    Function) another."""

    @staticmethod
    def forward(ctx, call, *tensors):
        inner = [t.detach().requires_grad_(True) if need else t.detach()
                 for t, need in zip(tensors, ctx.needs_input_grad[1:])]
        with torch.enable_grad(), call.counter.scope(
                call.name, call.fwd, call.in_bytes) as scope:
            out = call.fn(**_replace(call.arguments, inner))
            single = isinstance(out, torch.Tensor)
            outs = [out] if single else list(out)
            outs = [o.contiguous() for o in outs]
            scope.add_bytes(nbytes(outs))
        call.single = single
        ctx.call, ctx.inner, ctx.outs = call, inner, outs
        rets = [o.detach() for o in outs]
        ctx.mark_non_differentiable(*[r for r, o in zip(rets, outs)
                                      if not o.requires_grad])
        ctx.set_materialize_grads(False)
        return tuple(rets)

    @staticmethod
    def backward(ctx, *grads):
        call, needs = ctx.call, ctx.needs_input_grad[1:]
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t, need in zip(ctx.inner, needs) if need]
        nb = call.in_bytes + nbytes([g for _, g in pairs]) + nbytes(wrt)
        scope = (call.counter.scope(f"{call.name} backward", call.bwd, nb)
                 if call.counter.active else nullcontext())
        with scope:
            got = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wrt else [None] * len(wrt))
            got = [None if g is None else g.contiguous() for g in got]
        del ctx.inner, ctx.outs
        it = iter(got)
        return (None, *(next(it) if need else None for need in needs))


def _counted(counter, name: str, fn, arguments: dict):
    grad = torch.is_grad_enabled()
    tensors = _leaves(arguments)

    def need(t):
        return grad and t.requires_grad

    fwd, bwd = flops(name, need=need, **arguments)
    in_bytes = nbytes(tensors)
    if not any(need(t) for t in tensors):
        with counter.scope(name, fwd, in_bytes) as scope:
            out = fn(**arguments)
            single = isinstance(out, torch.Tensor)
            outs = [_fresh(o) for o in ([out] if single else out)]
            scope.add_bytes(nbytes(outs))
        return outs[0] if single else tuple(outs)
    call = _Call(counter, name, fn, arguments, fwd, bwd, in_bytes)
    outs = _Scoped.apply(call, *tensors)
    return outs[0] if call.single else outs


def scoped(name: str):
    """Make entry point ``name`` of ``ops.py`` one scope of the active
    step cost counter (and its backward another); without one it runs
    as it is."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(*args, **kw):
            if not _COUNTERS:
                return fn(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            return _counted(_COUNTERS[-1], name, fn, dict(bound.arguments))

        return entry

    return deco

