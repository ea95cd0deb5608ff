"""The RWKV6 WKV recurrence on the card: wrappers of the two CUDA kernels in
``csrc/rwkv6_scan.cu``, which replace the TPU kernel
``repro/kernels/rwkv6_scan.py:_wkv_kernel``.

``rwkv6_fwd`` dispatches by shape: S >= ``CHUNK`` goes to the chunked
kernel (``rwkv6``: chunks of 64 tokens as matrix products on the tensor
cores, every decay factor at most 1, so any w in (0, 1] is in range), S <
``CHUNK`` (decode) to the sequential one (``rwkv6_seq``: the token scan).
Both compute the function of ``ref.rwkv6_ref``; the chunked kernel's
algebra is ``ref.rwkv6_subchunk_ref``. They read and write the model's (B,
S, H, 64) layout; the plain versions keep the JAX package's (B, H, S, 64).

``rwkv6_bwd`` wraps the backward kernel of ``csrc/rwkv6_scan_bwd.cu``
(four launches: each 64-token chunk's summaries on the tensor cores, a
scan over the chunks for the states and cotangents at their edges, the
chunks' gradients from sub-chunk edge states, u's sum), which replaces no
TPU kernel: the JAX package differentiates its XLA path there.
``ops.RWKV6`` runs it where a gradient is wanted; ``ref.rwkv6_bwd_ref`` is
its plain version and ``ref.rwkv6_bwd_chunked_ref`` its algebra.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS, library

__all__ = ["rwkv6_fwd", "rwkv6_chunked_fwd", "rwkv6_seq_fwd", "rwkv6_bwd",
           "bwd_chunk", "HEAD_DIM", "CHUNK"]

HEAD_DIM = 64     # the kernels' Dk = Dv (RWKV6's published head size)
CHUNK = 64        # tokens per chunk of the chunked kernel


def rwkv6_fwd(r, k, v, w, u, state=None, *, out_dtype=torch.float32):
    """r, k, v: (B, S, H, 64) float32 or bfloat16, one dtype; w: (B, S, H,
    64) float32; u: (H, 64) float32; state: None (zeros) or (B, H, 64, 64)
    float32; all contiguous on one card. Returns ``(o, final_state)``:
    o (B, S, H, 64) in ``out_dtype`` (float32, or bfloat16 for bfloat16
    inputs), final_state (B, H, 64, 64) float32. The chunked kernel for S
    >= ``CHUNK``, the sequential one below."""
    if r.dim() == 4 and r.shape[1] < CHUNK:
        return rwkv6_seq_fwd(r, k, v, w, u, state, out_dtype=out_dtype)
    return rwkv6_chunked_fwd(r, k, v, w, u, state, out_dtype=out_dtype)


def rwkv6_chunked_fwd(r, k, v, w, u, state=None, *, out_dtype=torch.float32):
    """The chunked kernel at any S >= 1 (arguments as ``rwkv6_fwd``)."""
    return _launch(KERNELS["rwkv6"], r, k, v, w, u, state, out_dtype)


def rwkv6_seq_fwd(r, k, v, w, u, state=None, *, out_dtype=torch.float32):
    """The sequential kernel at any S >= 1 (arguments as ``rwkv6_fwd``)."""
    return _launch(KERNELS["rwkv6_seq"], r, k, v, w, u, state, out_dtype)


def _launch(kernel, r, k, v, w, u, state, out_dtype):
    dev = r.device
    if r.dim() != 4:
        raise ValueError(f"r: expected (B, S, H, {HEAD_DIM}), got "
                         f"{tuple(r.shape)}")
    b, s, h, _ = r.shape
    if s < 1:
        raise ValueError("the WKV kernels need S >= 1")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"r, k, v: float32 or bfloat16, got {r.dtype}")
    if out_dtype not in (torch.float32, r.dtype):
        raise TypeError(f"out_dtype {out_dtype} with {r.dtype} inputs")
    shape = (b, s, h, HEAD_DIM)
    for name, x in (("r", r), ("k", k), ("v", v)):
        check(name, x, r.dtype, shape, dev)
    check("w", w, torch.float32, shape, dev)
    check("u", u, torch.float32, (h, HEAD_DIM), dev)
    if state is not None:
        check("state", state, torch.float32, (b, h, HEAD_DIM, HEAD_DIM),
              dev)
    o = torch.empty(shape, dtype=out_dtype, device=dev)
    s_out = torch.empty((b, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                        device=dev)
    kernel(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(), b, h, s,
        int(r.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        o.data_ptr(), s_out.data_ptr(), stream(dev))
    return o, s_out


def bwd_chunk() -> int:
    """The tokens of a chunk of the backward (between two stored edge
    states), as the built kernel reports it: ``csrc/rwkv6_scan_bwd.cu``
    owns its chunk."""
    fn = library("rwkv6_scan_bwd.cu").rwkv6_wkv_bwd_chunk
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def rwkv6_bwd(r, k, v, w, u, do, state=None, dstate=None):
    """The backward kernel: r, k, v, w, u and state as ``rwkv6_fwd`` takes
    them; do: (B, S, H, 64) float32, the output's cotangent; dstate: None
    (zeros) or (B, H, 64, 64) float32, the final state's; each 8-byte
    aligned. Returns ``(dr, dk, dv, dw, du, dstate0)``: dr, dk, dv in r's
    dtype and dw float32, (B, S, H, 64); du (H, 64) float32; dstate0 (B,
    H, 64, 64) float32 where ``state`` is given, else None."""
    dev = r.device
    if r.dim() != 4:
        raise ValueError(f"r: expected (B, S, H, {HEAD_DIM}), got "
                         f"{tuple(r.shape)}")
    b, s, h, _ = r.shape
    if s < 1:
        raise ValueError("the WKV kernels need S >= 1")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"r, k, v: float32 or bfloat16, got {r.dtype}")
    shape = (b, s, h, HEAD_DIM)
    for name, x in (("r", r), ("k", k), ("v", v)):
        check(name, x, r.dtype, shape, dev)
    check("w", w, torch.float32, shape, dev)
    check("do", do, torch.float32, shape, dev)
    check("u", u, torch.float32, (h, HEAD_DIM), dev)
    mat = (b, h, HEAD_DIM, HEAD_DIM)
    if state is not None:
        check("state", state, torch.float32, mat, dev)
    if dstate is not None:
        check("dstate", dstate, torch.float32, mat, dev)
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("do", do),
                    ("u", u)):
        if x.data_ptr() % 8:
            raise ValueError(f"{name}: the backward kernel needs an 8-byte "
                             f"aligned tensor")
    nc = -(-s // bwd_chunk())
    f32 = dict(dtype=torch.float32, device=dev)
    sb = torch.empty((b, h, nc, HEAD_DIM, HEAD_DIM), **f32)
    gb = torch.empty_like(sb)
    dec = torch.empty((b, h, nc, HEAD_DIM), **f32)
    du_part = torch.empty((b, nc, h, HEAD_DIM), **f32)
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dw = torch.empty(shape, **f32)
    du = torch.empty((h, HEAD_DIM), **f32)
    ds0 = None if state is None else torch.empty(mat, **f32)
    KERNELS["rwkv6_bwd"](
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), do.data_ptr(),
        None if state is None else state.data_ptr(),
        None if dstate is None else dstate.data_ptr(), b, h, s,
        int(r.dtype == torch.bfloat16), nc, sb.data_ptr(), gb.data_ptr(),
        dec.data_ptr(), du_part.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        dw.data_ptr(), du.data_ptr(),
        None if ds0 is None else ds0.data_ptr(), stream(dev))
    return dr, dk, dv, dw, du, ds0
