"""The kernel entry points the model calls, dispatched by device.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain version in ``ref.py``. Nothing else chooses: there is no backend
switch and no fallback from a kernel that fails to build or launch.

The JAX package pads feature dims to 128 lanes and K to 8 sublanes here
(``repro/kernels/ops.py``); that is a TPU layout choice, not semantics, so
the port calls its kernels on the unpadded ``ref.py`` shapes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.fused_flush import FusedFlush
from repro_torch.kernels.fused_gru import FusedGRU
from repro_torch.kernels.neighbor_sample import (neighbor_sample_fwd,
                                                 sample_roles_fwd)
from repro_torch.kernels.rwkv6_scan import rwkv6_fwd
from repro_torch.kernels.temporal_attn import TemporalAttention

__all__ = ["temporal_attention", "fused_flush", "neighbor_sample",
           "sample_roles", "rwkv6", "gru", "flash_attention"]


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def gru(x, h, wx, wh, bx, bh):
    """GRU cell h' = GRU(x, h), differentiable in all six arguments.
    x: (B, d_in), h: (B, d_h), wx: (d_in, 3 d_h), wh: (d_h, 3 d_h), bx,
    bh: (3 d_h,); gates [r | z | n]. On the card the forward and the
    backward are kernels (the backward recomputes the gates); on the CPU
    autograd goes through ``ref.gru_ref``."""
    if _on_card(x):
        return FusedGRU.apply(*(t.contiguous() for t in (x, h, wx, wh, bx,
                                                          bh)))
    return ref.gru_ref(x, h, wx, wh, bx, bh)


def flash_attention(q, k, v, *, causal=True, window=None):
    """Causal or full attention with an optional sliding ``window`` (how
    many tokens a query may look back, itself included), in the model's
    layout: q (B, S, H, D), k and v (B, S, Hkv, D), head h reading KV head
    h // (H // Hkv). Float32 inside; returns (B, S, H, D) in q's dtype.
    Forward only.

    (The JAX package's op takes (B, H, S, D) with equal head counts, plus
    ``block_q`` / ``block_k``, which are TPU tiles. On the CPU the plain
    version gets that layout: K and V repeated in kv-major order and the
    axes moved.)"""
    if _on_card(q):
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    group = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(group, dim=2),
        v.repeat_interleave(group, dim=2)))
    return ref.flash_attention_ref(qh, kh, vh, causal=causal,
                                   window=window).transpose(1, 2)


def temporal_attention(q, k, v, mask):
    """q: (B, H, D); k, v: (B, K, H, D); mask: (B, K) bool -> (B, H, D)."""
    if _on_card(q):
        return TemporalAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), mask.contiguous())
    return ref.temporal_attention_ref(q, k, v, mask)


def fused_flush(ids, msg, ts, mem, last, wx, wh, bx, bh):
    """The whole message flush (segment-mean + GRU + mem/last scatter);
    ``(mem', last', mbar)``. On the card the kernel writes ``mem`` and
    ``last`` in place and returns them (so a caller that keeps the old
    state passes a copy); on the CPU ``ref.flush_ref`` returns new
    tensors."""
    if _on_card(msg):
        return FusedFlush.apply(*(x.contiguous() for x in (
            ids, msg, ts, mem, last, wx, wh, bx, bh)))
    return ref.flush_ref(ids, msg, ts, mem, last, wx, wh, bx, bh)


def neighbor_sample(tcsr: dict, nodes, batch_of, k: int, window=0):
    """K most recent temporal neighbors from a staged T-CSR (``tcsr``
    holds indptr / nbr / t / eidx / bat). Returns ((R, k) ids, times, edge
    rows), -1 / -1.0 front-padded, oldest -> newest."""
    args = (tcsr["indptr"], tcsr["nbr"], tcsr["t"], tcsr["eidx"],
            tcsr["bat"], nodes, batch_of, k, window)
    if _on_card(nodes):
        return neighbor_sample_fwd(*args)
    return ref.sample_ref(*args)


def sample_roles(tcsr: dict, src, dst, neg, valid, batch_of, k: int):
    """A step's neighbor grids in one call: ``neighbor_sample`` over the 3B
    rows src ++ dst ++ neg, where a row whose id is < 0 or whose slot is
    not ``valid`` samples node 0 and gets -1 ids and edge rows (its times
    as sampled). Returns (3B, k) ids, times, edge rows."""
    args = (tcsr["indptr"], tcsr["nbr"], tcsr["t"], tcsr["eidx"],
            tcsr["bat"], src, dst, neg, valid, batch_of, k)
    if _on_card(src):
        return sample_roles_fwd(*args)
    return ref.sample_roles_ref(*args)


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
    sequential one; ``chunk`` sets only the output dtype there."""
    s = r.shape[1]
    if _on_card(r):
        out_dtype = torch.float32 if (s % chunk or s <= chunk) else r.dtype
        o, st = rwkv6_fwd(
            *(x.contiguous() for x in (r, k, v, w.float(), u.float())),
            None if state is None else state.float().contiguous(),
            out_dtype=out_dtype)
    else:
        o, st = ref.rwkv6_chunked_ref(
            *(x.transpose(1, 2) for x in (r, k, v, w)), u, state=state,
            chunk=chunk, return_state=True)
        o = o.transpose(1, 2)
    return (o, st) if return_state else o
