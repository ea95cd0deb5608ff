"""Flash attention on the card: wrappers of the CUDA kernels in
``csrc/flash_attention.cu`` (the forward, which replaces the TPU kernel
``repro/kernels/flash_attention.py:_fa_kernel``) and
``csrc/flash_attention_bwd.cu`` (its backward, which replaces no TPU
kernel: the JAX package differentiates its LM attention as XLA). Their
plain versions are ``ref.flash_attention_ref`` and
``ref.flash_attention_bwd_ref``, which take (B, H, S, D) with equal head
counts; the kernels read the model's (B, Sq, H, D) q and (B, Sk, Hkv, D) k
and v, head h reading KV head h // (H // Hkv). The key length Sk may
differ from Sq in non-causal calls without a window (cross-attention over
an encoder's memory), one step past the TPU kernel, which takes one S.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS, library

__all__ = ["flash_attention_fwd", "flash_attention_bwd", "check_key_length",
           "bwd_dq_tile", "bwd_scratch", "fwd_f32_tile", "f32_tiles",
           "BLOCK_Q", "BLOCK_KV", "F32_S_CHAIN"]

# the bf16 kernel's instantiations: StarCoder2-3B and OLMoE-1B-7B (128),
# Gemma-7B (256), hymba-1.5B (64) and the REDUCED configs (32)
BF16_HEAD_DIMS = (32, 64, 128, 256)
# the bf16 kernel's tiles, mirroring csrc/flash_attention.cu (ROWS_WG and
# Tile<D>::BKV): a block covers BLOCK_Q query rows of two heads of one KV
# group (an even number of query heads per KV head, as in StarCoder2-3B;
# else 2 BLOCK_Q rows of one head) and walks the key tiles of
# BLOCK_KV[D] keys from the one holding its first row's window start to
# the one holding its last row (64 keys at D 256, for shared memory)
BLOCK_Q = 64
BLOCK_KV = {d: 64 if d > 128 else 128 for d in BF16_HEAD_DIMS}
F32_MAX_HEAD_DIM = 256
# the float32 kernel's tiles, mirroring csrc/flash_attention.cu (`F32Tile`):
# a warp holds 16 query rows; a block two slots of F32_SLOT_ROWS rows,
# two heads of one KV group on the same rows where the group is even,
# else 2 slots of rows of one head; key tiles of F32_BLOCK_KV keys, by
# the head dim's bucket (D padded with zeros to 32, 64, 128 or 256)
F32_SLOT_ROWS = {32: 64, 64: 64, 128: 64, 256: 32}
F32_BLOCK_KV = {32: 64, 64: 64, 128: 64, 256: 32}
# the k-steps (8 head-dim columns each) of S = Q K^T summed in one
# tensor-core chain before the float32 add of the partials (all of them
# where the padded head dim has fewer)
F32_S_CHAIN = 8


def f32_tiles(d: int) -> tuple:
    """(k-steps NK of the padded head dim, query rows a slot, keys a
    tile) of the float32 kernel at head dim ``d``."""
    if not 0 < d <= F32_MAX_HEAD_DIM:
        raise ValueError(f"float32 flash attention takes head dims up to "
                         f"{F32_MAX_HEAD_DIM}, got {d}")
    bucket = next(b for b in sorted(F32_SLOT_ROWS) if d <= b)
    return bucket // 8, F32_SLOT_ROWS[bucket], F32_BLOCK_KV[bucket]


def check_key_length(sq: int, sk: int, causal: bool,
                     window: Optional[int]) -> None:
    """Raise unless ``sk`` keys suit ``sq`` queries: at least one key,
    and as many keys as queries in a causal or windowed call (the JAX
    package makes no other)."""
    if sk < 1 and sq > 0:
        raise ValueError("flash attention needs at least one key")
    if sk != sq and (causal or window):
        raise ValueError(f"a causal or windowed call takes as many keys as "
                         f"queries, got {sq} queries and {sk} keys")


def _check_inputs(q, k, v, causal: bool, window: Optional[int]) -> tuple:
    """Raise unless q, k, v suit the kernels (see ``flash_attention_fwd``);
    returns (B, Sq, Sk, H, Hkv, D)."""
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, S, H, D), got {tuple(q.shape)}")
    b, s, h, d = q.shape
    hkv, sk = (k.shape[2], k.shape[1]) if k.dim() == 4 else (-1, -1)
    if q.dtype == torch.bfloat16:
        if d not in BF16_HEAD_DIMS:
            raise ValueError(f"bfloat16 flash attention takes head dims "
                             f"{BF16_HEAD_DIMS}, got {d}")
    elif q.dtype == torch.float32:
        if d > F32_MAX_HEAD_DIM:
            raise ValueError(f"float32 flash attention takes head dims up "
                             f"to {F32_MAX_HEAD_DIM}, got {d}")
    else:
        raise TypeError(f"q, k, v: bfloat16 or float32, got {q.dtype}")
    check("q", q, q.dtype, (b, s, h, d), dev)
    check("k", k, q.dtype, (b, sk, hkv, d), dev)
    check("v", v, q.dtype, (b, sk, hkv, d), dev)
    check_key_length(s, sk, causal, window)
    if h % hkv:
        raise ValueError(f"{h} query heads do not split over {hkv} KV heads")
    if window is not None and window < 0:
        raise ValueError(f"window must be positive, got {window}")
    return b, s, sk, h, hkv, d


def _aligned(**tensors) -> None:
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs 16-byte aligned "
                             f"data")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with Hkv dividing H (Sk =
    Sq where ``causal`` or ``window``); all bfloat16 (D in
    ``BF16_HEAD_DIMS``) or all float32 (D up to ``F32_MAX_HEAD_DIM``),
    contiguous, 16-byte aligned, on one card. ``window``: how many tokens
    a query may look back, itself included (None or 0: unbounded).
    Returns o (B, Sq, H, D) in q's dtype; with ``return_lse`` also each
    row's log-sum-exp of its scaled scores, (B, H, Sq) float32, for
    ``flash_attention_bwd`` (without it the kernel writes none)."""
    b, s, sk, h, hkv, d = _check_inputs(q, k, v, causal, window)
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _aligned(q=q, k=k, v=v, o=o)
    KERNELS["flash_attention"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, sk, h, hkv, d,
        int(causal), int(window or 0), int(q.dtype == torch.bfloat16),
        o.data_ptr(), None if lse is None else lse.data_ptr(),
        stream(q.device))
    return (o, lse) if return_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None):
    """The gradients of ``flash_attention_fwd``'s o with respect to q, k
    and v, given o, its ``lse`` (B, H, Sq) float32 and the upstream
    gradient ``do`` (B, Sq, H, D) in q's dtype: (dq, dk, dv) in the
    inputs' dtype, dk and dv per KV head (summed over the query heads of
    its group). The same inputs as the forward's; float32 sums, no
    atomics (two calls agree bit for bit); one count a call of its four
    launches, on the tensor cores in both dtypes (bf16 by ``wgmma``,
    float32 as 3xTF32 products by ``mma.sync``)."""
    b, s, sk, h, hkv, d = _check_inputs(q, k, v, causal, window)
    check("o", o, q.dtype, (b, s, h, d), q.device)
    check("do", do, q.dtype, (b, s, h, d), q.device)
    check("lse", lse, torch.float32, (b, h, s), q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    bf16 = q.dtype == torch.bfloat16
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    part = torch.empty(bwd_scratch(b, s, sk, h, hkv, d, causal, window,
                                   bf16),
                       dtype=torch.float32, device=q.device)
    _aligned(q=q, k=k, v=v, o=o, do=do, dq=dq, dk=dk, dv=dv)
    KERNELS["flash_attention_bwd"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), b, s, sk, h, hkv, d, int(causal),
        int(window or 0), int(bf16), delta.data_ptr(),
        part.data_ptr(), part.numel(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stream(q.device))
    return dq, dk, dv


@functools.cache
def _bwd_query(name: str, argtypes: tuple, restype):
    fn = getattr(library("flash_attention_bwd.cu"), name)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def bwd_scratch(b: int, sq: int, sk: int, h: int, hkv: int, d: int,
                causal: bool, window: Optional[int], bf16: bool) -> int:
    """The float32 scratch, in elements, that the backward kernel needs
    for a call (the dK / dV sums of each run of its walk, in either
    dtype), as the built kernel reports it:
    ``csrc/flash_attention_bwd.cu`` owns its tiles and runs."""
    n = _bwd_query("flash_attention_bwd_scratch", (ctypes.c_int,) * 9,
                   ctypes.c_longlong)(b, sq, sk, h, hkv, d, int(causal),
                                      int(window or 0), int(bf16))
    if n < 0:
        raise ValueError("the flash backward kernel refuses the call")
    return n


def fwd_f32_tile(head_dim: int) -> tuple:
    """(k-steps NK, query rows a slot, keys a tile, S's chain in
    k-steps) of the forward's float32 kernel at ``head_dim``, as the
    built kernel reports it (``f32_tiles`` and ``F32_S_CHAIN`` mirror
    it)."""
    fn = library("flash_attention.cu").flash_attention_fwd_f32_tile
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = None
    out = [ctypes.c_int() for _ in range(4)]
    fn(head_dim, *(ctypes.byref(x) for x in out))
    return tuple(x.value for x in out)


def bwd_dq_tile(head_dim: int, bf16: bool) -> tuple:
    """(query rows, keys) of a tile of the backward's dQ walk at
    ``head_dim`` (key tiles start at multiples of keys), as the built
    kernel reports it: ``csrc/flash_attention_bwd.cu`` owns its tiles."""
    fn = _bwd_query("flash_attention_bwd_dq_tile",
                    (ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p), None)
    rows, keys = ctypes.c_int(), ctypes.c_int()
    fn(head_dim, int(bf16), ctypes.byref(rows), ctypes.byref(keys))
    return rows.value, keys.value
