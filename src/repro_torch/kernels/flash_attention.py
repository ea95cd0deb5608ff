"""Flash attention on the card: wrapper of the CUDA kernel in
``csrc/flash_attention.cu``, which replaces the TPU kernel
``repro/kernels/flash_attention.py:_fa_kernel``. Its plain version is
``ref.flash_attention_ref``, which takes (B, H, S, D) with equal head
counts; the kernel reads the model's (B, Sq, H, D) q and (B, Sk, Hkv, D) k
and v, head h reading KV head h // (H // Hkv). Forward only, as in the JAX
package. The key length Sk may differ from Sq in non-causal calls without
a window (cross-attention over an encoder's memory), one step past the
TPU kernel, which takes one S.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["flash_attention_fwd", "check_key_length", "BLOCK_Q",
           "BLOCK_KV"]

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


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with Hkv dividing H (Sk =
    Sq where ``causal`` or ``window``); all bfloat16 (D in
    ``BF16_HEAD_DIMS``) or all float32 (D up to ``F32_MAX_HEAD_DIM``),
    contiguous, 16-byte aligned, on one card. ``window``: how many tokens
    a query may look back, itself included (None or 0: unbounded).
    Returns o (B, Sq, H, D) in q's dtype."""
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
    o = torch.empty_like(q)
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs 16-byte aligned "
                             f"data")
    KERNELS["flash_attention"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, sk, h, hkv, d,
        int(causal), int(window or 0), int(q.dtype == torch.bfloat16),
        o.data_ptr(), stream(dev))
    return o
