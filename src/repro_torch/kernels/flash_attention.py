"""Flash attention on the card: wrapper of the CUDA kernel in
``csrc/flash_attention.cu``, which replaces the TPU kernel
``repro/kernels/flash_attention.py:_fa_kernel``. Its plain version is
``ref.flash_attention_ref``, which takes (B, H, S, D) with equal head
counts; the kernel reads the model's (B, S, H, D) q and (B, S, Hkv, D) k
and v, head h reading KV head h // (H // Hkv). Forward only, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["flash_attention_fwd", "BLOCK_Q", "BLOCK_KV"]

# the bf16 kernel's instantiations: StarCoder2-3B and its REDUCED config
BF16_HEAD_DIMS = (32, 128)
# the bf16 kernel's tiles, mirroring csrc/flash_attention.cu (ROWS_WG and
# BKV): a block covers BLOCK_Q query rows of two heads of one KV group
# (an even number of query heads per KV head, as in StarCoder2-3B and its
# REDUCED config; else 2 BLOCK_Q rows of one head) and walks the key tiles
# of BLOCK_KV from the one holding its first row's window start to the one
# holding its last row
BLOCK_Q = 64
BLOCK_KV = 128
F32_MAX_HEAD_DIM = 256


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) with Hkv dividing H; all
    bfloat16 (D in ``BF16_HEAD_DIMS``) or all float32 (D up to
    ``F32_MAX_HEAD_DIM``), contiguous, 16-byte aligned, on one card.
    ``window``: how many tokens a query may look back, itself included
    (None or 0: unbounded). Returns o (B, S, H, D) in q's dtype."""
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, S, H, D), got {tuple(q.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2] if k.dim() == 4 else -1
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
    check("k", k, q.dtype, (b, s, hkv, d), dev)
    check("v", v, q.dtype, (b, s, hkv, d), dev)
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
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, h, hkv, d,
        int(causal), int(window or 0), int(q.dtype == torch.bfloat16),
        o.data_ptr(), stream(dev))
    return o
