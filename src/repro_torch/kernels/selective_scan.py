"""Mamba's selective scan on the card: the wrapper of the CUDA kernel in
``csrc/selective_scan.cu``.

The kernel replaces no TPU kernel. The JAX package runs the recurrence as
a ``jax.lax.scan`` of the cell ``step`` in ``repro/models/ssm.py``
(``mamba_apply``), which XLA compiles into one loop program; eager
PyTorch would launch about 8 kernels a token. It computes the function of
``ref.selective_scan_ref``, forward only (serving).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["selective_scan_fwd", "STATES"]

STATES = (8, 16)      # the state sizes the kernel is built for (n)


def selective_scan_fwd(x, dt, b, c, a, state=None):
    """x, dt: (B, S, di) and b, c: (B, S, n), float32 or bfloat16, one
    dtype; a: (di, n) float32 (= -exp(a_log)); state: None (zeros) or (B,
    di, n) float32; all contiguous on one card, S >= 1, n in ``STATES``.
    Returns ``(y, final_state)``: y (B, S, di) in x's dtype, the state (B,
    di, n) float32."""
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x: expected (B, S, di), got {tuple(x.shape)}")
    bsz, s, di = x.shape
    if s < 1:
        raise ValueError("the selective scan kernel needs S >= 1")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: float32 or bfloat16, got {x.dtype}")
    if a.dim() != 2 or a.shape[1] not in STATES:
        raise ValueError(f"a: expected (di, n) with n in {STATES}, got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    check("x", x, x.dtype, (bsz, s, di), dev)
    check("dt", dt, x.dtype, (bsz, s, di), dev)
    check("b", b, x.dtype, (bsz, s, n), dev)
    check("c", c, x.dtype, (bsz, s, n), dev)
    check("a", a, torch.float32, (di, n), dev)
    if state is not None:
        check("state", state, torch.float32, (bsz, di, n), dev)
    y = torch.empty_like(x)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    KERNELS["selective_scan"](
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), None if state is None else state.data_ptr(), bsz, s,
        di, n, int(x.dtype == torch.bfloat16), y.data_ptr(), h.data_ptr(),
        stream(dev))
    return y, h
