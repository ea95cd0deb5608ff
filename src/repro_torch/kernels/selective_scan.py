"""Mamba's selective scan on the card: the wrapper of the CUDA kernels in
``csrc/selective_scan.cu``.

The kernels replace no TPU kernel. The JAX package runs the recurrence as
a ``jax.lax.scan`` of the cell ``step`` in ``repro/models/ssm.py``
(``mamba_apply``), which XLA compiles into one loop program; eager
PyTorch would launch about 8 kernels a token. Both forms compute the
function of ``ref.selective_scan_ref``.

``selective_scan_fwd`` dispatches by shape, one launch a call either way:
S >= ``CHUNK`` with channels a multiple of ``CHANNEL_MULTIPLE`` (and
16-byte aligned tensors) goes to the chunked form (``GROUP`` channels of
one batch row a block, ``THREADS_PER_CHANNEL`` threads a channel, each a
run of ``ITEMS`` tokens, composed by a warp scan with a carry from chunk
to chunk), anything else, decode among it, to the per-state form (a thread
a (batch, channel, state index)). Both count on
``KERNELS["selective_scan"]``.

``selective_scan_bwd`` wraps the backward kernel of
``csrc/selective_scan_bwd.cu`` (four launches: each 128-token chunk's
pairs from runs of 16 tokens composed by a warp scan, a scan over the
chunks for h and the cotangent at their edges, the chunks' gradients, the
sums over channel groups and chunks), which replaces XLA's gradient of
the JAX package's scan. ``ops.SelectiveScan`` runs it where a gradient is
wanted; ``ref.selective_scan_bwd_ref`` is its plain version and
``ref.selective_scan_bwd_scanned_ref`` its order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS, library

__all__ = ["selective_scan_fwd", "selective_scan_chunked_fwd",
           "selective_scan_state_fwd", "selective_scan_bwd", "takes_chunked",
           "STATES", "GROUP", "THREADS_PER_CHANNEL", "ITEMS", "CHUNK",
           "CHANNEL_MULTIPLE", "bwd_tiles"]

STATES = (8, 16)      # the state sizes the kernels are built for (n)
# the chunked form's constants, as in csrc/selective_scan.cu
GROUP = 16                                 # channels a block
THREADS_PER_CHANNEL = 8
ITEMS = 16                                 # consecutive tokens a thread
CHUNK = THREADS_PER_CHANNEL * ITEMS        # tokens a chunk; the threshold
CHANNEL_MULTIPLE = 8                       # 16-byte copies of x, dt and y


def takes_chunked(x, dt, b, c) -> bool:
    """Whether ``selective_scan_fwd`` runs the chunked form on these
    inputs: S of at least one chunk, channels a multiple of
    ``CHANNEL_MULTIPLE``, and x, dt, b and c 16-byte aligned."""
    return (x.dim() == 3 and x.shape[1] >= CHUNK
            and x.shape[2] % CHANNEL_MULTIPLE == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, dt, b, c)))


def selective_scan_fwd(x, dt, b, c, a, state=None):
    """x, dt: (B, S, di) and b, c: (B, S, n), float32 or bfloat16, one
    dtype; a: (di, n) float32 (= -exp(a_log)); state: None (zeros) or (B,
    di, n) float32; all contiguous on one card, S >= 1, n in ``STATES``.
    Returns ``(y, final_state)``: y (B, S, di) in x's dtype, the state (B,
    di, n) float32. The chunked form where ``takes_chunked``, else the
    per-state one."""
    form = 1 if takes_chunked(x, dt, b, c) else 0
    return _launch(form, x, dt, b, c, a, state)


def selective_scan_chunked_fwd(x, dt, b, c, a, state=None):
    """The chunked form at any S >= 1 (arguments as ``selective_scan_fwd``;
    channels a multiple of ``CHANNEL_MULTIPLE``, x, dt, b and c 16-byte
    aligned)."""
    return _launch(1, x, dt, b, c, a, state)


def selective_scan_state_fwd(x, dt, b, c, a, state=None):
    """The per-state form at any S >= 1 (arguments as
    ``selective_scan_fwd``)."""
    return _launch(0, x, dt, b, c, a, state)


def _launch(form, x, dt, b, c, a, state):
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
    if form == 1:
        if di % CHANNEL_MULTIPLE:
            raise ValueError(f"the chunked form needs channels a multiple "
                             f"of {CHANNEL_MULTIPLE}, got {di}")
        for name, t in (("x", x), ("dt", dt), ("b", b), ("c", c)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the chunked form needs a 16-byte "
                                 f"aligned tensor")
    y = torch.empty_like(x)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    KERNELS["selective_scan"](
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), None if state is None else state.data_ptr(), bsz, s,
        di, n, int(x.dtype == torch.bfloat16), form, y.data_ptr(),
        h.data_ptr(), stream(dev))
    return y, h


def bwd_tiles() -> tuple:
    """(tokens of a chunk, between two stored carries; channels a block
    of the gradients' launch) of the backward, as the built kernel reports
    them: ``csrc/selective_scan_bwd.cu`` owns its tiles."""
    fn = library("selective_scan_bwd.cu").selective_scan_bwd_tiles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None
    chunk, group = ctypes.c_int(), ctypes.c_int()
    fn(ctypes.byref(chunk), ctypes.byref(group))
    return chunk.value, group.value


def selective_scan_bwd(x, dt, b, c, a, dy, state=None, dstate=None):
    """The backward kernel: x, dt, b, c, a and state as
    ``selective_scan_fwd`` takes them; dy: (B, S, di) float32, y's
    cotangent; dstate: None (zeros) or (B, di, n) float32, the final
    state's. Returns ``(dx, ddt, db, dc, da, dstate0)``: dx, ddt, db, dc
    in x's dtype; da (di, n) float32; dstate0 (B, di, n) float32 where
    ``state`` is given, else None."""
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
    check("dy", dy, torch.float32, (bsz, s, di), dev)
    if state is not None:
        check("state", state, torch.float32, (bsz, di, n), dev)
    if dstate is not None:
        check("dstate", dstate, torch.float32, (bsz, di, n), dev)
    chunk, group = bwd_tiles()
    nc, groups = -(-s // chunk), -(-di // group)
    f32 = dict(dtype=torch.float32, device=dev)
    hb = torch.empty((bsz, nc, di, n), **f32)
    gb, part_da = torch.empty_like(hb), torch.empty_like(hb)
    csdt = torch.empty((bsz, nc, di), **f32)
    part_db = torch.empty((bsz, groups, s, n), **f32)
    part_dc = torch.empty_like(part_db)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty((di, n), **f32)
    dh0 = None if state is None else torch.empty((bsz, di, n), **f32)
    KERNELS["selective_scan_bwd"](
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), dy.data_ptr(),
        None if state is None else state.data_ptr(),
        None if dstate is None else dstate.data_ptr(), bsz, s, di, n,
        int(x.dtype == torch.bfloat16), nc, groups, hb.data_ptr(),
        gb.data_ptr(), csdt.data_ptr(), part_db.data_ptr(),
        part_dc.data_ptr(),
        part_da.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), None if dh0 is None else dh0.data_ptr(), stream(dev))
    return dx, ddt, db, dc, da, dh0
