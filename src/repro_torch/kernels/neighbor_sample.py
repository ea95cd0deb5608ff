"""Temporal neighbor sampling on the card: wrappers of the CUDA kernel in
``csrc/neighbor_sample.cu``, which replaces the TPU kernel
``repro/kernels/neighbor_sample.py:_sample_kernel``. Two forms of one
kernel: ``neighbor_sample_fwd`` over given nodes (plain version
``ref.sample_ref``) and ``sample_roles_fwd`` over a batch's src ++ dst ++
neg with its dead rows masked (plain version ``ref.sample_roles_ref``),
both bit for bit (integer ids and copied times).

Sampling happens before the differentiated part of a step, so there is no
backward.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["ROW_THREADS", "neighbor_sample_fwd", "sample_roles_fwd"]

# threads of a row, and so probes of a search round (TPR in the .cu)
ROW_THREADS = 32


def _per_row(name, x, rows, device):
    """An int, a 0-dim int32 tensor or an (R,) int32 tensor -> the
    kernel's (pointer or None, step, scalar). A 0-dim tensor on the card is
    read there by every row (step 0), so no value crosses to the host."""
    if isinstance(x, torch.Tensor) and (x.dim() > 0
                                        or x.device.type == "cuda"):
        check(name, x, torch.int32, (rows,) if x.dim() else (), device)
        return x.data_ptr(), int(x.dim() > 0), 0
    return None, 0, int(x)


def _sample(tcsr_args, nodes, roles, rows, batch_of, k, window, dev):
    """Check the T-CSR and the per-row arguments, launch once, return the
    (rows, k) outputs. ``nodes``: an (R,) tensor or None; ``roles``: the
    pointers (src, dst, neg, valid) and B, or None."""
    indptr, nbr, t, eidx, bat = tcsr_args
    total = nbr.shape[0]
    check("indptr", indptr, torch.int32, (None,), dev)
    check("nbr", nbr, torch.int32, (total,), dev)
    check("t", t, torch.float32, (total,), dev)
    check("eidx", eidx, torch.int32, (total,), dev)
    check("bat", bat, torch.int32, (total,), dev)
    b_ptr, b_step, b_val = _per_row("batch_of", batch_of, rows, dev)
    w_ptr, w_step, w_val = _per_row("window", window, rows, dev)
    ids = torch.empty((rows, k), dtype=torch.int32, device=dev)
    tms = torch.empty((rows, k), dtype=torch.float32, device=dev)
    eix = torch.empty((rows, k), dtype=torch.int32, device=dev)
    *role_ptrs, b = roles or (None, None, None, None, 0)
    KERNELS["neighbor_sample"](
        indptr.data_ptr(), nbr.data_ptr(), t.data_ptr(), eidx.data_ptr(),
        bat.data_ptr(), None if nodes is None else nodes.data_ptr(),
        *role_ptrs, b, b_ptr, b_step, b_val, w_ptr, w_step, w_val, rows, k,
        ids.data_ptr(), tms.data_ptr(), eix.data_ptr(), stream(dev))
    return ids, tms, eix


def neighbor_sample_fwd(indptr, nbr, t, eidx, bat, nodes, batch_of, k: int,
                        window=0):
    """K most recent neighbors of ``nodes`` as of batch ``batch_of``.

    indptr: (N+1,) int32; nbr / t / eidx / bat: (pad + total,) int32 /
    float32 / int32 / int32 CUDA tensors of a staged T-CSR; nodes: (R,)
    int32, each in [0, N); batch_of, window: int, 0-dim int32 tensor or
    (R,) int32. Returns ((R, k) int32 ids, (R, k) float32 times, (R, k)
    int32 edge rows).
    """
    dev = nodes.device
    rows = nodes.shape[0] if nodes.dim() == 1 else -1
    check("nodes", nodes, torch.int32, (rows,), dev)
    return _sample((indptr, nbr, t, eidx, bat), nodes, None, rows, batch_of,
                   k, window, dev)


def sample_roles_fwd(indptr, nbr, t, eidx, bat, src, dst, neg, valid,
                     batch_of, k: int):
    """``neighbor_sample_fwd`` over the 3B rows src ++ dst ++ neg of a
    batch, in one launch: a row whose id is < 0 or whose slot is not
    ``valid`` samples node 0 and gets -1 ids and edge rows (its times as
    sampled).

    src, dst, neg: (B,) int32; valid: (B,) bool; batch_of: int, 0-dim
    int32 tensor or (3B,) int32. Returns (3B, k) ids, times, edge rows.
    """
    dev = src.device
    b = src.shape[0] if src.dim() == 1 else -1
    for name, x in (("src", src), ("dst", dst), ("neg", neg)):
        check(name, x, torch.int32, (b,), dev)
    check("valid", valid, torch.bool, (b,), dev)
    roles = (src.data_ptr(), dst.data_ptr(), neg.data_ptr(),
             valid.data_ptr(), b)
    return _sample((indptr, nbr, t, eidx, bat), None, roles, 3 * b,
                   batch_of, k, 0, dev)
