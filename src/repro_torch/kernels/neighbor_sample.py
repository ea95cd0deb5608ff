"""Temporal neighbor sampling on the card: wrapper of the CUDA kernel in
``csrc/neighbor_sample.cu``, which replaces the TPU kernel
``repro/kernels/neighbor_sample.py:_sample_kernel``. Its plain version is
``ref.sample_ref``, bit for bit (integer ids and copied times).

Sampling happens before the differentiated part of a step, so there is no
backward.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._checks import check, stream
from repro_torch.kernels.build import KERNELS

__all__ = ["neighbor_sample_fwd"]


def _per_row(name, x, rows, device):
    """An int or an (R,) int32 tensor -> (pointer or None, scalar)."""
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        check(name, x, torch.int32, (rows,), device)
        return x.data_ptr(), 0
    return None, int(x)


def neighbor_sample_fwd(indptr, nbr, t, eidx, bat, nodes, batch_of, k: int,
                        window=0):
    """K most recent neighbors of ``nodes`` as of batch ``batch_of``.

    indptr: (N+1,) int32; nbr / t / eidx / bat: (pad + total,) int32 /
    float32 / int32 / int32 CUDA tensors of a staged T-CSR; nodes: (R,)
    int32, each in [0, N); batch_of, window: int or (R,) int32. Returns
    ((R, k) int32 ids, (R, k) float32 times, (R, k) int32 edge rows).
    """
    dev = nodes.device
    rows = nodes.shape[0] if nodes.dim() == 1 else -1
    total = nbr.shape[0]
    check("nodes", nodes, torch.int32, (rows,), dev)
    check("indptr", indptr, torch.int32, (None,), dev)
    check("nbr", nbr, torch.int32, (total,), dev)
    check("t", t, torch.float32, (total,), dev)
    check("eidx", eidx, torch.int32, (total,), dev)
    check("bat", bat, torch.int32, (total,), dev)
    b_ptr, b_val = _per_row("batch_of", batch_of, rows, dev)
    w_ptr, w_val = _per_row("window", window, rows, dev)
    ids = torch.empty((rows, k), dtype=torch.int32, device=dev)
    tms = torch.empty((rows, k), dtype=torch.float32, device=dev)
    eix = torch.empty((rows, k), dtype=torch.int32, device=dev)
    KERNELS["neighbor_sample"](
        indptr.data_ptr(), nbr.data_ptr(), t.data_ptr(), eidx.data_ptr(),
        bat.data_ptr(), nodes.data_ptr(), b_ptr, b_val, w_ptr, w_val, rows,
        k, ids.data_ptr(), tms.data_ptr(), eix.data_ptr(), stream(dev))
    return ids, tms, eix
