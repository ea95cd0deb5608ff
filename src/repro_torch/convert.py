"""Carry params, model state, AdamW state and the LM decode cache between
the two packages.

The JAX package's trees become numpy with
``jax.tree.map(np.asarray, tree)``: nested dicts of arrays under the same
keys as here (``upd/xz/w``, ``mem``, ``{"step", "mu", "nu"}``,
``layers/tm/wr/w``, ``layers/attn/wq/w``, ``wkv``, ``k``). These functions map such a tree to tensors
and back, key for key, dtype for dtype, so both packages can compute the
same thing from the same numbers. bfloat16 leaves (numpy's ``ml_dtypes``
type on the JAX side, in the decode cache) come in through float32, which
holds them exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "params_to_numpy", "state_from_numpy",
           "state_to_numpy", "opt_state_from_numpy", "opt_state_to_numpy",
           "cache_from_numpy"]


def _leaf_from_numpy(x, device):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _from_numpy(tree, device="cpu"):
    return tree_map(lambda x: _leaf_from_numpy(x, device), tree)


def _to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def params_from_numpy(tree, device="cpu") -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors."""
    return _from_numpy(tree, device)


def params_to_numpy(params: dict) -> dict:
    return _to_numpy(params)


def state_from_numpy(tree, device="cpu") -> dict:
    """Model state (``mem``, ``mem2``, ``last``, ``pend_*``) -> tensors."""
    return _from_numpy(tree, device)


def state_to_numpy(state: dict) -> dict:
    return _to_numpy(state)


def opt_state_from_numpy(tree, device="cpu") -> dict:
    """AdamW state ``{"step": int32 (), "mu": params, "nu": params}``."""
    return _from_numpy(tree, device)


def opt_state_to_numpy(opt_state: dict) -> dict:
    return _to_numpy(opt_state)


def cache_from_numpy(tree, device="cpu") -> dict:
    """LM decode cache, each leaf stacked over layers -> tensors: RWKV6's
    ``wkv`` float32 and ``tm_shift`` / ``cm_shift`` bfloat16, or the dense
    family's bfloat16 ``k`` / ``v`` (L, B, cache_len, Hkv, Dh)."""
    return _from_numpy(tree, device)
