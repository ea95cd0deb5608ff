"""The streaming epoch engine, as ``repro/tig/engine.py``: one training
epoch and one forward-only scoring pass over a chronological batch
program.

The JAX package runs an epoch as one ``lax.scan``; PyTorch runs eagerly, so
here an epoch is a Python loop over steps whose tensors stay on the
device. Each step flushes the pending messages, embeds, decodes, takes the
loss and its gradient with respect to the params only, and applies AdamW.
The carried state is detached at every step boundary: it is a constant to
the gradient, as in JAX. Losses stay on the device until the epoch ends.
The card's flush updates ``mem`` and ``last`` in place, so each scan
copies them once at entry: the caller's state stays as it was, as JAX's
immutable arrays do.

With ``tcsr`` (a staged ``ChronoNeighborIndex.device_export``) the batch
program is raw edge records (``plan="device"``) and each step samples its
neighbor grids at its batch index through ``kernels.ops.sample_roles``.

Not ported yet: the Alg.2 cycle and wrap-around modes
(``cycle_length`` / ``wrap_steps``, PAC's), the multi-layer windows, and
``collect_embeddings``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.optim import Optimizer
from repro_torch.tig.models import TIGConfig, step_loss
from repro_torch.tree import tree_map

__all__ = ["sample_batch_neighbors", "scan_train_epoch", "scan_eval_stream"]

_ROLES = ("src", "dst", "neg")


def _own_state(state: dict) -> dict:
    """``state`` with copies of the tensors the flush updates in place."""
    return {**state, "mem": state["mem"].clone(),
            "last": state["last"].clone()}


def _to_device(batches: dict, device) -> dict:
    """A (steps, ...) numpy batch program as tensors on ``device``,
    without the host-side ``labels``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batches.items() if k != "labels"}


def sample_batch_neighbors(batch: dict, tcsr: dict, batch_of: int,
                           cfg: TIGConfig) -> dict:
    """Add device-sampled neighbor grids to a raw-edge batch.

    One (3B,) sample over src ++ dst ++ neg (``ops.sample_roles``, one
    launch on the card), with dead rows (padding / invalid) sampling node
    0 and their ids / edge rows masked to -1 (times are left as sampled),
    exactly as the host planner fills its grids.
    """
    b = batch["src"].shape[0]
    nb, nt, ne = ops.sample_roles(tcsr, *(batch[r] for r in _ROLES),
                                  batch["valid"], batch_of,
                                  cfg.num_neighbors)
    out = dict(batch)
    for j, role in enumerate(_ROLES):
        rows = slice(j * b, (j + 1) * b)
        out[f"nbr_{role}"] = nb[rows]
        out[f"nbrt_{role}"] = nt[rows]
        out[f"nbre_{role}"] = ne[rows]
    return out


def scan_train_epoch(params, opt_state, state, batches, tables, *,
                     cfg: TIGConfig, opt: Optimizer, tcsr=None, device=None):
    """One training epoch over a (steps, ...) batch program.

    ``params``, ``opt_state``, ``state`` and ``tables`` are tensor dicts on
    ``device`` (default ``"cuda"``; raises if there is no card and the
    caller did not ask for the CPU); ``batches`` is a numpy program from
    ``build_batch_program``. Returns ``(params, opt_state, state, losses)``
    with ``losses`` a (steps,) tensor on the device.
    """
    device = resolve_device(device)
    bt = _to_device(batches, device)
    state = _own_state(state)
    losses = []
    for s in range(bt["src"].shape[0]):
        batch = {k: v[s] for k, v in bt.items()}
        if tcsr is not None:
            batch = sample_batch_neighbors(batch, tcsr, s, cfg)
        state = {k: v.detach() for k, v in state.items()}
        with torch.enable_grad():
            p = tree_map(lambda x: x.detach().requires_grad_(), params)
            loss, (state, _aux) = step_loss(p, state, batch, tables, cfg)
            loss.backward()
        # a leaf the loss does not reach (e.g. the time encoder of the
        # memory-only flavors) has a zero gradient, as in JAX
        grads = tree_map(
            lambda x: torch.zeros_like(x) if x.grad is None else x.grad, p)
        with torch.no_grad():
            params, opt_state = opt.apply(grads, opt_state, params)
        losses.append(loss.detach())
    state = {k: v.detach() for k, v in state.items()}
    return params, opt_state, state, torch.stack(losses)


@torch.no_grad()
def scan_eval_stream(params, state, batches, tables, *, cfg: TIGConfig,
                     tcsr=None, device=None):
    """Forward-only pass over a chronological stream (memory keeps
    updating, params frozen). Returns ``(state, aux)`` with ``aux`` holding
    (steps, B) ``pos_logit`` / ``neg_logit`` on the device."""
    device = resolve_device(device)
    bt = _to_device(batches, device)
    state = _own_state(state)
    pos, neg = [], []
    for s in range(bt["src"].shape[0]):
        batch = {k: v[s] for k, v in bt.items()}
        if tcsr is not None:
            batch = sample_batch_neighbors(batch, tcsr, s, cfg)
        _loss, (state, aux) = step_loss(params, state, batch, tables, cfg)
        pos.append(aux["pos_logit"])
        neg.append(aux["neg_logit"])
    return state, {"pos_logit": torch.stack(pos),
                   "neg_logit": torch.stack(neg)}
