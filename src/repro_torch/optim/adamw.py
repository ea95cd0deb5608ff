"""Functional AdamW over a dict of tensors, as ``repro/optim/adamw.py``:
the same state layout ``{"step", "mu", "nu"}`` and the same order of float
operations, so an update matches the JAX package's to rounding.

``opt.init(params) -> opt_state``; ``opt.update(grads, opt_state,
params) -> (updates, opt_state)``; ``opt.apply`` adds the updates and
returns new tensors. ``opt.apply_`` does the same float operations and
writes the results into the given params and state, for a step that reads
and writes only fixed tensors (the captured epoch programs of
``tig/engine.py``). ``opt.minimize`` runs a full-batch fit of a loss.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable

    def apply(self, grads, opt_state, params):
        """One-call update returning (new_params, new_state)."""
        updates, new_state = self.update(grads, opt_state, params)
        return tree_map(lambda p, u: p + u, params, updates), new_state

    @torch.no_grad()
    def apply_(self, grads, opt_state, params) -> None:
        """``apply`` in place: the new moments and step count are copied
        into ``opt_state`` and the updates added to ``params``, so both
        end bitwise as ``apply`` returns them."""
        updates, new_state = self.update(grads, opt_state, params)
        for dst, src in zip(tree_leaves(opt_state), tree_leaves(new_state)):
            dst.copy_(src)
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u)

    def minimize(self, params, loss_fn: Callable, steps: int):
        """``steps`` full-batch updates from fresh optimizer state, each
        on the gradient of the scalar ``loss_fn(params)`` with respect to
        every leaf. ``params`` must be leaf tensors. Returns the new
        params and the loss before the last update (0 with no step)."""
        state = self.init(params)
        loss = torch.zeros(())
        for _ in range(steps):
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            loss = loss_fn(params)
            grads = iter(torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                params, state = self.apply(
                    tree_map(lambda _: next(grads), params), state,
                    tree_map(torch.Tensor.detach, params))
        return params, loss.detach()


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns (clipped grads, norm)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def adamw(
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
) -> Optimizer:
    """AdamW with optional global-norm clipping (decoupled weight decay)."""

    def init(params):
        leaf = tree_leaves(params)[0]
        return {
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                      state["nu"], grads)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p
            return u

        updates = tree_map(upd, mu, nu, params)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init=init, update=update)
