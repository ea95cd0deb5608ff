"""Functional AdamW / Adam / SGD over a dict of tensors, as
``repro/optim/adamw.py``: the same state layouts (``{"step", "mu",
"nu"}``, ``{"step", "mom"}``) and the same order of float operations, so
an update matches the JAX package's to rounding. ``lr`` is a float or a
schedule (``optim.schedules``), a callable of the step counter.

``opt.init(params) -> opt_state``; ``opt.update(grads, opt_state,
params) -> (updates, opt_state)``; ``opt.apply`` adds the updates and
returns new tensors. ``opt.apply_`` does the same float operations and
writes the results into the given params and state, leaf by leaf: the
global norm first, then each leaf's clip, moments, update and writes
before the next leaf (a leaf of more than ``APPLY_CHUNK`` elements a
slice at a time), so at most one slice's temporaries are alive where
``apply`` holds whole trees of them (about 38 GB at StarCoder2-3B's 3.18 B
float32 params). Elementwise operations give each element the same bits
whatever the slice, so ``apply_`` ends bitwise as ``apply``; it reads and
writes only the given tensors, as the captured epoch programs of
``tig/engine.py`` need. ``opt.minimize`` runs a full-batch fit of a loss.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "adam", "sgd", "clip_by_global_norm",
           "APPLY_CHUNK"]

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]
APPLY_CHUNK = 1 << 26        # elements a slice of ``apply_`` (256 MB f32)


def _lr_at(lr: Schedule, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _rebuild(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``slots``: the state's trees shaped like the params (the moments);
    ``prepare(grad leaves, state)`` forms the step's scalars (the step
    count, the learning rate, bias corrections, the clip scale);
    ``leaf(scalars, g, slot values, p)`` one leaf's (update, new slot
    values)."""

    init: Callable
    slots: tuple
    prepare: Callable
    leaf: Callable

    def update(self, grads, opt_state, params):
        """(updates, new_state); nothing given is written."""
        g_leaves = tree_leaves(grads)
        sc = self.prepare(g_leaves, opt_state)
        slot_leaves = [tree_leaves(opt_state[s]) for s in self.slots]
        ups, news = [], []
        for i, (g, p) in enumerate(zip(g_leaves, tree_leaves(params))):
            u, new = self.leaf(sc, g, tuple(s[i] for s in slot_leaves), p)
            ups.append(u)
            news.append(new)
        state = {"step": sc["step"]} | {
            name: _rebuild(params, [n[j] for n in news])
            for j, name in enumerate(self.slots)}
        return _rebuild(params, ups), state

    def apply(self, grads, opt_state, params):
        """One-call update returning (new_params, new_state)."""
        updates, new_state = self.update(grads, opt_state, params)
        return tree_map(lambda p, u: p + u, params, updates), new_state

    @torch.no_grad()
    def apply_(self, grads, opt_state, params) -> None:
        """``apply`` in place, leaf by leaf (see the module's docstring):
        the new slot values and step count are copied into ``opt_state``
        and the updates added to ``params``, so both end bitwise as
        ``apply`` returns them. Params and state must be contiguous."""
        g_leaves = tree_leaves(grads)
        sc = self.prepare(g_leaves, opt_state)
        slot_leaves = [tree_leaves(opt_state[s]) for s in self.slots]
        for i, (g, p) in enumerate(zip(g_leaves, tree_leaves(params))):
            mine = [p] + [s[i] for s in slot_leaves]
            if not all(x.is_contiguous() for x in mine):
                raise ValueError("apply_ writes params and state in place: "
                                 "they must be contiguous")
            g = g.reshape(-1)
            for lo in range(0, max(p.numel(), 1), APPLY_CHUNK):
                part = slice(lo, lo + APPLY_CHUNK)
                pc, *sc_in = (x.view(-1)[part] for x in mine)
                u, new = self.leaf(sc, g[part], tuple(sc_in), pc)
                for dst, src in zip(sc_in, new):
                    if src is not dst:
                        dst.copy_(src)
                pc.add_(u)
        opt_state["step"].copy_(sc["step"])

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


def _global_norm(g_leaves: list):
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in g_leaves))


def _clip_scale(gnorm, max_norm: float):
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns (clipped grads, norm)."""
    gnorm = _global_norm(tree_leaves(grads))
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g * scale, grads), gnorm


def _step_zero(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw(
    lr: Schedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
) -> Optimizer:
    """AdamW with optional global-norm clipping (decoupled weight decay)."""

    def init(params):
        return {"step": _step_zero(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def prepare(g_leaves, state):
        step = state["step"] + 1
        stepf = step.to(torch.float32)
        return {"step": step, "lr": _lr_at(lr, step),
                "bc1": 1.0 - torch.pow(b1, stepf),
                "bc2": 1.0 - torch.pow(b2, stepf),
                "clip": None if max_grad_norm is None else _clip_scale(
                    _global_norm(g_leaves), max_grad_norm)}

    def leaf(sc, g, slots, p):
        m, v = slots
        if sc["clip"] is not None:
            g = g * sc["clip"]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        lr_t = sc["lr"]
        u = -lr_t * (m / sc["bc1"]) / (torch.sqrt(v / sc["bc2"]) + eps)
        if weight_decay:
            u = u - lr_t * weight_decay * p
        return u, (m, v)

    return Optimizer(init=init, slots=("mu", "nu"), prepare=prepare,
                     leaf=leaf)


def adam(lr: Schedule = 1e-3, **kw) -> Optimizer:
    return adamw(lr=lr, weight_decay=0.0, **kw)


def sgd(lr: Schedule = 1e-2, momentum: float = 0.0) -> Optimizer:
    """SGD with optional (heavy-ball) momentum; state ``{"step",
    "mom"}``, ``mom`` left as it is without momentum."""

    def init(params):
        return {"step": _step_zero(params),
                "mom": tree_map(torch.zeros_like, params)}

    def prepare(g_leaves, state):
        step = state["step"] + 1
        return {"step": step, "lr": _lr_at(lr, step)}

    def leaf(sc, g, slots, p):
        (m,) = slots
        if momentum:
            m = momentum * m + g
            return -sc["lr"] * m, (m,)
        return -sc["lr"] * g, (m,)

    return Optimizer(init=init, slots=("mom",), prepare=prepare, leaf=leaf)
