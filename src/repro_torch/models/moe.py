"""Mixture-of-Experts FFN, as ``repro/models/moe.py``'s single-device
``moe_apply``: top-k routing with sort-based capacity dispatch.

The flattened (token, expert) assignments are sorted by expert id (a
stable sort, so within an expert the tokens keep their order) and
scattered into a capacity-bucketed (E, C + 1, d) buffer, slot C being
the overflow dump; the expert products are batched GEMMs over it (no
kernel of their own: the JAX package leaves them to XLA), and each
kept assignment's output, weighted by its renormalised gate, is summed
back into its token. The router runs in float32 and returns the Switch
load-balance aux loss E * sum_e f_e P_e beside the output.

The combine is deterministic. The JAX package scatter-adds the
contributions (``y.at[st].add``); on the card the counterpart,
``index_add_``, sums with atomics in an order that changes from call to
call. Every token has exactly ``top_k`` assignments, so here the sorted
contributions go back to (T, k, d) in token order and are summed over k
in a fixed order. The dump slot is filled with zeros (the JAX package
leaves whichever dropped token was written last there): a dropped
assignment's gate is multiplied by 0 either way.

Not ported: ``moe_apply_sharded`` (expert parallelism over a mesh with
``shard_map``); the port runs on one card.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import _act, draw, linear_init

__all__ = ["moe_init", "moe_apply", "capacity"]


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int,
             act: str, device=None) -> dict:
    """``router/w`` (d, E), experts ``wi`` (E, d, d_ff), ``wo`` (E, d_ff,
    d) and, for the gated activations, ``wg`` (E, d, d_ff)."""
    def experts(din, dout):
        return draw(gen, (n_experts, din, dout), din ** -0.5, device)

    p = {"router": linear_init(gen, d, n_experts, device=device),
         "wi": experts(d, d_ff)}
    if act in ("swiglu", "geglu"):
        p["wg"] = experts(d, d_ff)
    p["wo"] = experts(d_ff, d)
    return p


def capacity(t: int, top_k: int, n_experts: int, capacity_factor: float,
             dropless: bool = False) -> int:
    """Slots an expert has: ``ceil(T k / E)`` times the capacity factor,
    cut to an int as the JAX package cuts it; ``T`` when dropless."""
    if dropless:
        return t
    return int(max(1, -(-t * top_k // n_experts) * capacity_factor))


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=n)`` for ids below ``n``, with a
    shape that does not depend on the data (the dry run's ``meta``
    tensors have none); integer sums, the same in any order."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int, act: str,
              capacity_factor: float = 1.25, dropless: bool = False):
    """x: (T, d) -> (y (T, d) in x's dtype, aux float32 scalar).

    An expert takes at most C = ``capacity(T, top_k, E, capacity_factor,
    dropless)`` assignments, in token order; the others are dropped
    (contribute zero)."""
    t, d = x.shape
    e = p["wi"].shape[0]
    dev, dtype = x.device, x.dtype
    logits = x.float() @ p["router"]["w"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)            # (T, k)
    # renormalise the chosen gates (the Qwen / Mixtral convention)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # the load-balance aux loss (Switch eqs. 4-6)
    me = probs.mean(dim=0)                                     # (E,)
    ce = _counts(top_i.reshape(-1), e).float() / (t * top_k)
    aux = e * torch.sum(me * ce)

    # sort-based dispatch
    cap = capacity(t, top_k, e, capacity_factor, dropless)
    flat_e = top_i.reshape(-1)                                 # (T k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_w = top_p.reshape(-1).to(dtype)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = _counts(se, e)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(t * top_k, device=dev) - starts[se]    # rank in expert
    keep = pos < cap
    slot = torch.where(keep, pos, cap)                         # cap: the dump

    buf = torch.zeros((e, cap + 1, d), dtype=dtype, device=dev)
    buf[se, slot] = torch.where(keep[:, None], x[st], 0.0)
    h = _act(act, torch.bmm(buf, p["wi"].to(dtype)))
    if "wg" in p:
        h = h * torch.bmm(buf, p["wg"].to(dtype))
    yb = torch.bmm(h, p["wo"].to(dtype))                       # (E, C+1, d)

    contrib = yb[se, slot] * sw[:, None] * keep[:, None].to(dtype)
    # back to token order, (T, k, d), and summed over k in a fixed order
    per_token = torch.empty_like(contrib).index_copy_(0, order, contrib)
    per_token = per_token.view(t, top_k, d)
    y = per_token[:, 0]
    for j in range(1, top_k):
        y = y + per_token[:, j]
    return y, aux
