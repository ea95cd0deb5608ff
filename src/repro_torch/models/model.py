"""Public LM API of the port: init / encode / fill_enc_cache / forward /
init_cache / serve_step and loss_fn / make_train_step, as
``repro/models/model.py``, for every family: RWKV6, dense, MoE, hybrid
(hymba), encoder-decoder (seamless) and vision-language (Qwen2-VL). On
the card the attention families train through the flash kernels'
forward and backward; RWKV6 and hymba train on the CPU only, for their
WKV and scan kernels have no backward yet (``kernels/ops.py`` raises).

Layer parameters are stacked over a leading layer axis, as the JAX package
stacks them for ``jax.lax.scan``, so ``repro_torch.convert`` carries a JAX
param tree and decode cache across key for key; here a Python loop over
the layer axis takes the scan's place.

Entry points take ``device=None``, which means ``"cuda"``, and raise
without a card; params and caches must already lie on that device.

Batch layouts: forward ``{"tokens": (B, S)}`` (positions 0..S-1); the
encoder-decoder adds ``"frames"`` (B, S_enc, d), the stubbed audio frame
embeddings; the vision-language family ``"patches"`` (B, F, d), the
stubbed image patch embeddings prepended to the tokens, and
``"positions3"`` (B, 3, F + S), M-RoPE's (t, h, w) positions. serve_step
``{"token": (B,), "pos": (B,)}`` with the cache of ``init_cache`` (for the
encoder-decoder filled by ``fill_enc_cache``; Qwen2-VL's text decode
takes t = h = w = pos). RWKV6's state holds no positions, so it reads no
``"pos"`` and ignores ``cache_len``. The seamless decoder gets no
positions at all, in ``forward`` or ``serve_step``, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (draw, linear_init, rmsnorm,
                                       rmsnorm_init, sinusoidal_positions)
from repro_torch.models.transformer import (block_apply, block_decode,
                                            block_init, init_block_cache,
                                            project_kv)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["init_params", "encode", "fill_enc_cache", "forward",
           "init_cache", "serve_step", "loss_fn", "make_train_step",
           "compute_dtype"]


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack(trees: list) -> dict:
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _layer(tree: dict, i: int) -> dict:
    return tree_map(lambda x: x[i], tree)


def _layers(tree: dict, n: int) -> list:
    """The ``n`` layers' param trees of a stacked tree, each stacked leaf
    split once by ``torch.unbind``: under autograd the backward of the
    split is one ``stack``, where indexing each layer (``_layer``) would
    write a zero-filled gradient of the whole (L, ...) stack for every
    layer. The values, and the gradients, are those of the indexing."""
    split = tree_map(lambda x: x.unbind(0), tree)
    return [tree_map(lambda xs: xs[i], split) for i in range(n)]


def _apply_layer(p, cfg: ArchConfig, x, positions, **kw):
    """``block_apply`` of one layer; under autograd with ``cfg.remat`` a
    checkpoint (its activations recomputed in the backward), the
    counterpart of ``jax.checkpoint`` over the JAX package's scan body."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block_apply, p, cfg, x, positions,
                          use_reentrant=False, **kw)
    return block_apply(p, cfg, x, positions, **kw)


def _check_on(name: str, tree: dict, device: torch.device) -> None:
    bad = {str(x.device) for x in tree_leaves(tree)
           if x.device.type != device.type}
    if bad:
        raise ValueError(f"{name} lie on {sorted(bad)}, the call runs on "
                         f"{device}; move them with repro_torch.tree.tree_map")


# ---------------------------------------------------------------- init

def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """Params under the JAX package's keys (``embed``, ``final_norm/g``,
    ``layers/tm/wr/w`` stacked over layers, ``lm_head/w``; no ``lm_head``
    with ``tie_embeddings``; the encoder-decoder's ``enc_layers`` and
    ``enc_norm``, and ``layers/cross`` and ``layers/ln_cross``), drawn
    from ``gen`` on its own device and placed on ``device``."""
    device = resolve_device(device)
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": draw(gen, (cfg.vocab, d), d ** -0.5, device),
        "final_norm": rmsnorm_init(d, device),
    }
    params["layers"] = _stack([
        block_init(gen, cfg, cross=cfg.enc_dec, device=device)
        for _ in range(cfg.n_layers)])
    if cfg.enc_dec:
        params["enc_layers"] = _stack([block_init(gen, cfg, device=device)
                                       for _ in range(cfg.n_enc_layers)])
        params["enc_norm"] = rmsnorm_init(d, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, d, cfg.vocab, device=device)
    return params


# ------------------------------------------------------------- forward

def _embed_tokens(params, cfg: ArchConfig, tokens):
    # gather, then cast: the same values as the JAX package's cast of the
    # whole table followed by the gather, without casting every row
    return params["embed"][tokens].to(compute_dtype(cfg))


def _logits(params, cfg: ArchConfig, x):
    if cfg.tie_embeddings:                 # the embedding table, transposed
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"]["w"].to(x.dtype)


def encode(params, frames, cfg: ArchConfig, device=None):
    """The encoder stack over (stubbed) frame embeddings (B, S_enc, d):
    the frames cast to bfloat16 plus the sinusoid table rounded to
    bfloat16, non-causal layers, ``enc_norm``. Returns the encoder memory
    (B, S_enc, d), bfloat16 whatever ``cfg.dtype`` is, as in the JAX
    package."""
    device = resolve_device(device)
    _check_on("params", params, device)
    x = torch.as_tensor(frames).to(device=device, dtype=torch.bfloat16)
    b, s_enc, d = x.shape
    x = x + sinusoidal_positions(s_enc, d, device=device).to(x.dtype)
    positions = torch.arange(s_enc, device=device).broadcast_to(b, s_enc)
    for p in _layers(params["enc_layers"], cfg.n_enc_layers):
        x, _ = _apply_layer(p, cfg, x, positions, causal=False)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def fill_enc_cache(params, cache, frames, cfg: ArchConfig, device=None):
    """Serving prefill of the encoder-decoder: run the encoder once and
    project every decoder layer's cross-attention K and V of its memory
    into the cache (``enc_k``, ``enc_v``: (L, B, S_enc, Hkv, Dh)
    bfloat16); decode steps then never touch the encoder. Returns the new
    cache; the one passed in is not changed."""
    enc_out = encode(params, frames, cfg, device)
    kv = [project_kv(_layer(params["layers"], i)["cross"], cfg, enc_out)
          for i in range(cfg.n_layers)]
    return {**cache,
            "enc_k": torch.stack([k for k, _ in kv]).to(torch.bfloat16),
            "enc_v": torch.stack([v for _, v in kv]).to(torch.bfloat16)}


def forward(params, batch, cfg: ArchConfig, device=None):
    """Returns (logits (B, S, vocab) in the compute dtype, aux): aux is
    the MoE router's load-balance loss summed over the layers, a float32
    scalar (0 for the other families), as the JAX package's scan sums
    it. The encoder-decoder encodes ``batch["frames"]`` first; the
    vision-language family prepends ``batch["patches"]`` and returns the
    logits of the text positions only."""
    device = resolve_device(device)
    _check_on("params", params, device)
    enc_out = (encode(params, batch["frames"], cfg, device) if cfg.enc_dec
               else None)
    tokens = torch.as_tensor(batch["tokens"]).to(device)
    x = _embed_tokens(params, cfg, tokens)                 # (B, S, d)
    n_front = 0
    if cfg.frontend == "vision" and "patches" in batch:
        patches = torch.as_tensor(batch["patches"]).to(device=device,
                                                       dtype=x.dtype)
        n_front = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    b, s, _ = x.shape
    if cfg.rope == "mrope":
        positions = torch.as_tensor(batch["positions3"]).to(device)
    else:
        positions = torch.arange(s, device=device).broadcast_to(b, s)
    # the layers in order: the JAX package's scan over stacked params
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for p in _layers(params["layers"], cfg.n_layers):
        x, a = _apply_layer(p, cfg, x, positions, enc_out=enc_out)
        aux = aux + a
    x = rmsnorm(params["final_norm"], x[:, n_front:], cfg.norm_eps)
    return _logits(params, cfg, x), aux


# -------------------------------------------------------------- decode

def init_cache(cfg: ArchConfig, batch: int, cache_len=None,
               device=None, enc_len: int = 0) -> dict:
    """Decode state, stacked over layers: each leaf (L, B, ...). The
    attention families: K and V caches of ``cache_len`` slots (the prompt
    plus the tokens to generate), at most ``cfg.window`` (a ring buffer
    then); hybrid also mamba's conv and SSM states; the encoder-decoder
    with ``enc_len`` also the encoder memory's K and V for
    ``fill_enc_cache`` to write (without them decode skips
    cross-attention, as in the JAX package). RWKV6's state does not grow
    with the sequence and reads no ``cache_len``."""
    device = resolve_device(device)
    if not cfg.rwkv:
        if cache_len is None:
            raise ValueError(f"{cfg.name}: init_cache needs cache_len")
        if cfg.window is not None:
            cache_len = min(cache_len, cfg.window)
    one = init_block_cache(cfg, batch, cache_len, device, enc_len)
    return tree_map(lambda x: x[None].repeat(
        (cfg.n_layers,) + (1,) * x.dim()), one)


def serve_step(params, cache, batch, cfg: ArchConfig, device=None):
    """One decode step: batch {"token": (B,), "pos": (B,)} ("pos", the
    token's absolute position, for the attention families).

    Returns (logits (B, vocab), new_cache); the cache passed in is not
    changed, and the encoder memory's K and V, which decode never
    writes, are passed on as they are."""
    device = resolve_device(device)
    _check_on("params", params, device)
    _check_on("cache", cache, device)
    tokens = torch.as_tensor(batch["token"]).to(device)[:, None]   # (B, 1)
    pos = None if cfg.rwkv else torch.as_tensor(batch["pos"]).to(
        device=device, dtype=torch.int64)
    x = _embed_tokens(params, cfg, tokens)
    fixed = {k: cache[k] for k in ("enc_k", "enc_v") if k in cache}
    new = []
    for i in range(cfg.n_layers):
        x, c = block_decode(_layer(params["layers"], i), cfg, x, pos,
                            _layer(cache, i))
        new.append({k: v for k, v in c.items() if k not in fixed})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, 0]
    return _logits(params, cfg, x), {**_stack(new), **fixed}


# --------------------------------------------------------------- train

def loss_fn(params, batch, cfg: ArchConfig, device=None):
    """Masked next-token cross-entropy over the real vocab, in float32:
    ``batch`` is ``forward``'s plus ``"targets"`` (B, S), a target < 0
    masked out. Returns (ce + router_aux_weight * aux, (ce, aux)), as the
    JAX package's ``loss_fn``."""
    device = resolve_device(device)
    logits, aux = forward(params, batch, cfg, device)
    targets = torch.as_tensor(batch["targets"]).to(device=device,
                                                   dtype=torch.int64)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).to(torch.float32)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + cfg.router_aux_weight * aux, (ce, aux)


def _grads(params, batch, cfg: ArchConfig, device):
    """(loss, gradient leaves in ``tree_leaves`` order) of ``loss_fn``."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _ = loss_fn(live, batch, cfg, device)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), list(grads)


def make_train_step(cfg: ArchConfig, opt, device=None):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``
    over ``loss_fn``, as the JAX package's. ``cfg.microbatch`` m splits
    the batch into m equal slices along its first axis, and the step
    averages their gradients and losses (summed in slice order from
    zeros); ``cfg.remat`` checkpoints each layer. ``opt`` (``optim``)
    updates ``params`` and ``opt_state`` in place, leaf by leaf
    (``Optimizer.apply_``), and the step returns the same tensors: a
    caller that keeps the old params passes a copy."""
    device = resolve_device(device)

    def step(params, opt_state, batch):
        _check_on("params", params, device)
        m = cfg.microbatch
        if m > 1:
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            rows = next(iter(batch.values())).shape[0]
            if rows % m:
                raise ValueError(f"a batch of {rows} does not split into "
                                 f"{m} microbatches")
            n = rows // m
            grads = [torch.zeros_like(x) for x in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(m):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, g_i = _grads(params, mb, cfg, device)
                grads = [a + b for a, b in zip(grads, g_i)]
                loss = loss + l_i
            grads = [g / m for g in grads]
            loss = loss / m
        else:
            loss, grads = _grads(params, batch, cfg, device)
        it = iter(grads)
        opt.apply_(tree_map(lambda _: next(it), params), opt_state, params)
        return params, opt_state, {"loss": loss}

    return step
