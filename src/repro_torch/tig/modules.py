"""Neural building blocks for TIG models (functional params), as
``repro/tig/modules.py``: Message (MSG), State Update (UPD: GRU / RNN
cells), the temporal graph attention of the Embedding module (one layer,
or L layers stacked), the link decoder and TIGER's restarter head, each
an ``init`` / ``apply`` pair over a dict of tensors.

``init`` functions draw from an explicit ``torch.Generator``; they keep the
JAX package's shapes and scales, not its numbers.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_map

__all__ = ["dense_init", "dense", "mlp_init", "mlp", "restarter_init",
           "restarter", "gru_init", "gru", "rnn_init", "rnn", "attn_init",
           "temporal_attention", "stacked_attn_init",
           "stacked_temporal_attention"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device=None) -> dict:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
    return {
        "w": (w / math.sqrt(d_in)).to(device),
        "b": torch.zeros(d_out, dtype=torch.float32, device=device),
    }


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def mlp_init(gen: torch.Generator, dims: Sequence[int], device=None) -> dict:
    return {f"l{i}": dense_init(gen, dims[i], dims[i + 1], device)
            for i in range(len(dims) - 1)}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        if i + 1 < n:
            x = torch.relu(x)
    return x


def restarter_init(gen: torch.Generator, d_in: int, d_mem: int,
                   n_mem: int = 1, d_hidden: int | None = None,
                   device=None) -> dict:
    """TIGER's restarter head: an MLP from a node's last collected
    embedding (++ static features ++ Phi(dt since it)) back to its memory
    row(s); ``n_mem`` 2 regresses TIGE's dual memory in one head."""
    d_hidden = d_hidden if d_hidden is not None else max(2 * d_mem, d_in)
    return mlp_init(gen, [d_in, d_hidden, n_mem * d_mem], device)


def restarter(p: dict, x: torch.Tensor, d_mem: int,
              n_mem: int = 1) -> torch.Tensor:
    """Apply the restarter head: (..., d_in) -> (..., n_mem, d_mem)."""
    return mlp(p, x).reshape(x.shape[:-1] + (n_mem, d_mem))


def gru_init(gen: torch.Generator, d_in: int, d_h: int, device=None) -> dict:
    return {"xz": dense_init(gen, d_in, 3 * d_h, device),
            "hz": dense_init(gen, d_h, 3 * d_h, device)}


def gru(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Standard GRU cell, gates [r | z | n]: the paper's default UPD."""
    gx = dense(p["xz"], x)
    gh = dense(p["hz"], h)
    rx, zx, nx = gx.chunk(3, dim=-1)
    rh, zh, nh = gh.chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1.0 - z) * n + z * h


def rnn_init(gen: torch.Generator, d_in: int, d_h: int, device=None) -> dict:
    return {"x": dense_init(gen, d_in, d_h, device),
            "h": dense_init(gen, d_h, d_h, device)}


def rnn(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """tanh-RNN cell: Jodie's UPD module."""
    return torch.tanh(dense(p["x"], x) + dense(p["h"], h))


def attn_init(gen: torch.Generator, d_node: int, d_kv: int, d_out: int,
              n_heads: int, device=None) -> dict:
    """Temporal graph attention (TGN embedding module, one layer). Query
    dim d_node (node state ++ features ++ time enc); key/value dim d_kv
    (neighbor state ++ edge feat ++ time enc)."""
    if d_out % n_heads:
        raise ValueError(f"dim {d_out} is not a multiple of {n_heads} heads")
    return {
        "q": dense_init(gen, d_node, d_out, device),
        "k": dense_init(gen, d_kv, d_out, device),
        "v": dense_init(gen, d_kv, d_out, device),
        "o": dense_init(gen, d_node + d_out, d_out, device),
    }


def temporal_attention(
    p: dict,
    query_in: torch.Tensor,   # (B, d_node)
    kv_in: torch.Tensor,      # (B, K, d_kv)
    mask: torch.Tensor,       # (B, K) bool — True for real neighbors
    n_heads: int = 2,
) -> torch.Tensor:
    """Masked single-layer multi-head attention over sampled neighbors;
    the attention core goes through ``kernels.ops`` (the kernel on the
    card, the plain version on the CPU)."""
    b, k, _ = kv_in.shape
    q = dense(p["q"], query_in).reshape(b, n_heads, -1)       # (B, H, dh)
    kk = dense(p["k"], kv_in).reshape(b, k, n_heads, -1)      # (B, K, H, dh)
    vv = dense(p["v"], kv_in).reshape(b, k, n_heads, -1)
    ctx = ops.temporal_attention(q, kk, vv, mask).reshape(b, -1)
    return dense(p["o"], torch.cat([query_in, ctx], dim=-1))


def stacked_attn_init(gen: torch.Generator, n_layers: int, d_node: int,
                      d_kv: int, d_out: int, n_heads: int,
                      device=None) -> dict:
    """``attn_init``'s params for ``n_layers`` layers, every leaf stacked
    on a leading (L,) axis under the same keys (``q/w`` is (L, d_node,
    d_out)), the JAX package's layout. Every layer maps d_node -> d_out:
    layer l's query is layer l-1's output ++ the static query tail."""
    layers = [attn_init(gen, d_node, d_kv, d_out, n_heads, device)
              for _ in range(n_layers)]
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def stacked_temporal_attention(
    p_stack: dict,            # attn params, every leaf (L, ...)
    h0: torch.Tensor,         # (B, d) initial query state (memory read-out)
    extra: torch.Tensor,      # (B, d_extra) static query tail [nfeat ; Phi(0)]
    kv_in: torch.Tensor,      # (L, B, K, d_kv) per-layer neighbor features
    mask: torch.Tensor,       # (L, B, K) bool
    n_heads: int = 2,
) -> torch.Tensor:
    """L-layer temporal attention, the JAX package's ``lax.scan`` fold as
    a loop: layer l attends over its own neighbor grid with the query
    ``[h ; extra]``, h the previous layer's output (``h0`` first). At
    L = 1 this is ``temporal_attention`` on ``[h0 ; extra]``, bit for
    bit."""
    h = h0
    for layer in range(kv_in.shape[0]):
        p_l = tree_map(lambda x: x[layer], p_stack)
        h = temporal_attention(p_l, torch.cat([h, extra], dim=-1),
                               kv_in[layer], mask[layer], n_heads=n_heads)
    return h
