"""Serving-time token sampling (greedy / temperature / top-k / top-p), as
``repro/models/sampling.py``. The draw comes from an explicit
``torch.Generator``: it cannot reproduce ``jax.random.categorical``'s bits,
so only the greedy path matches the JAX package token for token."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_tokens", "filter_logits"]


def filter_logits(logits: torch.Tensor, *, temperature: float,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Float32 logits over temperature with everything outside the top-k
    and the top-p nucleus set to -1e30, as the JAX package masks them."""
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative mass >= top_p
        # (clamped: a sum rounded below top_p masks nothing, as JAX's
        # out-of-range gather does)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -1e30, logits)
    return logits


def sample_tokens(logits: torch.Tensor, *, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next tokens from (B, V) logits over the real vocab; temperature 0
    is greedy (the first maximum, as ``jnp.argmax``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
