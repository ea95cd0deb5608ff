"""The language-model substrate of the port, so far the RWKV6, dense
attention and MoE decoder families: ``layers`` (linear, RMSNorm, RoPE,
plain and gated FFNs, decode attention), ``rwkv`` (time-mix and
channel-mix), ``moe`` (top-k routing, sort-based capacity dispatch),
``transformer`` (per-family blocks, qk-norm), ``model`` (init, forward,
decode cache, ``serve_step``, tied embeddings), ``sampling`` and
``serve`` (batched generation and its CLI). Copies of ``repro/models``;
the other families raise ``NotImplementedError``.
"""

from repro_torch.models.model import (forward, init_cache, init_params,
                                      serve_step)

__all__ = ["init_params", "forward", "init_cache", "serve_step"]
