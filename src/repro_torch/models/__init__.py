"""The language-model substrate of the port, so far the RWKV6 and dense
attention families: ``layers`` (linear, RMSNorm, RoPE, FFN, decode
attention), ``rwkv`` (time-mix and channel-mix), ``transformer``
(per-family blocks), ``model`` (init, forward, decode
cache, ``serve_step``), ``sampling`` and ``serve`` (batched generation and
its CLI). Copies of ``repro/models``; the other families raise
``NotImplementedError``.
"""

from repro_torch.models.model import (forward, init_cache, init_params,
                                      serve_step)

__all__ = ["init_params", "forward", "init_cache", "serve_step"]
