"""The language-model substrate of the port, every family of the JAX
package's registry: ``layers`` (linear, RMSNorm, RoPE, M-RoPE, the
sinusoid table, plain and gated FFNs, decode attention, mamba's causal
conv), ``rwkv`` (time-mix and channel-mix), ``moe`` (top-k routing,
sort-based capacity dispatch), ``ssm`` (mamba's heads), ``transformer``
(per-family blocks, qk-norm, cross-attention), ``model`` (init, the
encoder, forward, decode cache, ``serve_step``, tied embeddings),
``sampling`` and ``serve`` (batched generation and its CLI), and
training (``loss_fn``, ``make_train_step``). Copies of ``repro/models``.
"""

from repro_torch.models.model import (encode, fill_enc_cache, forward,
                                      init_cache, init_params, loss_fn,
                                      make_train_step, serve_step)

__all__ = ["init_params", "encode", "fill_enc_cache", "forward",
           "init_cache", "serve_step", "loss_fn", "make_train_step"]
