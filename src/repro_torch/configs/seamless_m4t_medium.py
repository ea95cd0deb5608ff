"""SeamlessM4T-medium [arXiv:2308.11596]. Copied from
``repro/configs/seamless_m4t_medium.py``.

Assigned spec: 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206,
encoder-decoder, multimodal. The transformer backbone: a 12-layer encoder
over stubbed audio frame embeddings (the mel-spectrogram and conformer
feature extractor are the stub) and a 12-layer causal decoder with
cross-attention over the encoder memory. Decode keeps the decoder's KV
cache beside the encoder memory's K and V, projected once.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    citation="arXiv:2308.11596",
    n_layers=12,             # decoder layers
    n_enc_layers=12,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256_206,
    act="gelu",
    rope="none",             # learned/sinusoidal positions in the original
    frontend="audio",
    frontend_tokens=1024,    # stubbed audio frames fed to the encoder
)

REDUCED = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    citation="arXiv:2308.11596",
    n_layers=2,
    n_enc_layers=2,
    enc_dec=True,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    act="gelu",
    rope="none",
    frontend="audio",
    frontend_tokens=32,
)

register(FULL, REDUCED)
