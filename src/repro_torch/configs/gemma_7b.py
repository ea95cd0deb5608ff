"""Gemma-7B [arXiv:2403.08295].
Copied from ``repro/configs/gemma_7b.py``.

Assigned spec: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000 —
GeGLU activation, head_dim=256 (the 2B variant uses MQA; 7B is effectively
MHA with kv=16).  Full attention only -> long_500k skipped (DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="gemma-7b",
    family="dense",
    citation="arXiv:2403.08295",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24_576,
    vocab=256_000,
    head_dim=256,
    act="geglu",
    rope="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="gemma-7b",
    family="dense",
    citation="arXiv:2403.08295",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=1024,
    vocab=512,
    head_dim=64,
    act="geglu",
    rope="rope",
    tie_embeddings=True,
)

register(FULL, REDUCED)
