"""StarCoder2-3B [arXiv:2402.19173]. Copied from
``repro/configs/starcoder2_3b.py``.

Assigned spec: 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 —
GQA, RoPE, native sliding-window attention (window 4096); decode keeps a
ring-buffer KV cache of at most the window.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    citation="arXiv:2402.19173",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12_288,
    vocab=49_152,
    head_dim=128,
    act="gelu",
    rope="rope",
    rope_theta=100_000.0,
    window=4096,
)

REDUCED = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    citation="arXiv:2402.19173",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=1024,
    vocab=512,
    head_dim=32,
    act="gelu",
    rope="rope",
    window=64,
)

register(FULL, REDUCED)
