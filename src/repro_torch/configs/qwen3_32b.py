"""Qwen3-32B [hf:Qwen/Qwen3-8B family scaling].
Copied from ``repro/configs/qwen3_32b.py``.

Assigned spec: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936 —
qk_norm (RMSNorm on q and k heads), GQA.  Full attention -> long_500k
skipped.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-32b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25_600,
    vocab=151_936,
    head_dim=128,
    act="swiglu",
    qk_norm=True,
    rope="rope",
    rope_theta=1_000_000.0,
)

REDUCED = ArchConfig(
    name="qwen3-32b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=768,
    vocab=512,
    head_dim=32,
    act="swiglu",
    qk_norm=True,
    rope="rope",
)

register(FULL, REDUCED)
