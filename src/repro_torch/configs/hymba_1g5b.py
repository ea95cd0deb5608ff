"""Hymba-1.5B [arXiv:2411.13676]. Copied from
``repro/configs/hymba_1g5b.py``.

Assigned spec: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Every layer runs attention heads and Mamba (SSM) heads in
parallel on the same input and fuses their (normalized) outputs: the
paper's hybrid-head module. The attention is sliding-window (1024), so
decode keeps a ring-buffer KV cache beside the SSM state.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    citation="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    head_dim=64,
    act="swiglu",
    rope="rope",
    window=1024,          # hymba's local attention window
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

REDUCED = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    citation="arXiv:2411.13676",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=32,
    act="swiglu",
    rope="rope",
    window=32,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
)

register(FULL, REDUCED)
