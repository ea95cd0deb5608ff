"""Minitron-4B — width/depth-pruned Nemotron-4 [arXiv:2407.14679].
Copied from ``repro/configs/minitron_4b.py``.

Assigned spec: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="minitron-4b",
    family="dense",
    citation="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256_000,
    head_dim=128,        # pruned from Nemotron-4 15B (kept head_dim)
    act="swiglu",
    rope="rope",
    rope_theta=10_000.0,
)

REDUCED = ArchConfig(
    name="minitron-4b",
    family="dense",
    citation="arXiv:2407.14679",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=512,
    vocab=512,
    head_dim=32,
    act="swiglu",
    rope="rope",
)

register(FULL, REDUCED)
