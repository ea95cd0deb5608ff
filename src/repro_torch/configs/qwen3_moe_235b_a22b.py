"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family].
Copied from ``repro/configs/qwen3_moe_235b_a22b.py``.

Assigned spec: 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936,
MoE 128 experts top-8 (d_ff is the per-expert hidden dim).  Full attention
-> long_500k skipped.  Experts are sharded over the "model" mesh axis
(expert parallelism).
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,              # kept for config parity; experts use d_ff_expert
    vocab=151_936,
    head_dim=128,
    act="swiglu",
    qk_norm=True,
    rope="rope",
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    d_ff_expert=1536,
    capacity_factor=1.25,
)

REDUCED = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    head_dim=32,
    act="swiglu",
    qk_norm=True,
    rope="rope",
    n_experts=4,
    top_k=2,
    d_ff_expert=96,
    capacity_factor=1.5,
)

register(FULL, REDUCED)
