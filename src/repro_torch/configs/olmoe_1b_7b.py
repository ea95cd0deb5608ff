"""OLMoE-1B-7B [arXiv:2409.02060] — fully open MoE, 64 experts top-8.
Copied from ``repro/configs/olmoe_1b_7b.py``.

Assigned spec: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 (d_ff = per-expert hidden).  Full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    citation="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50_304,
    act="swiglu",
    qk_norm=True,
    rope="rope",
    rope_theta=10_000.0,
    n_experts=64,
    top_k=8,
    d_ff_expert=1024,
    capacity_factor=1.25,
)

REDUCED = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    citation="arXiv:2409.02060",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=512,
    act="swiglu",
    qk_norm=True,
    rope="rope",
    n_experts=4,
    top_k=2,
    d_ff_expert=64,
    capacity_factor=1.5,
)

register(FULL, REDUCED)
