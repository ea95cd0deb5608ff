"""Qwen2-VL-7B [arXiv:2409.12191]. Copied from
``repro/configs/qwen2_vl_7b.py``.

Assigned spec: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
M-RoPE. The language backbone: the ViT vision encoder and its projector
are the stub, whose precomputed patch embeddings are prepended to the
token embeddings, with the 3-D (temporal, height, width) position ids
that drive M-RoPE.
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    citation="arXiv:2409.12191",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab=152_064,
    head_dim=128,
    act="swiglu",
    rope="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w rotary sections (sum = dh/2)
    frontend="vision",
    frontend_tokens=1024,          # stubbed image patches
)

REDUCED = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    citation="arXiv:2409.12191",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    head_dim=64,
    act="swiglu",
    rope="mrope",
    mrope_sections=(8, 12, 12),
    frontend="vision",
    frontend_tokens=16,
)

register(FULL, REDUCED)
