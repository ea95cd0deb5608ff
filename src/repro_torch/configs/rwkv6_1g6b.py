"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892]. Copied from ``repro/configs/rwkv6_1g6b.py``, with the
fields the port's ``ArchConfig`` has (the JAX config also sets n_heads =
n_kv_heads = d_model / 64, rope "none" and act "relu_sq", the channel-mix's
squared ReLU, which the RWKV6 blocks fix in code).

Assigned spec: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Head structure: d_model / 64 = 32 WKV heads of dim 64 (the published layout).
Supports long_500k (recurrent state is O(1) in sequence length).
"""

from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    citation="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab=65_536,
    rwkv=True,
    rwkv_head_dim=64,
)

REDUCED = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    citation="arXiv:2404.05892",
    n_layers=2,
    d_model=128,
    d_ff=448,
    vocab=512,
    rwkv=True,
    rwkv_head_dim=64,
)

register(FULL, REDUCED)
