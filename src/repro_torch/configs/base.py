"""Language-model architecture configs: ``ArchConfig`` and its registry,
after ``repro/configs/base.py``.

``ArchConfig`` holds the fields that the ported families' configs set and
that their code reads (RWKV6, the dense and MoE decoders with gated FFNs,
qk-norm and tied embeddings, and the hybrid attention + SSM decoder so
far); a field of the JAX package's
``ArchConfig`` comes back with the family that needs it (ROADMAP Queue
1). The registry loads only the architectures the port runs
(``_ARCH_MODULES``); each module registers its published configuration
and a reduced one (<= 2 layers, narrow) for the CPU tests.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ArchConfig", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture description; of the JAX package's families, so far
    RWKV6 (``rwkv=True``), dense attention (``family="dense"``), the
    decoder-only MoE (``family="moe"``) and hymba's parallel attention and
    mamba heads (``family="hybrid"``, ``ssm_state > 0``)."""

    name: str
    family: str
    citation: str

    n_layers: int
    d_model: int
    d_ff: int
    vocab: int

    # attention heads (the dense family; RWKV6 has its own WKV heads)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: Optional[int] = None       # default d_model // n_heads

    # attention / FFN details
    act: str = "swiglu"                  # swiglu | geglu | gelu | relu_sq
    qk_norm: bool = False
    rope: str = "rope"                   # the port runs "rope"
    rope_theta: float = 10_000.0
    window: Optional[int] = None         # sliding-window size (SWA)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # decode-time capacity multiple (vs perfectly uniform routing), used
    # when a decode batch is too large for the dropless dispatch
    decode_capacity_factor: float = 4.0
    router_aux_weight: float = 1e-2

    # SSM (mamba-style; hymba hybrid)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # RWKV6
    rwkv: bool = False
    rwkv_head_dim: int = 64

    # numerics: compute dtype (params are float32)
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


_REGISTRY: dict[str, "ArchConfig"] = {}
_REDUCED: dict[str, "ArchConfig"] = {}

# the other families of the JAX package's registry (audio,
# vision-language) are ROADMAP Queue 1
_ARCH_MODULES = ["minitron_4b", "rwkv6_1g6b", "gemma_7b", "qwen3_32b",
                 "qwen3_moe_235b_a22b", "starcoder2_3b", "olmoe_1b_7b",
                 "hymba_1g5b"]


def register(cfg: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
