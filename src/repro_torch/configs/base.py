"""Language-model architecture configs: ``ArchConfig`` and its registry,
after ``repro/configs/base.py``.

``ArchConfig`` holds the fields that the ported families' configs set and
that their code reads (RWKV6 and the dense attention family so far); a
field of the JAX package's ``ArchConfig`` comes back with the family that
needs it (ROADMAP Queue 1). The registry loads only the architectures the
port runs (``_ARCH_MODULES``); each module registers its published
configuration and a reduced one (<= 2 layers, narrow) for the CPU tests.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ArchConfig", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture description; of the JAX package's families, so far
    RWKV6 (``rwkv=True``) and dense attention (``family="dense"``)."""

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
    act: str = "swiglu"                  # the dense path runs "gelu"
    rope: str = "rope"                   # the dense path runs "rope"
    rope_theta: float = 10_000.0
    window: Optional[int] = None         # sliding-window size (SWA)
    norm_eps: float = 1e-6

    # RWKV6
    rwkv: bool = False
    rwkv_head_dim: int = 64

    # numerics: compute dtype (params are float32)
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)


_REGISTRY: dict[str, "ArchConfig"] = {}
_REDUCED: dict[str, "ArchConfig"] = {}

# the other families of the JAX package's registry are ROADMAP Queue 1
_ARCH_MODULES = ["rwkv6_1g6b", "starcoder2_3b"]


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
