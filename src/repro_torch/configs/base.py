"""Language-model architecture configs: ``ArchConfig`` and its registry,
after ``repro/configs/base.py``.

``ArchConfig`` holds the fields that the ported families' configs set and
that their code reads; a field of the JAX package's ``ArchConfig`` comes
back with the family that needs it (ROADMAP Queue 1). The registry loads
only the architectures the port runs so far (``_ARCH_MODULES``); each
module registers its published configuration and a reduced one (<= 2
layers, narrow) for the CPU tests.
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture description; of the JAX package's families, so far
    RWKV6 (``rwkv=True``)."""

    name: str
    family: str
    citation: str

    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    norm_eps: float = 1e-6

    # RWKV6
    rwkv: bool = False
    rwkv_head_dim: int = 64

    # numerics: compute dtype (params are float32)
    dtype: str = "bfloat16"


_REGISTRY: dict[str, "ArchConfig"] = {}
_REDUCED: dict[str, "ArchConfig"] = {}

# the other families of the JAX package's registry are ROADMAP Queue 1
_ARCH_MODULES = ["rwkv6_1g6b"]


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
