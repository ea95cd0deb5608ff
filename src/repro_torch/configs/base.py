"""Language-model architecture configs: ``ArchConfig`` and its registry,
after ``repro/configs/base.py``.

``ArchConfig`` holds the fields that the families' configs set and that
their code reads (RWKV6, the dense and MoE decoders with gated FFNs,
qk-norm and tied embeddings, the hybrid attention + SSM decoder, the
encoder-decoder and the vision-language decoder), and the two training
fields that ``models.make_train_step`` reads (``remat``, ``microbatch``,
with the JAX package's defaults). Left out: ``attn_chunk``, the query
block of the JAX package's ``chunked_attention`` (the port attends
through the flash kernels, whose tiles are their own), and ``max_seq``,
which only the JAX package's dry run and sharding rules read. The
registry loads every language-model architecture of the JAX
package's (``_ARCH_MODULES``; ``speed-tig`` is the TIG workload, in
``configs/speed_tig.py``); each module registers its published
configuration and a reduced one (<= 2 layers, narrow) for the CPU
tests.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence

__all__ = ["ArchConfig", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture description. Families: RWKV6 (``rwkv=True``), dense
    attention (``family="dense"``), the decoder-only MoE
    (``family="moe"``), hymba's parallel attention and mamba heads
    (``family="hybrid"``, ``ssm_state > 0``), the encoder-decoder
    (``family="audio"``, ``enc_dec=True``) and the vision-language
    decoder (``family="vlm"``, ``rope="mrope"``)."""

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
    rope: str = "rope"                   # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Sequence[int] = ()   # per-axis rotary sections (M-RoPE)
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

    # encoder-decoder (seamless)
    enc_dec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: frames fed to the encoder (audio) or patch
    # embeddings prepended to the tokens (vision)
    frontend: str = "none"               # none | audio | vision
    frontend_tokens: int = 0             # the stub's default token count

    # training: checkpoint each layer (recompute its activations in the
    # backward), and how many microbatches a step's batch is split into
    # (their gradients averaged)
    remat: bool = True
    microbatch: int = 1

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

_ARCH_MODULES = ["minitron_4b", "rwkv6_1g6b", "gemma_7b", "qwen3_32b",
                 "seamless_m4t_medium", "qwen3_moe_235b_a22b",
                 "starcoder2_3b", "hymba_1g5b", "qwen2_vl_7b",
                 "olmoe_1b_7b"]


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
