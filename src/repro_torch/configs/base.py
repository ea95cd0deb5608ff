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
which only the JAX package's sharding rules read (the port's dry run,
``launch/dryrun.py``, takes its lengths from ``INPUT_SHAPES``). The
analytic ``param_count`` / ``active_param_count`` (for 6 N D), the
``attention_free`` / ``sub_quadratic`` flags and ``INPUT_SHAPES`` are
copies of the JAX package's. The
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

__all__ = ["ArchConfig", "register", "get_config", "list_archs",
           "INPUT_SHAPES", "InputShape"]


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

    @property
    def attention_free(self) -> bool:
        return self.rwkv

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / linear attention / SWA)."""
        return self.rwkv or self.ssm_state > 0 or self.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + layers), for 6 N D; the
        JAX package's formula, which tracks ``init_params`` to < 2%."""
        d, v = self.d_model, self.vocab
        ff_mats = 3 if self.act in ("swiglu", "geglu") else 2
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.rwkv:
            # time-mix (r, k, v, g, o = 5 d^2 + decay LoRA) + channel-mix
            lora = max(32, d // 32)
            per_layer = 5 * d * d + 2 * d * lora \
                + 2 * d * self.d_ff + d * d
        else:
            dh = self.resolved_head_dim
            qkvo = d * (self.n_heads * dh) * 2 \
                + d * (self.n_kv_heads * dh) * 2
            per_layer += qkvo
            if self.is_moe:
                per_layer += self.n_experts * ff_mats * d \
                    * self.d_ff_expert + d * self.n_experts
            else:
                per_layer += ff_mats * d * self.d_ff
            if self.ssm_state:  # hymba parallel SSM heads
                di = self.ssm_expand * d
                dt_rank = max(16, d // 16)
                per_layer += d * 2 * di + di * self.ssm_conv \
                    + di * (dt_rank + 2 * self.ssm_state) \
                    + dt_rank * di + di * self.ssm_state \
                    + di * d + di
        n = emb + self.n_layers * per_layer
        if self.enc_dec:
            # encoder layers + decoder cross-attention
            enc = self.n_enc_layers * (4 * d * d + ff_mats * d * self.d_ff)
            cross = self.n_layers * 4 * d * d
            n += enc + cross
        return n

    def active_param_count(self) -> int:
        """MoE: params actually used per token (for 6 N_active D)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense_like = dataclasses.replace(
            self, n_experts=0, top_k=0,
            d_ff=self.top_k * self.d_ff_expert)
        return dense_like.param_count() + self.n_layers * d * self.n_experts


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

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
