"""TIG models as instances of one general architecture (paper Fig.6), as
``repro/tig/models.py``.

    flavor   MSG            AGG    UPD        Embedding
    jodie    id-concat      mean   RNN        time projection
    dyrep    id-concat      mean   RNN        identity (memory read-out)
    tgn      id-concat/MLP  mean   GRU        temporal graph attention
    tige     id-concat/MLP  mean   GRU+RNN    temporal graph attention over
                                   (dual mem) the dual-memory mean

Training follows TGN's message store: the raw messages of batch n are
stashed and applied to memory at the start of batch n+1, so the loss of
batch n+1 backpropagates through the MSG / UPD modules.

State is a dict of tensors:

    mem      (N+1, d)   node memory (row N = dump row for padding)
    mem2     (N+1, d)   second memory (TIGE only; zeros otherwise)
    last     (N+1,)     last-update timestamps
    pend_ids (2B,)      node rows touched by the previous batch
    pend_raw (2B, dr)   their raw (pre-MSG) messages
    pend_t   (2B,)      their event times

The state is a constant to the gradient: it enters each step detached
(``engine`` detaches it at the step boundary), as JAX differentiates
``step_loss`` with respect to ``params`` only. The GRU flavors flush
through ``kernels.ops.fused_flush`` and the attention core goes through
``kernels.ops.temporal_attention``: on the card the hand-written kernels,
on the CPU their plain versions.

With ``n_layers`` L > 1 the TGN / TIGE embedding is L stacked attention
layers (``modules.stacked_temporal_attention``): the neighbor grids come
(L, B, K), layer l's grid the (L-1-l)-th most recent K-window, and the
params of ``attn`` carry a leading (L,) axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (scatter_last, scatter_memory,
                                     segment_mean)
from repro_torch.tig.modules import (attn_init, dense, dense_init, gru_init,
                                     mlp, mlp_init, rnn, rnn_init,
                                     stacked_attn_init,
                                     stacked_temporal_attention,
                                     temporal_attention)
from repro_torch.tig.time_encode import init_time_encoder, time_encode

__all__ = ["TIGConfig", "init_params", "init_state", "step_loss",
           "flush_pending", "embed_nodes", "FLAVORS"]

FLAVORS = ("jodie", "dyrep", "tgn", "tige")


@dataclasses.dataclass(frozen=True)
class TIGConfig:
    """Hyper-parameters of the general TIG architecture (the JAX
    package's fields without its two TPU kernel switches)."""

    flavor: str = "tgn"
    dim: int = 64              # memory == embedding dim
    dim_time: int = 32
    dim_edge: int = 16
    dim_node: int = 16
    num_neighbors: int = 10    # K most-recent temporal neighbors
    n_heads: int = 2
    message_fn: str = "id"     # "id" (concat) or "mlp"
    dim_msg: int = 64          # MSG output dim when message_fn == "mlp"
    batch_size: int = 200
    n_classes: int = 0         # >0 adds the node-classification head
    n_layers: int = 1          # attention layers (TGN / TIGE)

    def __post_init__(self):
        if self.flavor not in FLAVORS:
            raise ValueError(f"flavor={self.flavor!r}: expected {FLAVORS}")
        if self.message_fn not in ("id", "mlp"):
            raise ValueError(f"message_fn={self.message_fn!r}")
        if self.n_layers < 1:
            raise ValueError(f"n_layers={self.n_layers}: expected >= 1")

    @property
    def raw_msg_dim(self) -> int:
        # [s_self ; s_other ; Phi(dt) ; e_ij]
        return 2 * self.dim + self.dim_time + self.dim_edge

    @property
    def msg_dim(self) -> int:
        return self.dim_msg if self.message_fn == "mlp" else self.raw_msg_dim

    @property
    def uses_attention(self) -> bool:
        return self.flavor in ("tgn", "tige")

    @property
    def updater(self) -> str:
        return "rnn" if self.flavor in ("jodie", "dyrep") else "gru"


# --------------------------------------------------------------------- init

def init_params(gen: torch.Generator, cfg: TIGConfig, device=None) -> dict:
    """Parameters under the JAX package's keys (``upd/xz/w``,
    ``attn/q/b``, ``dec/l0/w`` ...), drawn from ``gen``."""
    p: dict = {"time": init_time_encoder(cfg.dim_time, device=device)}
    if cfg.message_fn == "mlp":
        p["msg"] = mlp_init(gen, [cfg.raw_msg_dim, cfg.msg_dim, cfg.msg_dim],
                            device)
    if cfg.updater == "gru":
        p["upd"] = gru_init(gen, cfg.msg_dim, cfg.dim, device)
    else:
        p["upd"] = rnn_init(gen, cfg.msg_dim, cfg.dim, device)
    if cfg.flavor == "tige":
        p["upd2"] = rnn_init(gen, cfg.msg_dim, cfg.dim, device)
    if cfg.uses_attention:
        d_q = cfg.dim + cfg.dim_node + cfg.dim_time
        d_kv = cfg.dim + cfg.dim_edge + cfg.dim_time
        if cfg.n_layers == 1:
            p["attn"] = attn_init(gen, d_q, d_kv, cfg.dim, cfg.n_heads,
                                  device)
        else:
            p["attn"] = stacked_attn_init(gen, cfg.n_layers, d_q, d_kv,
                                          cfg.dim, cfg.n_heads, device)
    else:
        if cfg.flavor == "jodie":
            p["jodie_w"] = torch.zeros(cfg.dim, device=device)
        p["emb"] = dense_init(gen, cfg.dim + cfg.dim_node, cfg.dim, device)
    p["dec"] = mlp_init(gen, [2 * cfg.dim, cfg.dim, 1], device)
    if cfg.n_classes > 0:
        p["cls"] = mlp_init(gen, [cfg.dim, cfg.dim, cfg.n_classes], device)
    return p


def init_state(cfg: TIGConfig, num_local_nodes: int, device=None) -> dict:
    n, b, d = num_local_nodes, cfg.batch_size, cfg.dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mem": torch.zeros((n + 1, d), **f32),
        "mem2": torch.zeros((n + 1, d), **f32),
        "last": torch.zeros((n + 1,), **f32),
        "pend_ids": torch.full((2 * b,), n, dtype=torch.int32, device=device),
        "pend_raw": torch.zeros((2 * b, cfg.raw_msg_dim), **f32),
        "pend_t": torch.zeros((2 * b,), **f32),
    }


# ---------------------------------------------------------------- memory ops

def _read_memory(cfg: TIGConfig, mem, mem2, ids):
    if cfg.flavor == "tige":
        return 0.5 * (mem[ids] + mem2[ids])
    return mem[ids]


def flush_pending(params: dict, cfg: TIGConfig, state: dict) -> dict:
    """Apply the stashed messages of the previous batch to memory (the
    differentiable half of the message store), then clear them. On the
    card the GRU flavors' flush writes ``state["mem"]`` and
    ``state["last"]`` in place (``ops.fused_flush``)."""
    n_dump = state["mem"].shape[0] - 1
    ids = state["pend_ids"]
    raw = state["pend_raw"]
    ts = state["pend_t"]

    msg = mlp(params["msg"], raw) if cfg.message_fn == "mlp" else raw
    if cfg.updater == "gru":
        p = params["upd"]
        mem, last, mbar = ops.fused_flush(
            ids, msg, ts, state["mem"], state["last"],
            p["xz"]["w"], p["hz"]["w"], p["xz"]["b"], p["hz"]["b"])
    else:
        # mean-aggregate messages per node (paper: "simply mean message")
        mbar = segment_mean(ids, msg, n_dump)
        s_new = rnn(params["upd"], mbar, state["mem"][ids])
        mem = scatter_memory(state["mem"], ids, s_new)
        last = scatter_last(state["last"], ids, ts)

    mem2 = state["mem2"]
    if cfg.flavor == "tige":
        s2_new = rnn(params["upd2"], mbar, state["mem2"][ids])
        mem2 = scatter_memory(state["mem2"], ids, s2_new)

    return {
        "mem": mem,
        "mem2": mem2,
        "last": last,
        "pend_ids": torch.full_like(ids, n_dump),
        "pend_raw": torch.zeros_like(raw),
        "pend_t": torch.zeros_like(ts),
    }


def _stash_messages(cfg: TIGConfig, state: dict, ids_s, ids_d, t, efeat,
                    valid, time_params) -> dict:
    """Compute raw messages for the current batch and stash them (consumed
    by ``flush_pending`` at the start of the next step)."""
    n_dump = state["mem"].shape[0] - 1
    s_i = state["mem"][ids_s]
    s_j = state["mem"][ids_d]
    phi_i = time_encode(time_params, t - state["last"][ids_s])
    phi_j = time_encode(time_params, t - state["last"][ids_d])
    raw_i = torch.cat([s_i, s_j, phi_i, efeat], dim=-1)
    raw_j = torch.cat([s_j, s_i, phi_j, efeat], dim=-1)
    ids = torch.cat([ids_s, ids_d])
    ids = torch.where(torch.cat([valid, valid]), ids, n_dump)
    return {
        **state,
        "pend_ids": ids.to(torch.int32),
        "pend_raw": torch.cat([raw_i, raw_j]),
        "pend_t": torch.cat([t, t]),
    }


# ----------------------------------------------------------------- embedding

def embed_nodes(
    params: dict,
    cfg: TIGConfig,
    state: dict,
    tables: dict,                # {"efeat": (E+1, d_e), "nfeat": (N+1, d_n)}
    ids: torch.Tensor,           # (B,) local ids (dump row for padding)
    t: torch.Tensor,             # (B,)
    nbr_ids: torch.Tensor,       # (B, K) or (L, B, K) — -1: empty slot
    nbr_t: torch.Tensor,         # (B, K) or (L, B, K)
    nbr_eidx: torch.Tensor,      # (B, K) or (L, B, K) — -1: empty slot
) -> torch.Tensor:
    """The Embedding module: emb_i(t) from current memory + temporal
    neighborhood (paper Fig.6, right). (L, B, K) grids, one a layer,
    go through the L-layer fold."""
    n_dump = state["mem"].shape[0] - 1
    s = _read_memory(cfg, state["mem"], state["mem2"], ids)
    nf = tables["nfeat"][ids]
    dt = t - state["last"][ids]

    if cfg.flavor == "jodie":
        # time-projected embedding (1 + dt*w) ⊙ W[s ; v], dt through log1p
        base = dense(params["emb"], torch.cat([s, nf], dim=-1))
        dt_n = torch.log1p(dt.clamp(min=0.0))
        return (1.0 + dt_n[:, None] * params["jodie_w"]) * base
    if cfg.flavor == "dyrep":
        return dense(params["emb"], torch.cat([s, nf], dim=-1))

    # TGN / TIGE: temporal graph attention over the K recent neighbors
    # (t[:, None] broadcasts over (B, K) and (L, B, K) grids alike)
    mask = nbr_ids >= 0
    nids = torch.where(mask, nbr_ids, n_dump)
    eids = torch.where(nbr_eidx >= 0, nbr_eidx, tables["efeat"].shape[0] - 1)
    s_nbr = _read_memory(cfg, state["mem"], state["mem2"], nids)
    e_nbr = tables["efeat"][eids]
    phi_nbr = time_encode(params["time"],
                          torch.where(mask, t[:, None] - nbr_t, 0.0))
    phi_self = time_encode(params["time"], torch.zeros_like(t))
    kv_in = torch.cat([s_nbr, e_nbr, phi_nbr], dim=-1)
    extra = torch.cat([nf, phi_self], dim=-1)
    if nbr_ids.dim() == 3:
        return stacked_temporal_attention(params["attn"], s, extra, kv_in,
                                          mask, n_heads=cfg.n_heads)
    return temporal_attention(params["attn"], torch.cat([s, extra], dim=-1),
                              kv_in, mask, n_heads=cfg.n_heads)


# -------------------------------------------------------------------- step

def step_loss(params: dict, state: dict, batch: dict, tables: dict,
              cfg: TIGConfig):
    """One training step body: flush pending -> embed -> decode -> loss,
    then stash this batch's messages. Returns (loss, (new_state, aux)).

    ``batch`` keys: src, dst, neg (B,) int32 local ids (-1 = padding);
    t (B,) float32; eidx (B,) int32; valid (B,) bool; and per role r in
    {src, dst, neg}: nbr_{r} (B,K) ids, nbrt_{r} (B,K) times, nbre_{r}
    (B,K) edge rows, or (L,B,K) each when ``cfg.n_layers`` L > 1 (the
    roles join on dim -2 either way).
    """
    n_dump = state["mem"].shape[0] - 1
    valid = batch["valid"]

    def remap(x):
        return torch.where((x >= 0) & valid, x, n_dump).to(torch.int32)

    ids_s, ids_d, ids_n = (remap(batch[r]) for r in ("src", "dst", "neg"))
    e_dump = tables["efeat"].shape[0] - 1
    efeat = tables["efeat"][torch.where(batch["eidx"] >= 0, batch["eidx"],
                                        e_dump)]

    # 1) apply the previous batch's messages (grads reach MSG/UPD here)
    state = flush_pending(params, cfg, state)

    # 2) embeddings of the three roles in one (3B,) call
    b = ids_s.shape[0]
    emb_all = embed_nodes(
        params, cfg, state, tables,
        torch.cat([ids_s, ids_d, ids_n]),
        batch["t"].repeat(3),
        *(torch.cat([batch[f"{key}_{r}"] for r in ("src", "dst", "neg")],
                    dim=-2)
          for key in ("nbr", "nbrt", "nbre")),
    )
    e_src, e_dst, e_neg = emb_all[:b], emb_all[b:2 * b], emb_all[2 * b:]

    # 3) link-prediction loss: pos and neg pairs in one (2B, 2d) decoder
    dec_in = torch.cat([torch.cat([e_src, e_dst], dim=-1),
                        torch.cat([e_src, e_neg], dim=-1)])
    logits = mlp(params["dec"], dec_in)[:, 0]
    pos_logit, neg_logit = logits[:b], logits[b:]
    v = valid.to(torch.float32)
    nv = v.sum().clamp(min=1.0)
    loss = ((F.softplus(-pos_logit) + F.softplus(neg_logit)) * v).sum() \
        / (2.0 * nv)

    # 4) stash this batch's raw messages for the next step
    new_state = _stash_messages(cfg, state, ids_s, ids_d, batch["t"],
                                efeat, valid, params["time"])
    aux = {"pos_logit": pos_logit, "neg_logit": neg_logit,
           "src_embed": e_src, "dst_embed": e_dst, "valid": valid}
    return loss, (new_state, aux)
