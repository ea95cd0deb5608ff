"""TIGER's restarter: node memory rebuilt from embeddings, as
``repro/tig/restart.py``.

``run_protocol`` warms memory by replaying the train stream, O(E) work
that every resume and mid-stream evaluation pays again. TIGER (arXiv
2302.06057) regresses the memory back from interaction-time embeddings:
a small head maps a node's last collected embedding (++ its static
features ++ Phi of the time since that embedding) to its memory row, and
memory is restarted anywhere with one O(N) forward pass.

* ``EmbeddingBank``: each node's latest embedding, event time and a seen
  mask (numpy);
* ``collect_bank``: one forward-only replay of the train split with
  ``collect_embeddings`` that fills a bank and returns the replay's true
  warm state (the head's target, and the oracle it is compared with);
* ``fit_restarter``: full-batch MSE fit of the head (its own trainable
  Phi, ``modules.restarter``) on the seen rows, with AdamW;
* ``restart_memory``: an eval-ready state from the bank alone;
* ``build_restarter``: collect + fit;
* ``save_restarter`` / ``load_restarter``: a crash-atomic npz bundle
  under the JAX package's keys (``bank|emb``, ``params|head|l0|w`` ...),
  so a bundle written by either package loads in the other.

The restart drops the final train batch's pending messages and carries
the head's fit error, so its metrics agree with the replay's within a
tolerance, not bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import _atomic_write, _paths
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.tig import engine
from repro_torch.tig.batching import build_batch_program
from repro_torch.tig.models import TIGConfig, init_state
from repro_torch.tig.modules import restarter, restarter_init
from repro_torch.tig.time_encode import init_time_encoder, time_encode
from repro_torch.tree import tree_map

__all__ = ["EmbeddingBank", "Restarter", "collect_bank", "fit_restarter",
           "restart_memory", "build_restarter", "save_restarter",
           "load_restarter"]


def _n_mem(cfg: TIGConfig) -> int:
    return 2 if cfg.flavor == "tige" else 1


@dataclasses.dataclass
class EmbeddingBank:
    """Latest interaction-time embedding per node, on the host.

    ``emb[i]`` is node i's embedding at its most recent event, ``t[i]``
    that event's (rescaled) time, ``seen[i]`` whether any event touched
    i; ``t_end`` is the stream time the bank is warm to (the restarter's
    time encoding measures from it)."""

    emb: np.ndarray     # (N, d) float32
    t: np.ndarray       # (N,) float32
    seen: np.ndarray    # (N,) bool
    t_end: float = 0.0

    @classmethod
    def empty(cls, num_nodes: int, dim: int) -> "EmbeddingBank":
        return cls(emb=np.zeros((num_nodes, dim), np.float32),
                   t=np.zeros((num_nodes,), np.float32),
                   seen=np.zeros((num_nodes,), bool))

    def update(self, ids: np.ndarray, ts: np.ndarray,
               embs: np.ndarray) -> None:
        """Absorb a chronological run of events (row order = event
        order): the last occurrence of each node wins."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        ts = np.asarray(ts, np.float32)
        embs = np.asarray(embs, np.float32)
        # first occurrence in the reversed array = last occurrence forward
        uniq, first_rev = np.unique(ids[::-1], return_index=True)
        rows = len(ids) - 1 - first_rev
        self.emb[uniq] = embs[rows]
        self.t[uniq] = ts[rows]
        self.seen[uniq] = True
        self.t_end = max(self.t_end, float(ts.max()))


@dataclasses.dataclass
class Restarter:
    """A fitted restarter bundle: head params (``{"time": Phi params,
    "head": mlp params}``, tensors) and the bank they were fit on."""

    params: dict
    cfg: TIGConfig
    bank: EmbeddingBank
    fit_mse: float = float("nan")


def collect_bank(params, cfg: TIGConfig, splits, tables: dict, *,
                 seed: int = 0, device=None) -> tuple[EmbeddingBank, dict]:
    """One forward-only replay of ``splits.train`` (host-planned, through
    ``make_eval_epoch(cfg, collect_embeddings=True)``), src and dst
    collected: returns ``(bank, replay_state)``, ``replay_state`` the true
    post-train memory. ``tables`` are tensors on ``device`` (default
    ``"cuda"``; raises without a card); the scoring graphs that read them
    are released afterwards."""
    device = resolve_device(device)
    tr = splits.train
    batches, _ = build_batch_program(tr, cfg, np.random.default_rng(seed),
                                     neg_pool=splits.neg_pool)
    eval_fn = engine.make_eval_epoch(cfg, collect_embeddings=True,
                                     device=device)
    state, aux = eval_fn(params, init_state(cfg, splits.num_nodes, device),
                         batches, tables)
    se = aux["src_embed"].cpu().numpy()
    de = aux["dst_embed"].cpu().numpy()
    engine.release(tables)

    d = cfg.dim
    valid = np.asarray(batches["valid"]).reshape(-1).astype(bool)
    src = np.asarray(batches["src"]).reshape(-1)
    dst = np.asarray(batches["dst"]).reshape(-1)
    ts = np.asarray(batches["t"]).reshape(-1)
    # src and dst interleaved per edge: within a batch the event order
    # holds for both endpoints (the last write per node wins)
    ids = np.stack([src, dst], axis=1).reshape(-1)
    embs = np.stack([se.reshape(-1, d), de.reshape(-1, d)],
                    axis=1).reshape(-1, d)
    times = np.repeat(ts, 2)
    keep = np.repeat(valid, 2)

    bank = EmbeddingBank.empty(splits.num_nodes, d)
    bank.update(ids[keep], times[keep], embs[keep])
    return bank, state


def _head_inputs(rst_params: dict, emb, nfeat, dt) -> torch.Tensor:
    """[emb ; nfeat ; Phi(dt)], the head's input rows."""
    return torch.cat([emb, nfeat, time_encode(rst_params["time"], dt)],
                     dim=-1)


def _seen_inputs(bank: EmbeddingBank, rows: np.ndarray, tables: dict):
    """The bank's embeddings, the node features and the time since each
    row's embedding, as tensors on the tables' device."""
    dev = tables["nfeat"].device
    emb = torch.from_numpy(bank.emb[rows]).to(dev)
    nfeat = tables["nfeat"][torch.from_numpy(rows).to(dev)]
    dt = torch.from_numpy(np.maximum(bank.t_end - bank.t[rows], 0.0)
                          .astype(np.float32)).to(dev)
    return emb, nfeat, dt


def fit_restarter(bank: EmbeddingBank, target_state: dict, cfg: TIGConfig,
                  tables: dict, *, seed: int = 0, steps: int = 400,
                  lr: float = 1e-2, params: Optional[dict] = None
                  ) -> Restarter:
    """Fit the head by full-batch MSE on the bank's seen rows against the
    replay-warm memory ``target_state``, ``steps`` AdamW steps at ``lr``,
    on the tables' device. ``params`` gives the initial ``{"time",
    "head"}`` params (e.g. converted from the JAX package's); by default
    the TGAT time encoding and a head drawn from a ``torch.Generator``
    seeded with ``seed``."""
    dev = tables["nfeat"].device
    n_mem = _n_mem(cfg)
    if params is None:
        d_in = cfg.dim + cfg.dim_node + cfg.dim_time
        params = {"time": init_time_encoder(cfg.dim_time, device=dev),
                  "head": restarter_init(torch.Generator().manual_seed(seed),
                                         d_in, cfg.dim, n_mem, device=dev)}
    params = tree_map(
        lambda v: torch.as_tensor(v).detach().to(dev, copy=True), params)
    rows = np.flatnonzero(bank.seen)
    if rows.size == 0:
        return Restarter(params=params, cfg=cfg, bank=bank)

    at = torch.from_numpy(rows).to(dev)
    keys = ("mem", "mem2")[:n_mem]
    y = torch.stack([target_state[k].detach().to(dev)[at] for k in keys],
                    dim=1)                              # (S, n_mem, d)
    emb, nfeat, dt = _seen_inputs(bank, rows, tables)

    def loss_fn(p):
        pred = restarter(p["head"], _head_inputs(p, emb, nfeat, dt),
                         cfg.dim, n_mem)
        return torch.mean((pred - y) ** 2)

    params, loss = adamw(lr=lr).minimize(params, loss_fn, steps)
    return Restarter(params=params, cfg=cfg, bank=bank, fit_mse=float(loss))


@torch.no_grad()
def restart_memory(rst: Restarter, num_nodes: int, tables: dict) -> dict:
    """The replayless warm-up: an eval-ready state from the bank in one
    O(N) head forward, on the tables' device: predicted memory on the
    seen rows, zeros elsewhere, ``last`` the bank's event times, an empty
    pending-message store (the final batch's stashed messages are what
    the restart loses, as in TIGER)."""
    cfg, bank = rst.cfg, rst.bank
    if bank.emb.shape[0] != num_nodes:
        raise ValueError(f"bank holds {bank.emb.shape[0]} nodes, caller "
                         f"expects {num_nodes}")
    dev = tables["nfeat"].device
    n_mem = _n_mem(cfg)
    state = init_state(cfg, num_nodes, dev)
    rows = np.flatnonzero(bank.seen)
    if rows.size == 0:
        return state
    emb, nfeat, dt = _seen_inputs(bank, rows, tables)
    params = tree_map(lambda v: v.to(dev), rst.params)
    pred = restarter(params["head"], _head_inputs(params, emb, nfeat, dt),
                     cfg.dim, n_mem)
    at = torch.from_numpy(rows).to(dev)
    state["mem"][at] = pred[:, 0]
    state["last"][at] = torch.from_numpy(bank.t[rows]).to(dev)
    if n_mem == 2:
        state["mem2"][at] = pred[:, 1]
    return state


def build_restarter(params, cfg: TIGConfig, splits, tables: dict, *,
                    seed: int = 0, steps: int = 400, lr: float = 1e-2,
                    device=None) -> tuple[Restarter, dict]:
    """Collect the train split's embedding bank with ``params`` and fit
    the head. Returns ``(restarter, replay_state)``, the second the true
    replay-warm memory (the oracle)."""
    bank, replay_state = collect_bank(params, cfg, splits, tables,
                                      seed=seed, device=device)
    rst = fit_restarter(bank, replay_state, cfg, tables, seed=seed,
                        steps=steps, lr=lr)
    return rst, replay_state


# ------------------------------------------------------------ persistence

def save_restarter(path: str, rst: Restarter) -> str:
    """Crash-atomic npz bundle of the head params and the bank, under the
    JAX package's keys (load needs no target tree)."""
    flat = {"bank|emb": rst.bank.emb, "bank|t": rst.bank.t,
            "bank|seen": rst.bank.seen.astype(np.uint8),
            "bank|t_end": np.float64(rst.bank.t_end),
            "fit_mse": np.float64(rst.fit_mse)}
    for key, leaf in _paths(rst.params):
        flat[f"params|{key}"] = leaf.detach().cpu().numpy()
    _atomic_write(path, lambda f: np.savez_compressed(f, **flat))
    return path


def load_restarter(path: str, cfg: TIGConfig, device=None) -> Restarter:
    """A bundle written by ``save_restarter`` (this package's or the JAX
    package's), its params as tensors on ``device`` (default
    ``"cuda"``; raises without a card)."""
    device = resolve_device(device)
    with np.load(path) as data:
        bank = EmbeddingBank(emb=data["bank|emb"], t=data["bank|t"],
                             seen=data["bank|seen"].astype(bool),
                             t_end=float(data["bank|t_end"]))
        params: dict = {}
        for key in data.files:
            if not key.startswith("params|"):
                continue
            node = params
            parts = key.split("|")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.from_numpy(data[key]).to(device)
        fit_mse = float(data["fit_mse"])
    return Restarter(params=params, cfg=cfg, bank=bank, fit_mse=fit_mse)
