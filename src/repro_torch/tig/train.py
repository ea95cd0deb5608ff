"""Single-device TIG training and evaluation, as ``repro/tig/train.py``:
the paper's non-partitioned baseline ('Single-GPU' rows of Tab.III/IV).

``train_single`` splits the stream 70/15/15 in time, resets memory at each
epoch, trains on the train split, and scores val and test continuing the
epoch-end memory; the test split is scored whenever val AP improves. Each
epoch plans on the host (numpy, the same RNG streams as the JAX package,
so plans are bit-identical) and then runs the epoch program of
``engine.make_train_epoch`` on the device; val and test are scored by
``engine.make_eval_epoch``'s, as in the JAX package. On the card both
replay one captured CUDA graph a step. Planning and the device epoch run
one after the other; the JAX package's prefetching worker is not ported
yet, nor are checkpoints, node classification and ``train_sharded``.
``evaluate_params`` scores given (e.g. PAC-trained) params on the
protocol.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.tig.batching import build_batch_program, make_tables
from repro_torch.tig.engine import make_eval_epoch, make_train_epoch
from repro_torch.tig.graph import TemporalGraph
from repro_torch.tig.models import TIGConfig, init_params, init_state
from repro_torch.tig.protocol import run_protocol, score_stream, split_views
from repro_torch.tig.sampler import ChronoNeighborIndex
from repro_torch.tree import tree_map

__all__ = ["epoch_rng", "train_epoch", "train_single", "SingleResult",
           "evaluate_params"]


def epoch_rng(seed: int, epoch: int, role: int = 0) -> np.random.Generator:
    """Independent generator per (seed, epoch, role), as the JAX
    package's, so both packages draw the same epoch plans."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, role, epoch]))


def _stage_tcsr(index: ChronoNeighborIndex, device) -> dict:
    """A stream's T-CSR (``device_export``) as tensors on ``device``,
    staged once per run."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in index.device_export().items()}


def train_epoch(params, opt_state, state, batches, tables, epoch_fn,
                tcsr=None):
    """One pass over a batch program through ``epoch_fn`` (from
    ``engine.make_train_epoch``); returns (params, opt_state, state, mean
    loss over steps as a float)."""
    params, opt_state, state, losses = epoch_fn(
        params, opt_state, state, batches, tables, tcsr=tcsr)
    return params, opt_state, state, float(losses.mean())


def evaluate_params(g: TemporalGraph, cfg: TIGConfig, params: dict, *,
                    seed: int = 0, device=None) -> dict:
    """Score trained (e.g. PAC-trained) params on the standard protocol:
    replay the train split to build memory (no parameter updates), then
    score val / test link prediction (``protocol.run_protocol`` on the
    split views). ``device`` defaults to ``"cuda"``; raises without a
    card."""
    device = resolve_device(device)
    splits = split_views(g)
    tables = {k: torch.from_numpy(v).to(device)
              for k, v in make_tables(g.edge_feat, g.node_feat).items()}
    return run_protocol(params, cfg, splits, tables, seed=seed,
                        device=device)


@dataclasses.dataclass
class SingleResult:
    val_ap: float
    test_ap: float
    test_ap_inductive: float
    epoch_seconds: list[float]
    losses: list[float]
    params: dict
    state: dict
    cfg: TIGConfig
    plan_seconds: list[float]


def train_single(
    g: TemporalGraph,
    cfg: TIGConfig,
    *,
    epochs: int = 3,
    lr: float = 1e-3,
    seed: int = 0,
    plan: str = "device",
    params: Optional[dict] = None,
    device=None,
) -> SingleResult:
    """The single-device baseline trainer.

    ``plan="device"`` (the default) stages each split's T-CSR once and
    ships raw-edge programs: each step samples its neighbor grids on the
    device. ``plan="host"`` ships pre-sampled grids (identical results).
    ``params`` gives the initial parameters (a dict under
    ``init_params``' keys, e.g. converted from the JAX package); by default
    they are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``device`` defaults to ``"cuda"`` and raises without a card.
    ``epoch_seconds`` covers planning and the device epoch, synchronized;
    ``plan_seconds`` is the planning part of each (the host's batch
    program and the state reset).
    """
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    device = resolve_device(device)
    splits = split_views(g)
    tables = {k: torch.from_numpy(v).to(device)
              for k, v in make_tables(g.edge_feat, g.node_feat).items()}
    tr_stream, val_stream, test_stream = splits.views

    if params is None:
        params = init_params(torch.Generator().manual_seed(seed), cfg, device)
    else:
        # copies: nothing may write into the caller's tensors
        params = tree_map(
            lambda x: torch.as_tensor(x).detach().to(device, copy=True),
            params)
    opt = adamw(lr=lr, max_grad_norm=1.0)
    opt_state = opt.init(params)
    epoch_fn = make_train_epoch(cfg, opt, device=device)
    eval_fn = make_eval_epoch(cfg, device=device)

    neg_pool = splits.neg_pool
    epoch_secs, plan_secs, losses = [], [], []
    best = {"val_ap": -1.0}

    # device planning: the train index is epoch-invariant (no history) and
    # val / test continue fixed snapshots, so each split's T-CSR is built
    # and staged once — val / test lazily.
    tr_index = None
    tcsr, idx = {}, {}
    if plan == "device":
        tr_index = ChronoNeighborIndex(
            tr_stream.src, tr_stream.dst, tr_stream.t, tr_stream.eidx,
            g.num_nodes, cfg.num_neighbors, cfg.batch_size)
        tcsr["train"] = _stage_tcsr(tr_index, device)

    for ep in range(epochs):
        t0 = time.perf_counter()
        tr_batches, hist = build_batch_program(
            tr_stream, cfg, epoch_rng(seed, ep, 1), neg_pool=neg_pool,
            index=tr_index, plan=plan)
        state = init_state(cfg, g.num_nodes, device)  # Alg.2: reset
        plan_secs.append(time.perf_counter() - t0)
        params, opt_state, state, loss = train_epoch(
            params, opt_state, state, tr_batches, tables, epoch_fn,
            tcsr=tcsr.get("train"))
        epoch_secs.append(time.perf_counter() - t0)
        losses.append(loss)

        # validation continues from the epoch-end memory + neighbor index
        if plan == "device" and "val" not in idx:
            idx["val"] = ChronoNeighborIndex(
                val_stream.src, val_stream.dst, val_stream.t,
                val_stream.eidx, g.num_nodes, cfg.num_neighbors,
                cfg.batch_size, history=hist)
            tcsr["val"] = _stage_tcsr(idx["val"], device)
        val_batches, hist_val = build_batch_program(
            val_stream, cfg, epoch_rng(seed, ep, 2),
            history=None if plan == "device" else hist,
            neg_pool=neg_pool, index=idx.get("val"), plan=plan)
        res_val = score_stream(params, cfg, state, val_batches, tables,
                               eval_fn, tcsr=tcsr.get("val"))
        if res_val["ap"] > best["val_ap"]:
            if plan == "device" and "test" not in idx:
                idx["test"] = ChronoNeighborIndex(
                    test_stream.src, test_stream.dst, test_stream.t,
                    test_stream.eidx, g.num_nodes, cfg.num_neighbors,
                    cfg.batch_size, history=hist_val)
                tcsr["test"] = _stage_tcsr(idx["test"], device)
            test_batches, _ = build_batch_program(
                test_stream, cfg, epoch_rng(seed, ep, 3),
                history=None if plan == "device" else hist_val,
                neg_pool=neg_pool, index=idx.get("test"), plan=plan)
            res_test = score_stream(
                params, cfg, res_val["state"], test_batches, tables, eval_fn,
                inductive_edge_mask=splits.inductive_edge_mask(test_stream),
                tcsr=tcsr.get("test"))
            best = {
                "val_ap": res_val["ap"],
                "test_ap": res_test["ap"],
                "test_ap_inductive": res_test.get("ap_inductive",
                                                  float("nan")),
            }

    return SingleResult(
        val_ap=best["val_ap"],
        test_ap=best["test_ap"],
        test_ap_inductive=best["test_ap_inductive"],
        epoch_seconds=epoch_secs,
        losses=losses,
        params=params,
        state=state,
        cfg=cfg,
        plan_seconds=plan_secs,
    )
