"""Single-device TIG training and evaluation, as ``repro/tig/train.py``:
the paper's non-partitioned baseline ('Single-GPU' rows of Tab.III/IV),
in memory (``train_single``) and out of core (``train_sharded``).

``train_single`` splits the stream 70/15/15 in time, resets memory at each
epoch, trains on the train split, and scores val and test continuing the
epoch-end memory; the test split is scored whenever val AP improves.
``train_sharded`` trains from a ``tig-shards-v1`` directory: the T-CSR is
built from shard chunks, the edge table staged on the device a shard at a
time, and with ``protocol=True`` the best-val params are kept in a
checkpoint and scored by ``run_protocol``. Each epoch plans on the host
(numpy, the same RNG streams as the JAX package, so plans are
bit-identical), on an ``EpochPrefetcher`` worker one or more epochs ahead
with ``prefetch``, and then runs the epoch program of
``engine.make_train_epoch`` on the device; val and test are scored by
``engine.make_eval_epoch``'s. On the card both replay one captured CUDA
graph a step. ``evaluate_params`` scores given (e.g. PAC-trained) params
on the protocol. ``make_train_step`` / ``make_eval_step`` are eager single
steps over ``models.step_loss``, kept (as in the JAX package) for
debugging and parity; ``graph_as_stream`` treats a whole graph as one
device-local stream.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.device import resolve_device
from repro_torch.optim import Optimizer, adamw
from repro_torch.tig import engine
from repro_torch.tig.batching import (LocalStream, build_batch_program,
                                      make_tables)
from repro_torch.tig.graph import TemporalGraph
from repro_torch.tig.models import (TIGConfig, init_params, init_state,
                                    step_loss)
from repro_torch.tig.protocol import (DEFAULT_CHUNK_EDGES, ProtocolSplits,
                                      run_protocol, score_stream,
                                      split_views, time_scale_of,
                                      train_classifier_head)
from repro_torch.tig.sampler import ChronoNeighborIndex
from repro_torch.tig.stream import (EpochPrefetcher, ShardedStream,
                                    stage_device_tables)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["graph_as_stream", "make_train_step", "make_eval_step",
           "epoch_rng", "train_epoch", "evaluate_stream", "evaluate_params",
           "train_single", "SingleResult", "train_sharded", "ShardedResult",
           "train_classifier_head", "time_scale_of"]

# the protocol layer owns stream scoring; the old name stays importable
evaluate_stream = score_stream


def epoch_rng(seed: int, epoch: int, role: int = 0) -> np.random.Generator:
    """Independent generator per (seed, epoch, role), as the JAX
    package's, so both packages draw the same epoch plans, and prefetched
    planning draws what serial planning does."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, role, epoch]))


def graph_as_stream(g: TemporalGraph) -> tuple[LocalStream, dict]:
    """The whole graph as one device-local stream (ids unchanged) and its
    numpy feature tables; timestamps rescaled to mean-gap units
    (``time_scale_of``)."""
    scale = time_scale_of(g.t)
    stream = LocalStream(
        src=g.src.astype(np.int64),
        dst=g.dst.astype(np.int64),
        t=g.t / scale,
        eidx=np.arange(g.num_edges, dtype=np.int64),
        num_local_nodes=g.num_nodes,
        labels=g.labels,
    )
    return stream, make_tables(g.edge_feat, g.node_feat)


def _on(tree: dict, device) -> dict:
    """A batch or tables dict (numpy or tensors) as tensors on
    ``device``, without the host-side ``labels``."""
    return {k: torch.as_tensor(v).to(device) for k, v in tree.items()
            if k != "labels"}


def make_train_step(cfg: TIGConfig, opt: Optimizer):
    """An eager step ``(params, opt_state, state, batch, tables) ->
    (params, opt_state, new_state, loss)`` over ``models.step_loss`` on
    one host-plan batch (``build_batches``), on the params' device; new
    tensors out, nothing given is written (the card's flush works on a
    copy of ``state``). The epochs run ``engine.make_train_epoch``; this
    step is kept for debugging and parity."""

    def step(params, opt_state, state, batch, tables):
        device = tree_leaves(params)[0].device
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        state = {k: v.detach().clone() for k, v in state.items()}
        with torch.enable_grad():
            loss, (new_state, _aux) = step_loss(
                live, state, _on(batch, device), _on(tables, device), cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, grads)])
        with torch.no_grad():
            params, opt_state = opt.apply(tree_map(lambda _: next(it), params),
                                          opt_state,
                                          tree_map(torch.Tensor.detach,
                                                   params))
        return (params, opt_state,
                {k: v.detach() for k, v in new_state.items()},
                loss.detach())

    return step


def make_eval_step(cfg: TIGConfig):
    """An eager forward-only step ``(params, state, batch, tables) ->
    (new_state, aux)``, aux holding the logits; nothing given is
    written."""

    @torch.no_grad()
    def step(params, state, batch, tables):
        device = tree_leaves(params)[0].device
        state = {k: v.clone() for k, v in state.items()}
        _loss, (new_state, aux) = step_loss(
            params, state, _on(batch, device), _on(tables, device), cfg)
        return new_state, aux

    return step


def _stage_tcsr(index: ChronoNeighborIndex, cfg: TIGConfig, device) -> dict:
    """A stream's T-CSR (``device_export``) as tensors on ``device``,
    staged once per run, front-padded for the model's ``n_layers``
    windows (``depth = n_layers``)."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in index.device_export(depth=cfg.n_layers).items()}


def _initial_params(params, cfg: TIGConfig, seed: int, device) -> dict:
    """``params`` copied to ``device`` (nothing may write into the
    caller's tensors), or drawn from a ``torch.Generator`` seeded with
    ``seed``."""
    if params is None:
        return init_params(torch.Generator().manual_seed(seed), cfg, device)
    return tree_map(
        lambda x: torch.as_tensor(x).detach().to(device, copy=True), params)


def train_epoch(params, opt_state, state, batches, tables, epoch_fn,
                tcsr=None):
    """One pass over a batch program through ``epoch_fn`` (from
    ``engine.make_train_epoch``); returns (params, opt_state, state, mean
    loss over steps as a float)."""
    params, opt_state, state, losses = epoch_fn(
        params, opt_state, state, batches, tables, tcsr=tcsr)
    return params, opt_state, state, float(losses.mean())


def evaluate_params(g: TemporalGraph, cfg: TIGConfig, params: dict, *,
                    seed: int = 0, eval_node_class: bool = False,
                    device=None) -> dict:
    """Score trained (e.g. PAC-trained) params on the standard protocol:
    replay the train split to build memory (no parameter updates), then
    score val / test link prediction and, with ``eval_node_class``, node
    classification (``protocol.run_protocol`` on the split views).
    ``device`` defaults to ``"cuda"``; raises without a card."""
    device = resolve_device(device)
    splits = split_views(g)
    tables = {k: torch.from_numpy(v).to(device)
              for k, v in make_tables(g.edge_feat, g.node_feat).items()}
    metrics = run_protocol(params, cfg, splits, tables, seed=seed,
                           eval_node_class=eval_node_class, device=device)
    engine.release(tables)
    return metrics


@dataclasses.dataclass
class SingleResult:
    val_ap: float
    test_ap: float
    test_ap_inductive: float
    node_auroc: float
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
    eval_node_class: bool = False,
    prefetch: bool = True,
    depth: int = 1,
    plan: str = "device",
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    params: Optional[dict] = None,
    device=None,
) -> SingleResult:
    """The single-device baseline trainer.

    ``plan="device"`` (the default) stages each split's T-CSR once and
    ships raw-edge programs: each step samples its neighbor grids on the
    device. ``plan="host"`` ships pre-sampled grids (identical results).
    With ``prefetch`` (the default) epoch e+1's plan is built on a worker
    thread while epoch e runs (``depth`` plans ahead; bitwise equal to
    serial planning). ``eval_node_class`` collects the test split's
    embeddings and reports the classifier head's AUROC in ``node_auroc``
    (NaN without labels). ``ckpt_dir`` + ``ckpt_every=k`` writes a
    checkpoint ``{params, opt_state, state}`` every k epochs.
    ``params`` gives the initial parameters (a dict under
    ``init_params``' keys, e.g. converted from the JAX package); by default
    they are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``device`` defaults to ``"cuda"`` and raises without a card.
    ``epoch_seconds`` covers the wait for the plan and the device epoch,
    synchronized; ``plan_seconds`` is that wait and the state reset (all
    of the planning without prefetch).
    """
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    device = resolve_device(device)
    splits = split_views(g)
    tables = {k: torch.from_numpy(v).to(device)
              for k, v in make_tables(g.edge_feat, g.node_feat).items()}
    tr_stream, val_stream, test_stream = splits.views

    params = _initial_params(params, cfg, seed, device)
    opt = adamw(lr=lr, max_grad_norm=1.0)
    opt_state = opt.init(params)
    epoch_fn = engine.make_train_epoch(cfg, opt, device=device)
    eval_fn = engine.make_eval_epoch(cfg, device=device)
    eval_fn_test = engine.make_eval_epoch(
        cfg, collect_embeddings=True, device=device) \
        if eval_node_class else eval_fn

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
        tcsr["train"] = _stage_tcsr(tr_index, cfg, device)

    with EpochPrefetcher(
        lambda ep: build_batch_program(
            tr_stream, cfg, epoch_rng(seed, ep, 1), neg_pool=neg_pool,
            index=tr_index, plan=plan),
        epochs, enabled=prefetch, depth=depth,
    ) as pf:
        for ep in range(epochs):
            t0 = time.perf_counter()
            tr_batches, hist = pf.get(ep)
            state = init_state(cfg, g.num_nodes, device)  # Alg.2: reset
            plan_secs.append(time.perf_counter() - t0)
            params, opt_state, state, loss = train_epoch(
                params, opt_state, state, tr_batches, tables, epoch_fn,
                tcsr=tcsr.get("train"))
            epoch_secs.append(time.perf_counter() - t0)
            losses.append(loss)
            if ckpt_dir and ckpt_every and (ep + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, ep,
                                {"params": params, "opt_state": opt_state,
                                 "state": state},
                                metadata={"epoch": ep})

            # validation continues from the epoch-end memory + index
            if plan == "device" and "val" not in idx:
                idx["val"] = ChronoNeighborIndex(
                    val_stream.src, val_stream.dst, val_stream.t,
                    val_stream.eidx, g.num_nodes, cfg.num_neighbors,
                    cfg.batch_size, history=hist)
                tcsr["val"] = _stage_tcsr(idx["val"], cfg, device)
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
                    tcsr["test"] = _stage_tcsr(idx["test"], cfg, device)
                test_batches, _ = build_batch_program(
                    test_stream, cfg, epoch_rng(seed, ep, 3),
                    history=None if plan == "device" else hist_val,
                    neg_pool=neg_pool, index=idx.get("test"), plan=plan)
                res_test = score_stream(
                    params, cfg, res_val["state"], test_batches, tables,
                    eval_fn_test,
                    inductive_edge_mask=splits.inductive_edge_mask(
                        test_stream),
                    collect_embeddings=eval_node_class,
                    tcsr=tcsr.get("test"))
                best = {
                    "val_ap": res_val["ap"],
                    "test_ap": res_test["ap"],
                    "test_ap_inductive": res_test.get("ap_inductive",
                                                      float("nan")),
                    "test_res": res_test,
                }

    engine.release(tables)
    node_auroc = float("nan")
    if eval_node_class and g.labels is not None:
        res_test = best["test_res"]
        if res_test.get("embeddings") is not None \
                and res_test.get("labels") is not None:
            n_classes = int(g.labels[g.labels >= 0].max()) + 1
            node_auroc = train_classifier_head(
                res_test["embeddings"], res_test["labels"],
                max(n_classes, 2), device=device)

    return SingleResult(
        val_ap=best["val_ap"],
        test_ap=best["test_ap"],
        test_ap_inductive=best["test_ap_inductive"],
        node_auroc=node_auroc,
        epoch_seconds=epoch_secs,
        losses=losses,
        params=params,
        state=state,
        cfg=cfg,
        plan_seconds=plan_secs,
    )


@dataclasses.dataclass
class ShardedResult:
    losses: list[float]
    epoch_seconds: list[float]
    params: dict
    state: dict
    cfg: TIGConfig
    metrics: Optional[dict] = None      # run_protocol output (protocol=True)
    best_epoch: Optional[int] = None
    val_curve: list[float] = dataclasses.field(default_factory=list)
    plan_seconds: list[float] = dataclasses.field(default_factory=list)
    setup_seconds: dict = dataclasses.field(default_factory=dict)


def train_sharded(
    shards: ShardedStream,
    cfg: TIGConfig,
    *,
    epochs: int = 2,
    lr: float = 1e-3,
    seed: int = 0,
    prefetch: bool = True,
    depth: int = 1,
    protocol: bool = False,
    patience: int = 2,
    eval_node_class: bool = False,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    plan: str = "device",
    params: Optional[dict] = None,
    head_params: Optional[dict] = None,
    device=None,
) -> ShardedResult:
    """Out-of-core training over a ``tig-shards-v1`` stream.

    The data plane is chunked: id columns materialize at 8 bytes an edge,
    the edge-feature table is staged on the device a shard at a time
    (``stream.stage_device_tables``; the host never holds all rows), the
    temporal neighbor index is built by the chunked two-pass T-CSR
    (``ChronoNeighborIndex.from_chunks``), and with ``prefetch`` epoch
    plans are built on a worker thread while the previous epoch's graph
    replays (``depth`` plans ahead; bitwise equal to ``prefetch=False``).
    ``plan="device"`` (the default) stages the T-CSR once and each step
    samples its neighbor grids on the device; ``plan="host"`` ships
    pre-sampled grids (the same results).

    With ``protocol=False`` the whole stream is the train split and
    nothing is scored. With ``protocol=True`` the 70/15/15 split becomes
    row-range views (``protocol.split_views``), training sees the train
    rows only, each epoch scores val from the epoch-end memory, the
    best-val ``{params, opt_state, state}`` is kept in a checkpoint (in a
    temporary directory unless ``ckpt_dir`` is given; patience-based early
    stop), and ``metrics`` come from ``protocol.run_protocol`` with the
    restored best params and their memory: the same code, and the same
    numbers, as ``evaluate_params`` on the in-memory graph.
    ``eval_node_class`` adds the node-classification AUROC (its head from
    ``head_params`` when given). ``ckpt_every=k`` also writes a checkpoint
    every k epochs (needs ``ckpt_dir``).

    ``params`` gives the initial parameters (default: a
    ``torch.Generator`` seeded with ``seed``); ``device`` defaults to
    ``"cuda"`` and raises without a card. ``plan_seconds`` is what each
    epoch waited for its plan; ``setup_seconds`` holds the index build
    (``index``) and the table staging (``stage``).
    """
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    device = resolve_device(device)
    splits: Optional[ProtocolSplits] = None
    if protocol:
        splits = split_views(shards)
        stream = splits.train

        def scaled_chunks():
            for lo in range(0, stream.num_edges, DEFAULT_CHUNK_EDGES):
                hi = min(lo + DEFAULT_CHUNK_EDGES, stream.num_edges)
                yield (stream.src[lo:hi], stream.dst[lo:hi],
                       stream.t[lo:hi], stream.eidx[lo:hi])

        neg_pool = splits.neg_pool
    else:
        src = shards.column("src")
        dst = shards.column("dst")
        t = shards.column("t")
        scale = time_scale_of(t)
        stream = LocalStream(
            src=src, dst=dst, t=t / scale,
            eidx=np.arange(len(src), dtype=np.int64),
            num_local_nodes=shards.num_nodes, labels=None)

        def scaled_chunks():
            for c_src, c_dst, c_t, c_eidx in shards.edge_chunks():
                yield c_src, c_dst, c_t / scale, c_eidx

        neg_pool = np.unique(stream.dst)

    # the index is epoch-invariant (one stream, no history): built once
    t0 = time.perf_counter()
    index = ChronoNeighborIndex.from_chunks(
        scaled_chunks, shards.num_nodes, cfg.num_neighbors, cfg.batch_size)
    setup = {"index": time.perf_counter() - t0}
    t0 = time.perf_counter()
    tables = stage_device_tables(shards, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup["stage"] = time.perf_counter() - t0

    params = _initial_params(params, cfg, seed, device)
    opt = adamw(lr=lr, max_grad_norm=1.0)
    opt_state = opt.init(params)
    epoch_fn = engine.make_train_epoch(cfg, opt, device=device)
    eval_fn = engine.make_eval_epoch(cfg, device=device)
    val_mask = splits.inductive_edge_mask(splits.val) if protocol else None

    # device planning: the T-CSR (and under protocol the val
    # continuation's) is staged once; epochs reuse it
    tcsr_tr = _stage_tcsr(index, cfg, device) if plan == "device" else None
    train_hist = index.final_snapshot() if protocol else None
    val_index, tcsr_val = None, None
    if plan == "device" and protocol:
        val_index = ChronoNeighborIndex(
            splits.val.src, splits.val.dst, splits.val.t, splits.val.eidx,
            shards.num_nodes, cfg.num_neighbors, cfg.batch_size,
            history=train_hist)
        tcsr_val = _stage_tcsr(val_index, cfg, device)

    own_tmp = None
    if protocol and ckpt_dir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="tig_ckpt_")
        ckpt_dir = own_tmp.name

    losses, epoch_secs, plan_secs, val_curve = [], [], [], []
    state = None
    best_val, best_epoch, bad = -np.inf, None, 0
    try:
        with EpochPrefetcher(
            lambda ep: build_batch_program(
                stream, cfg, epoch_rng(seed, ep, 1), neg_pool=neg_pool,
                index=index, plan=plan)[0],
            epochs, enabled=prefetch, depth=depth,
        ) as pf:
            for ep in range(epochs):
                t0 = time.perf_counter()
                batches = pf.get(ep)
                state = init_state(cfg, shards.num_nodes, device)
                plan_secs.append(time.perf_counter() - t0)
                params, opt_state, state, loss = train_epoch(
                    params, opt_state, state, batches, tables, epoch_fn,
                    tcsr=tcsr_tr)
                epoch_secs.append(time.perf_counter() - t0)
                losses.append(loss)
                snap = {"params": params, "opt_state": opt_state,
                        "state": state}
                if ckpt_dir and ckpt_every and (ep + 1) % ckpt_every == 0:
                    save_checkpoint(ckpt_dir, ep, snap,
                                    metadata={"epoch": ep})
                if not protocol:
                    continue
                # validation continues the epoch-end memory + history
                val_batches, _ = build_batch_program(
                    splits.val, cfg, epoch_rng(seed, ep, 2),
                    history=None if plan == "device" else train_hist,
                    neg_pool=neg_pool, index=val_index, plan=plan)
                res_val = score_stream(params, cfg, state, val_batches,
                                       tables, eval_fn,
                                       inductive_edge_mask=val_mask,
                                       tcsr=tcsr_val)
                val_curve.append(res_val["ap"])
                if res_val["ap"] > best_val:
                    best_val, best_epoch, bad = res_val["ap"], ep, 0
                    # the params AND their epoch-end memory: a consistent
                    # training point
                    save_checkpoint(ckpt_dir, ep, snap, metadata={
                        "val_ap": float(res_val["ap"])})
                else:
                    bad += 1
                    if bad >= patience:
                        break

        # what scoring no longer needs: the train program (its graph,
        # pool and copies) and the val stream's graphs and T-CSRs
        del epoch_fn, eval_fn, tcsr_tr, tcsr_val
        engine.release(tables)
        metrics = None
        if protocol:
            # no best epoch when no epoch ran or val AP was NaN
            # throughout: keep the last params
            if best_epoch is not None:
                restored = restore_checkpoint(
                    ckpt_dir, best_epoch,
                    {"params": params, "state": state})
                params, state = restored["params"], restored["state"]
            metrics = run_protocol(
                params, cfg, splits, tables, seed=seed,
                eval_node_class=eval_node_class, prefetch=prefetch,
                depth=depth, head_params=head_params, device=device)
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
        engine.release(tables)

    return ShardedResult(
        losses=losses,
        epoch_seconds=epoch_secs,
        params=params,
        state=state,
        cfg=cfg,
        metrics=metrics,
        best_epoch=best_epoch,
        val_curve=val_curve,
        plan_seconds=plan_secs,
        setup_seconds=setup,
    )
