"""The evaluation protocol, as ``repro/tig/protocol.py``: the paper's
chronological 70/15/15 edge split (§III-A) as zero-copy row-range views
of an in-memory graph or an out-of-core ``ShardedStream``, never-seen-in-
train node discovery in one chunked pass, forward-only scoring of one
stream with transductive and inductive AP / AUROC, ``run_protocol``, the
replay-to-warm-memory scorer, and ``train_classifier_head``, the
Tab.V node-classification head on frozen embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.tig.batching import LocalStream, build_batch_program
from repro_torch.tig.engine import make_eval_epoch
from repro_torch.tig.evaluation import link_prediction_metrics, roc_auc
from repro_torch.tig.graph import TemporalGraph
from repro_torch.tig.models import TIGConfig, init_state
from repro_torch.tig.modules import mlp, mlp_init
from repro_torch.tig.restart import restart_memory
from repro_torch.tig.sampler import ChronoNeighborIndex
from repro_torch.tig.stream import EpochPrefetcher, ShardedStream
from repro_torch.tree import tree_map

__all__ = ["DEFAULT_CHUNK_EDGES", "ProtocolSplits", "split_bounds",
           "split_views", "inductive_node_mask", "time_scale_of",
           "score_stream", "run_protocol", "train_classifier_head"]

DEFAULT_CHUNK_EDGES = 1 << 20


def time_scale_of(t: np.ndarray) -> float:
    """Mean inter-event gap: timestamps are divided by it so Δt is O(1)
    whatever the dataset's clock unit."""
    if len(t) < 2:
        return 1.0
    gaps = np.diff(np.sort(t))
    m = float(gaps.mean())
    return m if m > 0 else 1.0


def split_bounds(num_edges: int, train_frac: float = 0.70,
                 val_frac: float = 0.15) -> tuple[int, int]:
    """Row boundaries of the chronological split: rows [0, n_train) train,
    [n_train, n_val_end) validation, [n_val_end, num_edges) test."""
    n_train = int(num_edges * train_frac)
    n_val_end = int(num_edges * (train_frac + val_frac))
    return n_train, n_val_end


def inductive_node_mask(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                        *, chunk_edges: int = DEFAULT_CHUNK_EDGES
                        ) -> np.ndarray:
    """(N,) bool — nodes that NEVER appear in (src, dst), found in one
    chunked pass (``chunk_edges`` ids at a time; works on memory-mapped
    columns)."""
    seen = np.zeros(num_nodes, dtype=bool)
    for lo in range(0, len(src), chunk_edges):
        seen[np.asarray(src[lo:lo + chunk_edges], np.int64)] = True
        seen[np.asarray(dst[lo:lo + chunk_edges], np.int64)] = True
    return ~seen


@dataclasses.dataclass
class ProtocolSplits:
    """The chronological 70/15/15 split as zero-copy stream views.

    ``train`` / ``val`` / ``test`` slice one set of backing columns;
    ``inductive`` marks nodes never seen in the train rows; ``neg_pool`` is
    the full-stream negative candidate set (the JODIE/TGN convention).
    """

    train: LocalStream
    val: LocalStream
    test: LocalStream
    inductive: np.ndarray          # (N,) bool
    neg_pool: np.ndarray
    bounds: tuple[int, int]
    num_nodes: int
    num_edges: int
    time_scale: float
    name: str = "tig"

    @property
    def views(self) -> tuple[LocalStream, LocalStream, LocalStream]:
        return (self.train, self.val, self.test)

    def inductive_edge_mask(self, view: LocalStream) -> np.ndarray:
        """Per-edge mask of ``view``: edge touches a never-seen-in-train
        node (the paper's inductive link-prediction subset)."""
        return self.inductive[view.src] | self.inductive[view.dst]


def split_views(source: Union[ShardedStream, TemporalGraph],
                train_frac: float = 0.70, val_frac: float = 0.15, *,
                chunk_edges: int = DEFAULT_CHUNK_EDGES) -> ProtocolSplits:
    """Chronological 70/15/15 split of an in-memory ``TemporalGraph`` or
    an out-of-core ``ShardedStream`` as zero-copy row-range views, with
    timestamps rescaled to mean-gap units. Only the id, time and label
    columns are materialized (8 bytes an edge each); edge features are
    not touched."""
    if isinstance(source, ShardedStream):
        src = source.column("src")
        dst = source.column("dst")
        t = source.column("t")
        labels = source.column("label") if source.has_labels else None
    elif isinstance(source, TemporalGraph):
        src = np.asarray(source.src, np.int64)
        dst = np.asarray(source.dst, np.int64)
        t = np.asarray(source.t, np.float64)
        labels = source.labels
    else:
        raise TypeError(
            f"split_views needs a ShardedStream or TemporalGraph, got "
            f"{type(source).__name__}")
    num_nodes, name = source.num_nodes, source.name

    scale = time_scale_of(t)
    t = t / scale
    num_edges = len(src)
    eidx = np.arange(num_edges, dtype=np.int64)
    n_train, n_val_end = split_bounds(num_edges, train_frac, val_frac)

    def view(lo: int, hi: int) -> LocalStream:
        return LocalStream(
            src=src[lo:hi], dst=dst[lo:hi], t=t[lo:hi], eidx=eidx[lo:hi],
            num_local_nodes=num_nodes,
            labels=None if labels is None else labels[lo:hi],
        )

    return ProtocolSplits(
        train=view(0, n_train),
        val=view(n_train, n_val_end),
        test=view(n_val_end, num_edges),
        inductive=inductive_node_mask(src[:n_train], dst[:n_train],
                                      num_nodes, chunk_edges=chunk_edges),
        neg_pool=np.unique(dst),
        bounds=(n_train, n_val_end),
        num_nodes=num_nodes,
        num_edges=num_edges,
        time_scale=scale,
        name=name,
    )


def score_stream(params, cfg: TIGConfig, state, batches: dict, tables: dict,
                 eval_epoch_fn=None, *,
                 inductive_edge_mask: Optional[np.ndarray] = None,
                 collect_embeddings: bool = False,
                 tcsr: Optional[dict] = None, device=None) -> dict:
    """Run a chronological stream through the model (memory keeps
    updating, params frozen) and compute link-prediction metrics.

    ``eval_epoch_fn`` is the scoring program (``engine.make_eval_epoch``,
    built with ``collect_embeddings`` when it is asked for); by default
    ``make_eval_epoch(cfg, collect_embeddings=..., device=device)``, on
    the card unless ``device`` says otherwise. ``batches`` is a numpy
    (steps, ...) program that still carries the host-side ``valid`` /
    ``labels`` entries. ``inductive_edge_mask`` is aligned THROUGH
    ``valid``: one entry per grid row (steps*B, filtered with ``valid``)
    or one per scored edge (``valid.sum()``); any other length raises.
    With ``tcsr`` (the staged T-CSR of THIS stream, history included) each
    step samples its neighbor grids on the device.

    Returns a dict with transductive AP/AUROC, inductive AP/AUROC when a
    mask is given, with ``collect_embeddings`` the scored rows' src
    ``embeddings`` (numpy) and ``labels``, and the post-stream ``state``
    (for continuing into the next split).
    """
    if eval_epoch_fn is None:
        eval_epoch_fn = make_eval_epoch(
            cfg, collect_embeddings=collect_embeddings, device=device)
    state, aux = eval_epoch_fn(params, state, batches, tables, tcsr=tcsr)
    valid = np.asarray(batches["valid"]).reshape(-1)      # (steps*B,)
    pos = aux["pos_logit"].cpu().numpy().reshape(-1)[valid]
    neg = aux["neg_logit"].cpu().numpy().reshape(-1)[valid]
    mask = None
    if inductive_edge_mask is not None:
        mask = np.asarray(inductive_edge_mask, dtype=bool).reshape(-1)
        if mask.shape[0] == valid.shape[0]:
            mask = mask[valid]                  # grid-shaped: drop padding
        elif mask.shape[0] != len(pos):
            raise ValueError(
                f"inductive_edge_mask has {mask.shape[0]} entries; expected "
                f"one per scored edge ({len(pos)}) or one per grid row "
                f"({valid.shape[0]})")
    out = link_prediction_metrics(pos, neg, inductive_mask=mask)
    out["state"] = state
    if collect_embeddings:
        if "src_embed" not in aux:
            raise ValueError(
                "collect_embeddings=True needs an eval program built with "
                "make_eval_epoch(cfg, collect_embeddings=True)")
        emb = aux["src_embed"].cpu().numpy()
        out["embeddings"] = emb.reshape(-1, emb.shape[-1])[valid]
        out["labels"] = (np.asarray(batches["labels"]).reshape(-1)[valid]
                         if "labels" in batches else None)
    return out


def run_protocol(params, cfg: TIGConfig, splits: ProtocolSplits,
                 tables: dict, *, seed: int = 0,
                 eval_node_class: bool = False, prefetch: bool = True,
                 depth: int = 1, state=None, warm: str = "replay",
                 restarter=None, head_params: Optional[dict] = None,
                 device=None) -> dict:
    """The replay-to-warm-memory scorer (paper Tab.IV / V
    protocol): replay the train split through the scoring program to
    build node memory (no parameter updates), then score val and test,
    each continuing the previous split's memory and neighbor history.
    Each split's program is host-planned from one generator seeded with
    ``seed``, in the JAX package's order, so the plans are its plans.
    With ``prefetch`` split e+1's plan is built on an ``EpochPrefetcher``
    worker while split e runs (``depth`` plans ahead; planning stays
    serial on the one worker, so on and off are bitwise equal).

    ``warm``: ``"replay"`` (the default), ``"state"`` (the caller's
    post-train memory ``state``, e.g. PAC's merged memories) or
    ``"restart"`` (TIGER's replayless warm-up: the memory rebuilt in O(N)
    by the fitted ``restarter`` bundle, ``restart.build_restarter``; its
    metrics agree with the replay's within a tolerance, not bitwise).
    Without the replay only the neighbor history of the train rows is
    rebuilt on the host, and ``train_ap`` is NaN. ``tables`` are tensors
    on ``device`` (default ``"cuda"``; raises without a card).

    Returns ``train_ap``, ``val_ap`` / ``val_auc`` / ``test_ap`` /
    ``test_auc`` with their ``*_inductive`` versions, and ``node_auroc``:
    with ``eval_node_class`` and labels in the stream, the AUROC of
    ``train_classifier_head`` on the test split's src embeddings (from
    ``head_params`` when given), else NaN.
    """
    if warm not in ("replay", "state", "restart"):
        raise ValueError(f"warm={warm!r}: expected 'replay', 'state' or "
                         "'restart'")
    if warm == "restart":
        if restarter is None:
            raise ValueError("warm='restart' needs a fitted restarter "
                             "bundle (tig.restart.build_restarter)")
        state = restart_memory(restarter, splits.num_nodes, tables)
    elif warm == "state" and state is None:
        raise ValueError("warm='state' needs the post-train memory via "
                         "state=")
    device = resolve_device(device)
    replay_train = warm == "replay"
    rng = np.random.default_rng(seed)
    eval_fn = make_eval_epoch(cfg, device=device)
    eval_fn_test = make_eval_epoch(cfg, collect_embeddings=True,
                                   device=device) \
        if eval_node_class else eval_fn
    views, names = list(splits.views), ["train", "val", "test"]
    hist = [None]
    if not replay_train:
        # the host half of the train replay: the neighbor history as of
        # the end of the train rows (the memory is the caller's state)
        tr = views[0]
        hist[0] = ChronoNeighborIndex(
            tr.src, tr.dst, tr.t, tr.eidx, splits.num_nodes,
            cfg.num_neighbors, cfg.batch_size).final_snapshot()
        views, names = views[1:], names[1:]

    def build(i: int) -> dict:
        batches, hist[0] = build_batch_program(
            views[i], cfg, rng, history=hist[0], neg_pool=splits.neg_pool)
        return batches

    if state is None:
        state = init_state(cfg, splits.num_nodes, device)
    results = {}
    with EpochPrefetcher(build, len(views), enabled=prefetch,
                         depth=depth) as pf:
        for i, (name, view) in enumerate(zip(names, views)):
            is_test = name == "test"
            res = score_stream(
                params, cfg, state, pf.get(i), tables,
                eval_fn_test if is_test else eval_fn,
                inductive_edge_mask=None if name == "train"
                else splits.inductive_edge_mask(view),
                collect_embeddings=is_test and eval_node_class,
                device=device)
            state = res["state"]
            results[name] = res

    nan = float("nan")
    va, te = results["val"], results["test"]
    out = {
        "train_ap": results["train"]["ap"] if replay_train else nan,
        "val_ap": va["ap"],
        "val_auc": va["auc"],
        "val_ap_inductive": va.get("ap_inductive", nan),
        "val_auc_inductive": va.get("auc_inductive", nan),
        "test_ap": te["ap"],
        "test_auc": te["auc"],
        "test_ap_inductive": te.get("ap_inductive", nan),
        "test_auc_inductive": te.get("auc_inductive", nan),
        "node_auroc": nan,
    }
    if eval_node_class and te.get("embeddings") is not None \
            and te.get("labels") is not None:
        mx = -1
        for v in splits.views:
            if v.labels is not None and (v.labels >= 0).any():
                mx = max(mx, int(v.labels[v.labels >= 0].max()))
        if mx >= 0:
            out["node_auroc"] = train_classifier_head(
                te["embeddings"], te["labels"], max(mx + 1, 2),
                params=head_params, device=device)
    return out


def train_classifier_head(embeds: np.ndarray, labels: np.ndarray,
                          n_classes: int, *, seed: int = 0,
                          steps: int = 300, lr: float = 1e-2,
                          params: Optional[dict] = None,
                          device=None) -> float:
    """Dynamic node classification (paper Tab.V): train an MLP head
    (d -> 64 -> n_classes, full batch, AdamW) on frozen interaction-time
    embeddings, report AUROC on a chronological 70/30 split; multi-class
    gives the macro one-vs-rest AUROC. Plain PyTorch on ``device``
    (default ``"cuda"``; raises without a card), as the JAX package
    computes it outside any kernel.

    ``params`` gives the head's initial params (``mlp_init``'s layout,
    e.g. converted from the JAX package's); by default they are drawn
    from a ``torch.Generator`` seeded with ``seed``.
    """
    device = resolve_device(device)
    keep = labels >= 0
    embeds, labels = embeds[keep], labels[keep]
    n = len(labels)
    if n < 10 or len(np.unique(labels)) < 2:
        return float("nan")
    cut = int(n * 0.7)
    x_tr = torch.from_numpy(np.ascontiguousarray(embeds[:cut])).to(device)
    y_tr = torch.from_numpy(np.ascontiguousarray(labels[:cut])).to(device)
    if params is None:
        params = mlp_init(torch.Generator().manual_seed(seed),
                          [embeds.shape[1], 64, n_classes], device)
    params = tree_map(
        lambda v: torch.as_tensor(v).detach().to(device, copy=True), params)

    def loss_fn(p):
        logp = torch.log_softmax(mlp(p, x_tr), dim=-1)
        return -torch.take_along_dim(logp, y_tr[:, None], 1).mean()

    params, _ = adamw(lr=lr).minimize(params, loss_fn, steps)

    with torch.no_grad():
        x_te = torch.from_numpy(np.ascontiguousarray(embeds[cut:])).to(
            device)
        logits = mlp(params, x_te).cpu().numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    y_te = labels[cut:]
    if n_classes == 2:
        return roc_auc(y_te == 1, probs[:, 1])
    aucs = []
    for c in range(n_classes):
        if (y_te == c).any() and (y_te != c).any():
            aucs.append(roc_auc(y_te == c, probs[:, c]))
    return float(np.mean(aucs)) if aucs else float("nan")
