"""The evaluation protocol, as ``repro/tig/protocol.py``: the paper's
chronological 70/15/15 edge split (§III-A) as zero-copy row-range views,
never-seen-in-train node discovery, and forward-only scoring of one
stream with transductive and inductive AP / AUROC, and ``run_protocol``,
the replay-to-warm-memory scoring driver.

Not ported yet: the ``ShardedStream`` branch of ``split_views``, the
restarter warm-up, prefetching and the node-classification head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.tig.batching import LocalStream, build_batch_program
from repro_torch.tig.engine import make_eval_epoch
from repro_torch.tig.evaluation import link_prediction_metrics
from repro_torch.tig.graph import TemporalGraph
from repro_torch.tig.models import TIGConfig, init_state
from repro_torch.tig.sampler import ChronoNeighborIndex

__all__ = ["ProtocolSplits", "split_bounds", "split_views",
           "inductive_node_mask", "time_scale_of", "score_stream",
           "run_protocol"]

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


def inductive_node_mask(src: np.ndarray, dst: np.ndarray,
                        num_nodes: int) -> np.ndarray:
    """(N,) bool — nodes that NEVER appear in (src, dst)."""
    seen = np.zeros(num_nodes, dtype=bool)
    seen[src] = True
    seen[dst] = True
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


def split_views(source: TemporalGraph, train_frac: float = 0.70,
                val_frac: float = 0.15) -> ProtocolSplits:
    """Chronological 70/15/15 split of an in-memory graph as zero-copy
    row-range views, with timestamps rescaled to mean-gap units."""
    src = np.asarray(source.src, np.int64)
    dst = np.asarray(source.dst, np.int64)
    t = np.asarray(source.t, np.float64)
    labels = source.labels
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
                                      num_nodes),
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
                 tcsr: Optional[dict] = None, device=None) -> dict:
    """Run a chronological stream through the model (memory keeps
    updating, params frozen) and compute link-prediction metrics.

    ``eval_epoch_fn`` is the scoring program (``engine.make_eval_epoch``);
    by default ``make_eval_epoch(cfg, device=device)``, on the card unless
    ``device`` says otherwise. ``batches`` is a numpy (steps, ...)
    program that still carries the host-side ``valid`` entries.
    ``inductive_edge_mask`` is aligned THROUGH ``valid``: one entry per
    grid row (steps*B, filtered with ``valid``) or one per scored edge
    (``valid.sum()``); any other length raises. With ``tcsr`` (the staged
    T-CSR of THIS stream, history included) each step samples its
    neighbor grids on the device.

    Returns a dict with transductive AP/AUROC, inductive AP/AUROC when a
    mask is given, and the post-stream ``state`` (for continuing into the
    next split).
    """
    if eval_epoch_fn is None:
        eval_epoch_fn = make_eval_epoch(cfg, device=device)
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
    return out


def run_protocol(params, cfg: TIGConfig, splits: ProtocolSplits,
                 tables: dict, *, seed: int = 0, state=None,
                 warm: str = "replay", device=None) -> dict:
    """The replay-to-warm-memory scoring driver (paper Tab.IV protocol),
    serially: replay the train split through the scoring program to build
    node memory (no parameter updates), then score val and test, each
    continuing the previous split's memory and neighbor history. Each
    split's program is host-planned from one generator seeded with
    ``seed``, in the JAX package's order, so the plans are its plans.

    ``warm``: ``"replay"`` (the default) or ``"state"`` (the caller's
    post-train memory ``state``, e.g. PAC's merged memories; only the
    neighbor history of the train rows is rebuilt on the host, and
    ``train_ap`` is NaN). ``tables`` are tensors on ``device`` (default
    ``"cuda"``; raises without a card).

    Returns ``train_ap``, ``val_ap`` / ``val_auc`` / ``test_ap`` /
    ``test_auc`` with their ``*_inductive`` versions, and ``node_auroc``
    (NaN: node classification is not ported yet).
    """
    if warm not in ("replay", "state"):
        raise ValueError(f"warm={warm!r}: expected 'replay' or 'state' "
                         "(the restarter is not ported yet)")
    if warm == "state" and state is None:
        raise ValueError("warm='state' needs the post-train memory via "
                         "state=")
    device = resolve_device(device)
    replay_train = warm == "replay"
    rng = np.random.default_rng(seed)
    eval_fn = make_eval_epoch(cfg, device=device)
    views, names = list(splits.views), ["train", "val", "test"]
    hist = None
    if not replay_train:
        tr = views[0]
        hist = ChronoNeighborIndex(
            tr.src, tr.dst, tr.t, tr.eidx, splits.num_nodes,
            cfg.num_neighbors, cfg.batch_size).final_snapshot()
        views, names = views[1:], names[1:]
    if state is None:
        state = init_state(cfg, splits.num_nodes, device)
    results = {}
    for name, view in zip(names, views):
        batches, hist = build_batch_program(view, cfg, rng, history=hist,
                                            neg_pool=splits.neg_pool)
        res = score_stream(
            params, cfg, state, batches, tables, eval_fn,
            inductive_edge_mask=None if name == "train"
            else splits.inductive_edge_mask(view), device=device)
        state = res["state"]
        results[name] = res

    nan = float("nan")
    va, te = results["val"], results["test"]
    return {
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
