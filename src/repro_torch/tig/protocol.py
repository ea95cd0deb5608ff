"""The evaluation protocol, as ``repro/tig/protocol.py``: the paper's
chronological 70/15/15 edge split (§III-A) as zero-copy row-range views,
never-seen-in-train node discovery, and forward-only scoring of one
stream with transductive and inductive AP / AUROC.

Not ported yet: ``run_protocol`` (replay-to-warm-memory scoring), the
``ShardedStream`` branch of ``split_views``, and the node-classification
head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.tig.batching import LocalStream
from repro_torch.tig.engine import make_eval_epoch
from repro_torch.tig.evaluation import link_prediction_metrics
from repro_torch.tig.graph import TemporalGraph
from repro_torch.tig.models import TIGConfig

__all__ = ["ProtocolSplits", "split_bounds", "split_views",
           "inductive_node_mask", "time_scale_of", "score_stream"]

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
