"""Evaluation metrics (numpy; no sklearn offline), copied from
``repro/tig/evaluation.py`` so the two packages score identically.

Average Precision for temporal link prediction (paper Tab.IV) and AUROC for
dynamic node classification (paper Tab.V).  ``link_prediction_metrics``
assembles the full transductive + inductive metric row from paired
positive/negative logits — the one place the protocol layer's numbers are
computed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["average_precision", "roc_auc", "link_prediction_metrics"]


def average_precision(y_true: np.ndarray, scores: np.ndarray) -> float:
    """AP = sum_k P(k) * (R(k) - R(k-1)) over descending-score ranking."""
    y_true = np.asarray(y_true).astype(np.float64)
    scores = np.asarray(scores).astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    y = y_true[order]
    tp = np.cumsum(y)
    total_pos = y.sum()
    if total_pos == 0:
        return 0.0
    precision = tp / np.arange(1, len(y) + 1)
    recall = tp / total_pos
    prev_recall = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum(precision * (recall - prev_recall)))


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """AUROC via the Mann-Whitney U statistic (tie-aware through ranks)."""
    y_true = np.asarray(y_true).astype(bool)
    scores = np.asarray(scores).astype(np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    # average ranks (ties averaged)
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # tie correction: average ranks within equal-score groups
    sorted_scores = scores[order]
    uniq, inv, counts = np.unique(sorted_scores, return_inverse=True,
                                  return_counts=True)
    if len(uniq) != len(sorted_scores):
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        avg = start + (counts + 1) / 2.0
        ranks[order] = avg[inv]
    r_pos = ranks[y_true].sum()
    u = r_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def link_prediction_metrics(
    pos_logit: np.ndarray,
    neg_logit: np.ndarray,
    inductive_mask: Optional[np.ndarray] = None,
) -> dict:
    """AP/AUROC over paired positive/negative logits (one negative per
    positive, the JODIE/TGN convention).

    ``inductive_mask`` — one bool per positive/negative pair — restricts a
    second AP/AUROC to the inductive subset (edges touching
    never-seen-in-train nodes, paper Tab.IV); NaN when the subset is empty.
    """
    pos = np.asarray(pos_logit, np.float64).reshape(-1)
    neg = np.asarray(neg_logit, np.float64).reshape(-1)
    y = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
    s = np.concatenate([pos, neg])
    out = {"ap": average_precision(y, s), "auc": roc_auc(y, s)}
    if inductive_mask is not None:
        m = np.asarray(inductive_mask, dtype=bool).reshape(-1)
        if m.shape[0] != len(pos):
            raise ValueError(
                f"inductive_mask has {m.shape[0]} entries for {len(pos)} "
                "positive/negative pairs")
        if m.any():
            y_i = np.concatenate([np.ones(int(m.sum())),
                                  np.zeros(int(m.sum()))])
            s_i = np.concatenate([pos[m], neg[m]])
            out["ap_inductive"] = average_precision(y_i, s_i)
            out["auc_inductive"] = roc_auc(y_i, s_i)
        else:
            out["ap_inductive"] = float("nan")
            out["auc_inductive"] = float("nan")
    return out
