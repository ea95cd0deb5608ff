"""Node centrality for temporal interaction graphs (paper Eq.1-2), copied
from ``repro/core/centrality.py``.

The SEP partitioner ranks nodes by *temporal centrality*: the sum of
exponentially time-decayed weights of all edges historically incident to the
node,

    Cent(i) = sum_{t in T(i)} exp(beta * (t - t_max))          (Eq.1)

so that recently-active nodes dominate.  ``beta`` in (0, 1) controls the decay
rate.  The top ``k * |V|`` nodes by centrality become *hubs* — the only nodes
SEP is allowed to replicate across partitions.

For the theoretical edge-cut bound (Thm.2) the paper substitutes plain degree
for centrality; ``degree_centrality`` provides that variant (it is also what
HDRF effectively uses).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "temporal_centrality",
    "degree_centrality",
    "top_k_hubs",
    "normalized_theta",
]


def temporal_centrality(
    src: np.ndarray,
    dst: np.ndarray,
    t: np.ndarray,
    num_nodes: int,
    *,
    beta: float = 0.5,
    normalize_time: bool = True,
) -> np.ndarray:
    """Exponential time-decay centrality (paper Eq.1).

    Args:
      src, dst: int arrays of shape (E,) — edge endpoints.
      t: float array of shape (E,) — edge timestamps (any monotone unit).
      num_nodes: |V|.
      beta: decay rate, scalar hyper-parameter in (0, 1).
      normalize_time: if True, timestamps are rescaled to [0, 1] before the
        decay so ``beta`` has a dataset-independent meaning.  The paper uses
        raw timestamps; rescaling is an order-preserving reparameterisation of
        ``beta`` and keeps ``exp`` in a sane numeric range for datasets whose
        clocks are in (milli)seconds.

    Returns:
      float64 array of shape (num_nodes,) — Cent(i) per node.
    """
    if len(t) == 0:
        return np.zeros(num_nodes, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    t_max = float(t.max())
    if normalize_time:
        t_min = float(t.min())
        span = max(t_max - t_min, 1e-12)
        w = np.exp(beta * (t - t_max) / span)
    else:
        w = np.exp(beta * (t - t_max))
    cent = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(cent, np.asarray(src, dtype=np.int64), w)
    np.add.at(cent, np.asarray(dst, dtype=np.int64), w)
    return cent


def degree_centrality(
    src: np.ndarray, dst: np.ndarray, num_nodes: int
) -> np.ndarray:
    """Plain degree (multi-edge counted) — the Thm.2 / HDRF centrality."""
    cent = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(cent, np.asarray(src, dtype=np.int64), 1.0)
    np.add.at(cent, np.asarray(dst, dtype=np.int64), 1.0)
    return cent


def top_k_hubs(centrality: np.ndarray, k: float) -> np.ndarray:
    """Boolean hub mask: the ``ceil(k * |V|)`` nodes with largest centrality.

    ``k`` is the paper's ``top_k`` hyper-parameter expressed as a *fraction*
    in [0, 1] (the paper's tables quote it in percent).  ``k == 0`` means no
    node may replicate; ``k == 1`` degenerates SEP to HDRF (paper §III-B).
    """
    n = centrality.shape[0]
    mask = np.zeros(n, dtype=bool)
    if k <= 0.0 or n == 0:
        return mask
    n_hubs = min(n, int(np.ceil(k * n)))
    if n_hubs >= n:
        mask[:] = True
        return mask
    # argpartition: indices of the n_hubs largest centralities.
    idx = np.argpartition(centrality, n - n_hubs)[n - n_hubs:]
    mask[idx] = True
    return mask


def normalized_theta(cent_i: float, cent_j: float) -> float:
    """theta(i) = Cent(i) / (Cent(i) + Cent(j)) = 1 - theta(j)   (Eq.2)."""
    denom = cent_i + cent_j
    if denom <= 0.0:
        return 0.5
    return cent_i / denom
