"""Partition-quality metrics and theoretical bounds (paper Eq.7-11, Tab.VI),
copied from ``repro/core/metrics.py``.

    RF = total node replicas / total nodes                     (Eq.7)
    EC = total edge cuts between partitions / total edges      (Eq.8)

Theorems (worst-case bounds for SEP):

    Thm.1:  RF < k|P| + (1 - k)                                (Eq.9)
    Thm.2:  EC <= (1/|E|) * sum_{q=0}^{|V|(1-k)-1}
                    m * (k + q/|V|)^{1/(1-alpha)}              (Eq.11)

where m is the minimum degree and alpha the power-law skew (Eq.10, from
Cohen et al. [18]).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sep import PartitionResult

__all__ = [
    "PartitionStats",
    "replication_factor",
    "edge_cut_fraction",
    "partition_stats",
    "thm1_rf_bound",
    "thm2_ec_bound",
    "fit_power_law_alpha",
]


def replication_factor(res: PartitionResult, denominator: str = "placed"
                       ) -> float:
    """Eq.7 — average number of copies per node (counting all replicas).

    denominator="placed" (default, the operational metric): nodes never
    touched by any edge are excluded — they hold no memory and live on no
    device.  denominator="all" uses |V|, matching Thm.1's statement exactly.
    """
    pop = np.array(
        [int(m).bit_count() for m in res.node_masks], dtype=np.int64
    )
    if denominator == "all":
        n = res.num_nodes
    else:
        n = int((pop > 0).sum())
    if n == 0:
        return 0.0
    return float(pop.sum()) / n


def edge_cut_fraction(res: PartitionResult) -> float:
    """Eq.8 — fraction of edges lost to cuts/discards (edge_part == -1)."""
    e = len(res.edge_part)
    if e == 0:
        return 0.0
    return float((res.edge_part < 0).sum()) / e


@dataclasses.dataclass
class PartitionStats:
    """The Tab.VI row for one partitioning."""

    algorithm: str
    num_parts: int
    edge_cut: float            # "Total Cut" (fraction)
    edge_std: float            # "Edge Std."
    replication_factor: float
    avg_node_portion: float    # "Avg. Portion" — mean |V_p| / |V|
    node_std: float            # "Node Std."
    num_shared: int
    elapsed_s: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def partition_stats(res: PartitionResult) -> PartitionStats:
    edge_counts = res.edge_counts().astype(np.float64)
    node_counts = res.node_counts().astype(np.float64)
    placed = np.array(
        [int(m).bit_count() > 0 for m in res.node_masks]
    ).sum()
    denom = max(int(placed), 1)
    return PartitionStats(
        algorithm=res.algorithm,
        num_parts=res.num_parts,
        edge_cut=edge_cut_fraction(res),
        edge_std=float(edge_counts.std()),
        replication_factor=replication_factor(res),
        avg_node_portion=float(node_counts.mean()) / denom,
        node_std=float(node_counts.std()),
        num_shared=int(len(res.shared_nodes)),
        elapsed_s=res.elapsed_s,
    )


def thm1_rf_bound(k: float, num_parts: int) -> float:
    """Eq.9 — worst-case replication factor of SEP."""
    return k * num_parts + (1.0 - k)


def thm2_ec_bound(
    num_nodes: int,
    num_edges: int,
    k: float,
    m: float,
    alpha: float,
) -> float:
    """Eq.11 — worst-case edge-cut of SEP on a power-law graph.

    Args:
      m: minimum node degree.
      alpha: power-law exponent (> 1), per Cohen et al. (Eq.10).
    """
    if alpha <= 1.0:
        raise ValueError("power-law alpha must exceed 1")
    q = np.arange(int(num_nodes * (1.0 - k)))
    vals = m * np.power(k + q / num_nodes, 1.0 / (1.0 - alpha))
    return float(vals.sum()) / max(num_edges, 1)


def fit_power_law_alpha(degrees: np.ndarray, d_min: int = 1) -> float:
    """MLE power-law exponent: alpha = 1 + n / sum(ln(d / d_min))."""
    d = degrees[degrees >= d_min].astype(np.float64)
    if len(d) == 0:
        return 2.5
    return 1.0 + len(d) / float(np.log(d / (d_min - 0.5)).sum())
