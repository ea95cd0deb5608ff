"""Temporal Interaction Graph container (paper §II-A), copied from
``repro/tig/graph.py``.

G = (V, E) with E = {(i, j, t)} a chronologically-ordered interaction stream.
Node/edge features default to zero vectors for non-attributed graphs;
dynamic node labels (state-change indicators) are optional.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["TemporalGraph", "chronological_split"]


@dataclasses.dataclass
class TemporalGraph:
    """An edge stream with features.

    Attributes:
      src, dst: (E,) int64 node ids in [0, num_nodes).
      t: (E,) float64 timestamps, non-decreasing.
      edge_feat: (E, d_e) float32.
      node_feat: (num_nodes, d_n) float32.
      labels: optional (E,) int64 dynamic labels of the *source* node at the
        interaction time (the JODIE convention), -1 where unlabeled.
      name: dataset tag.
    """

    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray
    edge_feat: np.ndarray
    node_feat: np.ndarray
    labels: Optional[np.ndarray] = None
    name: str = "tig"

    def __post_init__(self):
        e = len(self.src)
        if not (len(self.dst) == e and len(self.t) == e
                and self.edge_feat.shape[0] == e):
            raise ValueError("src, dst, t and edge_feat need one row per edge")
        if not (np.diff(self.t) >= 0).all():
            raise ValueError("edges must be chronological")

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return len(self.src)

    @property
    def dim_edge(self) -> int:
        return self.edge_feat.shape[1]

    @property
    def dim_node(self) -> int:
        return self.node_feat.shape[1]

    def stats(self) -> dict:
        return {
            "name": self.name,
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "d_n": self.dim_node,
            "d_e": self.dim_edge,
            "classes": (
                0 if self.labels is None
                else int(self.labels[self.labels >= 0].max()) + 1
                if (self.labels >= 0).any() else 0
            ),
        }

    def slice_edges(self, idx: np.ndarray, name: Optional[str] = None
                    ) -> "TemporalGraph":
        """Sub-stream by edge indices (keeps global node id space)."""
        return TemporalGraph(
            src=self.src[idx],
            dst=self.dst[idx],
            t=self.t[idx],
            edge_feat=self.edge_feat[idx],
            node_feat=self.node_feat,
            labels=None if self.labels is None else self.labels[idx],
            name=name or self.name,
        )


def chronological_split(
    g: TemporalGraph,
    train_frac: float = 0.70,
    val_frac: float = 0.15,
) -> tuple[TemporalGraph, TemporalGraph, TemporalGraph, np.ndarray]:
    """70/15/15 chronological edge split (paper §III-A: the partitioner
    only ever sees the training split), as materialized sub-graphs, e.g.
    the partitioner's input. The boundaries and the never-seen-in-train
    nodes come from ``protocol`` (``split_bounds``,
    ``inductive_node_mask``).

    Returns (train, val, test, inductive_nodes): ``inductive_nodes`` are
    the nodes that never appear in training.
    """
    from repro_torch.tig.protocol import inductive_node_mask, split_bounds

    e = g.num_edges
    n_train, n_val = split_bounds(e, train_frac, val_frac)
    idx = np.arange(e)
    train = g.slice_edges(idx[:n_train], f"{g.name}/train")
    val = g.slice_edges(idx[n_train:n_val], f"{g.name}/val")
    test = g.slice_edges(idx[n_val:], f"{g.name}/test")
    inductive_nodes = np.nonzero(
        inductive_node_mask(g.src[:n_train], g.dst[:n_train],
                            g.num_nodes))[0]
    return train, val, test, inductive_nodes
