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

__all__ = ["TemporalGraph"]


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
