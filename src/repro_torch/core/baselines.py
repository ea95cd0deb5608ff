"""Baseline graph partitioners the paper compares against (Tab.I/VI/VII/VIII),
copied from ``repro/core/baselines.py``.

Vertex-cut streaming baselines reuse the SEP engine (``streaming_vertex_cut``):
  * HDRF [14]   — SEP degenerate case: every node replicable, partial-degree
                  centrality (paper §III-B: "when there is no restriction for
                  top_k the algorithm degenerates to HDRF").
  * Greedy [13] — PowerGraph's heuristic: HDRF with uniform centrality
                  (theta == 0.5, i.e. degree-blind).
  * Random [9]  — uniform random edge assignment (Euler-style).

Edge-cut baselines (nodes live in exactly one partition; every edge whose
endpoints land in different partitions is cut — for TIG training those edges
are deleted):
  * LDG [10]    — Linear Deterministic Greedy node streaming.
  * KL [8]      — Kernighan-Lin, via recursive bisection (networkx);
                  the paper's representative *static* (slow, global) method.

METIS [7] is not reproducible offline (no library); KL plays the static-
partitioner role, exactly as in the paper's §III-D comparison.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.centrality import degree_centrality
from repro_torch.core.sep import PartitionResult, streaming_vertex_cut

__all__ = [
    "hdrf_partition",
    "greedy_partition",
    "random_partition",
    "ldg_partition",
    "kl_partition",
    "edge_cut_result_from_node_assignment",
]


def hdrf_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    lam: float = 1.0,
    eps: float = 1e-6,
) -> PartitionResult:
    """HDRF [14]: highest-degree nodes replicate first; no replication cap."""
    cent = degree_centrality(src, dst, num_nodes)
    res = streaming_vertex_cut(
        src,
        dst,
        num_nodes,
        num_parts,
        centrality=cent,
        hubs=None,
        lam=lam,
        eps=eps,
        algorithm="hdrf",
    )
    return res


def greedy_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    lam: float = 1.0,
) -> PartitionResult:
    """PowerGraph Greedy [13]: degree-blind vertex-cut streaming."""
    cent = np.ones(num_nodes, dtype=np.float64)
    return streaming_vertex_cut(
        src,
        dst,
        num_nodes,
        num_parts,
        centrality=cent,
        hubs=None,
        lam=lam,
        algorithm="greedy",
    )


def random_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    seed: int = 0,
) -> PartitionResult:
    """Uniform random edge assignment [9]: high RF, perfect edge balance."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    num_edges = len(src)
    edge_part = rng.integers(0, num_parts, size=num_edges).astype(np.int16)
    node_masks = np.zeros(num_nodes, dtype=np.uint64)
    one = np.uint64(1)
    np.bitwise_or.at(node_masks, np.asarray(src, np.int64),
                     one << edge_part.astype(np.uint64))
    np.bitwise_or.at(node_masks, np.asarray(dst, np.int64),
                     one << edge_part.astype(np.uint64))
    pop = np.array([int(m).bit_count() for m in node_masks])
    shared = np.nonzero(pop > 1)[0].astype(np.int64)
    return PartitionResult(
        num_parts=num_parts,
        num_nodes=num_nodes,
        edge_part=edge_part,
        node_masks=node_masks,
        shared_nodes=shared,
        hubs=None,
        elapsed_s=time.perf_counter() - t0,
        algorithm="random",
    )


def edge_cut_result_from_node_assignment(
    src: np.ndarray,
    dst: np.ndarray,
    node_part: np.ndarray,
    num_parts: int,
    elapsed_s: float,
    algorithm: str,
) -> PartitionResult:
    """Package an edge-cut partitioning (one partition per node).

    Edges whose endpoints disagree are cut (edge_part = -1): in the paper's
    training pipeline such edges are deleted, exactly like SEP's Case-3
    discards — which is how edge-cut partitioners plug into PAC unchanged.
    """
    node_part = np.asarray(node_part, dtype=np.int64)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    same = node_part[src] == node_part[dst]
    edge_part = np.where(same, node_part[src], -1).astype(np.int16)
    node_masks = (np.uint64(1) << node_part.astype(np.uint64)).astype(
        np.uint64
    )
    return PartitionResult(
        num_parts=num_parts,
        num_nodes=len(node_part),
        edge_part=edge_part,
        node_masks=node_masks,
        shared_nodes=np.zeros(0, dtype=np.int64),
        hubs=None,
        elapsed_s=elapsed_s,
        algorithm=algorithm,
    )


def ldg_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    capacity_slack: float = 1.1,
) -> PartitionResult:
    """Linear Deterministic Greedy [10] (node-stream, edge-cut).

    Nodes arrive in first-appearance order; each is placed in the partition
    maximizing |N(v) ∩ p| * (1 - |p|/C) with capacity C = slack * |V|/|P|.
    """
    t0 = time.perf_counter()
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    # Build adjacency (undirected) via CSR for neighbor lookups.
    import scipy.sparse as sp

    ones = np.ones(len(src), dtype=np.int8)
    adj = sp.coo_matrix(
        (np.concatenate([ones, ones]),
         (np.concatenate([src, dst]), np.concatenate([dst, src]))),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    inter = np.empty(len(src) * 2, dtype=np.int64)
    inter[0::2] = src
    inter[1::2] = dst
    _, first_idx = np.unique(inter, return_index=True)
    order = inter[np.sort(first_idx)]
    node_part = np.full(num_nodes, -1, dtype=np.int64)
    sizes = np.zeros(num_parts, dtype=np.float64)
    cap = capacity_slack * num_nodes / num_parts
    for v in order:
        lo, hi = adj.indptr[v], adj.indptr[v + 1]
        nbrs = adj.indices[lo:hi]
        assigned = node_part[nbrs]
        counts = np.zeros(num_parts, dtype=np.float64)
        valid = assigned[assigned >= 0]
        if valid.size:
            np.add.at(counts, valid, 1.0)
        scores = counts * (1.0 - sizes / cap)
        p = int(np.argmax(scores))
        node_part[v] = p
        sizes[p] += 1.0
    node_part[node_part < 0] = np.argmin(sizes)
    return edge_cut_result_from_node_assignment(
        src, dst, node_part, num_parts,
        time.perf_counter() - t0, "ldg",
    )


def kl_partition(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    seed: int = 0,
    max_iter: int = 10,
) -> PartitionResult:
    """Kernighan-Lin [8] recursive bisection (static, edge-cut, slow).

    num_parts must be a power of two.  This is the paper's Tab.VI-VIII
    static-partitioning baseline: good edge-cut, poor edge balance (KL
    balances *nodes*, not edges), and orders-of-magnitude slower than SEP.
    """
    import networkx as nx

    if num_parts & (num_parts - 1):
        raise ValueError("kl_partition requires a power-of-two num_parts")
    t0 = time.perf_counter()
    g = nx.Graph()
    g.add_nodes_from(range(num_nodes))
    g.add_edges_from(zip(np.asarray(src).tolist(), np.asarray(dst).tolist()))
    node_part = np.zeros(num_nodes, dtype=np.int64)

    def _bisect(nodes: list, base: int, span: int, depth_seed: int) -> None:
        if span == 1 or len(nodes) < 2:
            return
        sub = g.subgraph(nodes)
        a, b = nx.algorithms.community.kernighan_lin_bisection(
            sub, max_iter=max_iter, seed=depth_seed
        )
        a, b = list(a), list(b)
        for n in b:
            node_part[n] += span // 2
        _bisect(a, base, span // 2, depth_seed + 1)
        _bisect(b, base + span // 2, span // 2, depth_seed + 2)

    _bisect(list(range(num_nodes)), 0, num_parts, seed)
    return edge_cut_result_from_node_assignment(
        src, dst, node_part, num_parts,
        time.perf_counter() - t0, "kl",
    )
