"""SEP — Streaming Edge Partitioning (paper §II-B, Alg.1), copied from
``repro/core/sep.py``.

A single-pass, node-cut (vertex-cut) streaming partitioner for temporal
interaction graphs.  Edges arrive chronologically; each edge is immediately
assigned to one partition (or, for non-hub/non-hub conflicts, discarded).

Key properties (paper Tab.I):
  * temporal information     — hub selection uses time-decayed centrality,
  * low replication factor   — ONLY hub nodes may be replicated,
  * load balance             — greedy C_BAL term (Eq.6),
  * scalability              — O(|E| * |P|), one pass, O(|V| + |P|) state.

Scoring (Eq.2-6), for edge e=(i, j, t) and candidate partition p:

    theta(i)     = Cent(i) / (Cent(i) + Cent(j))                     (Eq.2)
    C(i, j, p)   = C_REP(i, j, p) + C_BAL(p)                         (Eq.3)
    C_REP(i,j,p) = h(i, p) + h(j, p)                                 (Eq.4)
    h(i, p)      = 1 + (1 - theta(i))  if p in A(i) else 0           (Eq.5)
    C_BAL(p)     = lam * (maxsize - |p|) / (eps + maxsize - minsize) (Eq.6)

Case analysis per Alg.1 (A(i) = set of partitions node i is assigned to):
  both assigned:
    Case 1  exactly one endpoint is a hub      -> partition of the non-hub
    Case 2  both endpoints are hubs            -> argmax_p C(i, j, p)
    Case 3  both non-hubs, same partition      -> that partition
            both non-hubs, different partition -> DISCARD the edge
  otherwise (Cases 4 & 5, at least one endpoint unassigned):
    argmax_p C(i, j, p), restricted so that an already-assigned NON-hub is
    never replicated (candidates = its single partition).

After the pass, every node present in >1 partition (hubs only, by
construction) is a *shared node*; per Alg.1 lines 17-22 shared nodes are added
to ALL partitions (their memory is synchronized globally by PAC).

Implementation notes (chunked-vectorized engine)
------------------------------------------------
The streaming pass is sequential in principle — every assignment mutates the
state later edges score against — but most of that sequential dependence is
an illusion.  The default engine exploits this with a chunked pass:

  * Edges are processed in blocks of ``chunk_size`` (~64k).  For each block
    the Alg.1 case of every edge is classified with vectorized numpy bitmask
    ops against the *start-of-block* assignment state.
  * Case-1 and Case-3 decisions depend only on quantities that are immutable
    within the block: a non-hub's single partition never changes once
    assigned (Thm.1), hub flags are static, and "assigned" only grows.  Any
    edge whose endpoints are BOTH already assigned at block start and that
    is not hub–hub therefore has a balance-independent, order-independent
    verdict — these (the bulk of a power-law stream after warm-up) are
    decided en masse: the non-hub partition is recovered from the single-bit
    mask with an exact ``frexp`` exponent, Case-3 conflicts are discarded by
    a vectorized mask comparison.
  * The remaining *dependency frontier* — score-based edges (Case 2 and
    Cases 4/5, whose C_BAL term sees every prior assignment) and edges
    touching a node first assigned inside the block — falls back to a scalar
    loop.  That loop is pure-Python bit arithmetic (no per-edge numpy), and
    the vectorized edges' side effects (partition-size increments, new hub
    bits) are merge-replayed into it *in stream order*, so every scalar
    score sees exactly the state the reference pass would.

The result is bit-identical to the per-edge reference pass
(``streaming_vertex_cut_reference``, kept as the parity oracle and exercised
by the property tests in ``tests/test_sep_chunked.py``) at >=10x the
throughput on million-edge streams (``benchmarks/table8_partition_time.py``).
Partition membership is a uint64 bitmask per node (|P| <= 64).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.centrality import (
    degree_centrality,
    temporal_centrality,
    top_k_hubs,
)

__all__ = [
    "PartitionResult",
    "sep_partition",
    "streaming_vertex_cut",
    "streaming_vertex_cut_reference",
]

_MAX_PARTS = 64  # uint64 bitmask
_DEFAULT_CHUNK = 65536


@dataclasses.dataclass
class PartitionResult:
    """Output of any partitioner in this package (vertex-cut or edge-cut).

    Attributes:
      num_parts: number of partitions |P|.
      num_nodes: |V| of the input graph.
      edge_part: (E,) int16 — partition id per edge, -1 for discarded edges.
      node_masks: (V,) uint64 — bitmask of partitions each node belongs to
        (AFTER shared-node broadcast, if the algorithm performs one).
      shared_nodes: (S,) int64 — nodes replicated in >1 partition ("shared
        nodes list" of Alg.1); their memory is synchronized by PAC.
      hubs: (V,) bool or None — hub mask used (None for non-SEP algorithms).
      elapsed_s: wall-clock partitioning time (paper Tab.VIII).
      algorithm: name tag.
    """

    num_parts: int
    num_nodes: int
    edge_part: np.ndarray
    node_masks: np.ndarray
    shared_nodes: np.ndarray
    hubs: Optional[np.ndarray]
    elapsed_s: float
    algorithm: str

    def nodes_of(self, p: int) -> np.ndarray:
        """Sorted global node ids belonging to partition ``p``."""
        return np.nonzero((self.node_masks >> np.uint64(p)) & np.uint64(1))[0]

    def node_lists(self) -> list[np.ndarray]:
        return [self.nodes_of(p) for p in range(self.num_parts)]

    def edge_counts(self) -> np.ndarray:
        counts = np.zeros(self.num_parts, dtype=np.int64)
        kept = self.edge_part[self.edge_part >= 0]
        np.add.at(counts, kept, 1)
        return counts

    def node_counts(self) -> np.ndarray:
        return np.array(
            [len(self.nodes_of(p)) for p in range(self.num_parts)],
            dtype=np.int64,
        )


def sep_partition(
    src: np.ndarray,
    dst: np.ndarray,
    t: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    k: float = 0.05,
    beta: float = 0.5,
    lam: float = 1.0,
    eps: float = 1e-6,
    centrality: Optional[np.ndarray] = None,
    shared_to_all: bool = True,
    chunk_size: int = _DEFAULT_CHUNK,
) -> PartitionResult:
    """SEP (Alg.1) with temporal centrality (Eq.1) hub selection.

    Args:
      src, dst, t: the edge stream, chronologically ordered.
      num_nodes: |V|.
      num_parts: |P| (<= 64).
      k: fraction of nodes designated hubs (paper's ``top_k``; 0 disables
        replication entirely, 1 degenerates to HDRF).
      beta: time-decay rate for Eq.1.
      lam: load-balance weight (Eq.6).
      eps: denominator guard (Eq.6).
      centrality: optional precomputed centrality (overrides Eq.1).
      shared_to_all: Alg.1 line 20 — broadcast shared nodes to all partitions.
      chunk_size: block size of the vectorized pass; ``0`` runs the per-edge
        reference pass instead (bit-identical, ~10x slower).
    """
    if centrality is None:
        centrality = temporal_centrality(src, dst, t, num_nodes, beta=beta)
    hubs = top_k_hubs(centrality, k)
    return streaming_vertex_cut(
        src,
        dst,
        num_nodes,
        num_parts,
        centrality=centrality,
        hubs=hubs,
        lam=lam,
        eps=eps,
        shared_to_all=shared_to_all,
        algorithm=f"sep(k={k},beta={beta})",
        chunk_size=chunk_size,
    )


def streaming_vertex_cut_reference(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    centrality: Optional[np.ndarray] = None,
    hubs: Optional[np.ndarray] = None,
    lam: float = 1.0,
    eps: float = 1e-6,
    shared_to_all: bool = True,
    algorithm: str = "streaming_vertex_cut",
) -> PartitionResult:
    """The per-edge reference pass — the parity oracle of the chunked engine.

    ``hubs=None`` means *every* node may replicate (no Case-3 discards) —
    with degree centrality that is exactly HDRF; with uniform centrality it is
    PowerGraph's Greedy heuristic.  A boolean ``hubs`` mask enables the SEP
    hub restriction.
    """
    if num_parts < 1 or num_parts > _MAX_PARTS:
        raise ValueError(f"num_parts must be in [1, {_MAX_PARTS}]")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    num_edges = src.shape[0]
    if centrality is None:
        centrality = degree_centrality(src, dst, num_nodes)

    t0 = time.perf_counter()

    # --- streaming state -------------------------------------------------
    # Partition sets A(i): python-int bitmasks (fast case checks / popcount)
    # mirrored by a bool matrix (vectorized Eq.4-5 scoring).
    assign_mask = [0] * num_nodes
    abits = np.zeros((num_nodes, num_parts), dtype=bool)
    part_edge_sizes = np.zeros(num_parts, dtype=np.float64)  # |p| in Eq.6
    edge_part = np.full(num_edges, -1, dtype=np.int16)
    restrict = hubs is not None
    hub_of = hubs if restrict else None
    cent = centrality
    part_bits = [1 << p for p in range(num_parts)]
    full_mask = (1 << num_parts) - 1

    def _score_and_pick(i: int, j: int, cand_bitmask: int) -> int:
        """argmax_p C(i, j, p) over candidate partitions (Eq.2-6)."""
        ci, cj = cent[i], cent[j]
        denom = ci + cj
        theta_i = 0.5 if denom <= 0 else ci / denom
        maxsize = part_edge_sizes.max()
        minsize = part_edge_sizes.min()
        bal = lam * (maxsize - part_edge_sizes) / (eps + maxsize - minsize)
        # C_REP (Eq.4-5): h(i,p) = 1 + (1 - theta(i)) when p in A(i).
        scores = (
            np.where(abits[i], 2.0 - theta_i, 0.0)
            + np.where(abits[j], 1.0 + theta_i, 0.0)
            + bal
        )
        if cand_bitmask != full_mask:
            cand = np.array(
                [p for p in range(num_parts) if cand_bitmask >> p & 1],
                dtype=np.int64,
            )
            return int(cand[int(np.argmax(scores[cand]))])
        return int(np.argmax(scores))

    def _assign(e: int, i: int, j: int, p: int) -> None:
        edge_part[e] = p
        part_edge_sizes[p] += 1.0
        bit = part_bits[p]
        assign_mask[i] |= bit
        assign_mask[j] |= bit
        abits[i, p] = True
        abits[j, p] = True

    for e in range(num_edges):
        i = int(src[e])
        j = int(dst[e])
        mi = assign_mask[i]
        mj = assign_mask[j]
        if mi and mj:
            if restrict:
                hi = bool(hub_of[i])
                hj = bool(hub_of[j])
                if hi != hj:
                    # Case 1: assign to the partition where the NON-hub lives
                    # (non-hubs live in exactly one partition by construction).
                    nm = mj if hi else mi
                    p = nm.bit_length() - 1
                    _assign(e, i, j, p)
                elif hi and hj:
                    # Case 2: both hubs -> best-scoring partition anywhere.
                    p = _score_and_pick(i, j, full_mask)
                    _assign(e, i, j, p)
                else:
                    # Case 3: both non-hubs.
                    if mi == mj:
                        p = mi.bit_length() - 1
                        _assign(e, i, j, p)
                    # else: discard (edge_part stays -1) — the only edge-cut
                    # source in SEP (Thm.2).
            else:
                # HDRF/Greedy: unrestricted replication, never discard; the
                # h terms (Eq.4-5) already pull the edge towards partitions
                # that hold i and/or j.
                p = _score_and_pick(i, j, full_mask)
                _assign(e, i, j, p)
        else:
            # Cases 4 & 5: at most one endpoint is assigned.  For SEP, an
            # assigned NON-hub pins the candidate set to its single partition
            # (non-hubs never replicate — Thm.1); hubs and fresh nodes score
            # over all partitions (paper line 16).  HDRF/Greedy always score
            # over all partitions; their h terms already favor A(i)/A(j).
            cand = full_mask
            if restrict:
                if mi and not hub_of[i]:
                    cand = mi
                elif mj and not hub_of[j]:
                    cand = mj
            p = _score_and_pick(i, j, cand)
            _assign(e, i, j, p)

    # --- epilogue: shared nodes (Alg.1 lines 17-22) -----------------------
    popcnt = np.array([m.bit_count() for m in assign_mask], dtype=np.int64)
    shared = np.nonzero(popcnt > 1)[0].astype(np.int64)
    if shared_to_all and shared.size:
        for i in shared:
            assign_mask[int(i)] = full_mask
    node_masks = np.array(
        [np.uint64(m) for m in assign_mask], dtype=np.uint64
    )
    elapsed = time.perf_counter() - t0

    return PartitionResult(
        num_parts=num_parts,
        num_nodes=num_nodes,
        edge_part=edge_part,
        node_masks=node_masks,
        shared_nodes=shared,
        hubs=(hub_of.copy() if restrict else None),
        elapsed_s=elapsed,
        algorithm=algorithm,
    )


def _single_bit_log2(mask: np.ndarray) -> np.ndarray:
    """Exact bit position of single-bit uint64 masks (frexp exponent)."""
    # single bits <= 2^63 convert to float64 exactly; frexp returns
    # (0.5, p + 1) exactly — no rounding anywhere.
    _, ex = np.frexp(mask.astype(np.float64))
    return (ex - 1).astype(np.int64)


def streaming_vertex_cut(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    centrality: Optional[np.ndarray] = None,
    hubs: Optional[np.ndarray] = None,
    lam: float = 1.0,
    eps: float = 1e-6,
    shared_to_all: bool = True,
    algorithm: str = "streaming_vertex_cut",
    chunk_size: int = _DEFAULT_CHUNK,
) -> PartitionResult:
    """Chunk-vectorized streaming engine behind SEP and the HDRF/Greedy
    baselines — bit-identical to ``streaming_vertex_cut_reference``.

    See the module docstring for the block decomposition.  ``chunk_size=0``
    delegates to the reference pass.
    """
    if chunk_size <= 0:
        return streaming_vertex_cut_reference(
            src, dst, num_nodes, num_parts, centrality=centrality, hubs=hubs,
            lam=lam, eps=eps, shared_to_all=shared_to_all,
            algorithm=algorithm)
    if num_parts < 1 or num_parts > _MAX_PARTS:
        raise ValueError(f"num_parts must be in [1, {_MAX_PARTS}]")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    num_edges = src.shape[0]
    if centrality is None:
        centrality = degree_centrality(src, dst, num_nodes)
    restrict = hubs is not None

    t0 = time.perf_counter()

    # --- streaming state ---------------------------------------------------
    # A(i) bitmasks live twice: a numpy array for the vectorized per-block
    # classification, a python list for the scalar frontier loop (C-long
    # reads are ~5x cheaper than numpy scalar extraction).  Both are updated
    # at every write site.
    masks_np = np.zeros(num_nodes, dtype=np.uint64)
    masks_l = [0] * num_nodes
    sizes = [0.0] * num_parts                         # |p| of Eq.6
    edge_part = np.full(num_edges, -1, dtype=np.int16)
    cent_l = np.asarray(centrality, dtype=np.float64).tolist()
    hubs_l = hubs.tolist() if restrict else None
    full_mask = (1 << num_parts) - 1
    parts_range = range(num_parts)
    parts_range1 = range(1, num_parts)

    # Tiered exact scoring (see _pick_score): requires theta in [0, 1] and
    # the strict tier separation 0 < bal < lam <= 1, plus enough headroom
    # that no float tie can cross a tier or hide a size difference.  The
    # imbalance guard (checked per call) keeps every relevant score gap
    # >= ~1e-12, i.e. ~3 orders of magnitude above double rounding at
    # magnitude 3; outside it we fall back to the oracle-mirror full scan.
    tier_ok = (0.0 < lam <= 1.0) and eps > 0.0 \
        and bool(np.all(np.asarray(centrality) >= 0.0))
    gap_lim = 1e12 * min(eps, lam) - eps if tier_ok else 0.0
    # O(1) imbalance guard for the inlined tier-1 path: cur_max is exact
    # (sizes only grow by 1), min_lb is a stale-but-valid lower bound on the
    # true min (the min never decreases), so cur_max - min_lb over-estimates
    # the true gap — failing edges re-check with the exact min.
    cur_max = 0.0
    min_lb = 0.0

    def _score_full(mi: int, mj: int, i: int, j: int,
                    cand_bitmask: int) -> int:
        """argmax_p C(i, j, p) — same float ops, same order, same first-max
        tie-break as the reference pass's numpy kernel."""
        ci = cent_l[i]
        cj = cent_l[j]
        denom = ci + cj
        theta_i = 0.5 if denom <= 0 else ci / denom
        a = 2.0 - theta_i
        b = 1.0 + theta_i
        maxsize = max(sizes)
        d = eps + maxsize - min(sizes)
        best_p = -1
        best_s = -np.inf
        for p in parts_range:
            if not (cand_bitmask >> p) & 1:
                continue
            s = ((a if (mi >> p) & 1 else 0.0)
                 + (b if (mj >> p) & 1 else 0.0)) \
                + lam * (maxsize - sizes[p]) / d
            if s > best_s:
                best_s = s
                best_p = p
        return best_p

    def _pick_score(mi: int, mj: int, i: int, j: int) -> int:
        """Full-candidate argmax_p C(i, j, p), via exact score tiers.

        With 0 < lam <= 1 and theta in [0, 1]: rep is 3 on partitions
        holding both endpoints, in [1, 2] on partitions holding one, 0
        elsewhere, while 0 <= bal < lam <= 1 — so the tiers are strictly
        ordered and the argmax lies in the best non-empty tier.  Within
        tier 1/3 all rep terms are equal, so argmax score = first argmin
        of |p| (bal is strictly decreasing in |p|).  Tie-breaks match
        np.argmax's first-max exactly; the imbalance guard rules out the
        astronomically-sized streams where float rounding could blur a
        tier boundary.
        """
        nonlocal min_lb
        maxsize = max(sizes)
        minsize = min(sizes)
        min_lb = minsize
        if not tier_ok or maxsize - minsize >= gap_lim:
            return _score_full(mi, mj, i, j, full_mask)
        both = mi & mj
        if both:
            best_p = -1
            best_s = np.inf
            m = both
            while m:
                low = m & -m
                p = low.bit_length() - 1
                sp = sizes[p]
                if sp < best_s:
                    best_s = sp
                    best_p = p
                m ^= low
            return best_p
        un = mi | mj
        if un:
            ci = cent_l[i]
            cj = cent_l[j]
            denom = ci + cj
            theta_i = 0.5 if denom <= 0 else ci / denom
            a = 2.0 - theta_i
            b = 1.0 + theta_i
            d = eps + maxsize - minsize
            best_p = -1
            best_s = -np.inf
            m = un
            while m:
                low = m & -m
                p = low.bit_length() - 1
                s = ((a if (mi >> p) & 1 else 0.0)
                     + (b if (mj >> p) & 1 else 0.0)) \
                    + lam * (maxsize - sizes[p]) / d
                if s > best_s:
                    best_s = s
                    best_p = p
                m ^= low
            return best_p
        best_p = 0
        best_s = sizes[0]
        for p in parts_range:
            if sizes[p] < best_s:
                best_s = sizes[p]
                best_p = p
        return best_p

    def _dispatch_edge(i: int, j: int) -> int:
        """Full Alg.1 case logic for a first-touch frontier edge (its case
        was unknown at block start); returns the partition or -1 (discard)."""
        mi = masks_l[i]
        mj = masks_l[j]
        if mi and mj:
            if restrict:
                hi = hubs_l[i]
                hj = hubs_l[j]
                if hi != hj:
                    return (mj if hi else mi).bit_length() - 1
                if hi:
                    return _pick_score(mi, mj, i, j)
                if mi != mj:
                    return -1          # Case-3 discard (Thm.2)
                return mi.bit_length() - 1
            return _pick_score(mi, mj, i, j)
        if restrict:
            # an assigned non-hub pins the candidate set to its single
            # partition: the restricted argmax is that partition, no floats.
            if mi and not hubs_l[i]:
                return mi.bit_length() - 1
            if mj and not hubs_l[j]:
                return mj.bit_length() - 1
        return _pick_score(mi, mj, i, j)

    for lo in range(0, num_edges, chunk_size):
        hi_ = min(lo + chunk_size, num_edges)
        bs = src[lo:hi_]
        bd = dst[lo:hi_]
        m_i = masks_np[bs]
        m_j = masks_np[bd]
        both = (m_i != 0) & (m_j != 0)

        if restrict:
            hub_i = hubs[bs]
            hub_j = hubs[bd]
            c1 = both & (hub_i ^ hub_j)                # Case 1
            c3 = both & ~(hub_i | hub_j)               # Case 3
            vec = c1 | c3
            known_score = both & hub_i & hub_j         # Case 2
        else:
            # HDRF/Greedy: every edge is score-based; both-assigned ones
            # have a statically-known code path (full-candidate scoring).
            vec = np.zeros(len(bs), dtype=bool)
            c1 = c3 = vec
            known_score = both

        # -- vectorized verdicts (balance- and order-independent) ----------
        pos1 = np.nonzero(c1)[0]
        if len(pos1):
            nh_mask = np.where(hub_i[pos1], m_j[pos1], m_i[pos1])
            p1 = _single_bit_log2(nh_mask)
            hub_node = np.where(hub_i[pos1], bs[pos1], bd[pos1])
        else:
            p1 = np.zeros(0, np.int64)
            hub_node = np.zeros(0, np.int64)

        pos3 = np.nonzero(c3)[0]
        keep3 = m_i[pos3] == m_j[pos3]
        pos3k = pos3[keep3]
        p3 = _single_bit_log2(m_i[pos3k])
        # Case-3 conflicts (mask mismatch) stay -1: the discard of Thm.2.

        edge_part[lo + pos1] = p1.astype(np.int16)
        edge_part[lo + pos3k] = p3.astype(np.int16)

        # effect stream of the vectorized edges, in block position order
        vpos = np.concatenate([pos1, pos3k])
        vpart = np.concatenate([p1, p3])
        vnode = np.concatenate([hub_node,
                                np.full(len(pos3k), -1, np.int64)])
        order = np.argsort(vpos, kind="stable")
        vpos, vpart, vnode = vpos[order], vpart[order], vnode[order]

        spos = np.nonzero(~vec)[0]
        if len(spos) == 0:
            # whole block vectorized: bulk-apply the effects
            _apply_effects_bulk(masks_np, masks_l, sizes, vpart, vnode,
                                num_parts)
            cur_max = max(sizes)
            continue

        # -- merge-replay: scalar frontier interleaved with vec effects ----
        sp_l = spos.tolist()
        si_l = bs[spos].tolist()
        sj_l = bd[spos].tolist()
        sk_l = known_score[spos].tolist()
        vp_l = vpos.tolist()
        vq_l = vpart.tolist()
        vn_l = vnode.tolist()
        nv = len(vp_l)
        v = 0
        spart: list[int] = []
        sp_append = spart.append
        dirty: list[int] = []                 # nodes whose numpy mask mirror
        d_append = dirty.append               # is stale (synced at block end)
        for pos, i, j, known in zip(sp_l, si_l, sj_l, sk_l):
            while v < nv and vp_l[v] < pos:
                q = vq_l[v]
                sq = sizes[q] + 1.0
                sizes[q] = sq
                if sq > cur_max:
                    cur_max = sq
                n = vn_l[v]
                if n >= 0:
                    masks_l[n] |= 1 << q
                    d_append(n)
                v += 1
            mi = masks_l[i]
            mj = masks_l[j]
            if known:
                # dominant path, inlined: both-endpoint tier (rep = 3
                # everywhere in A(i) ∩ A(j)) -> first argmin of |p|.
                bb = mi & mj
                if bb == full_mask and tier_ok \
                        and cur_max - min_lb < gap_lim:
                    # steady-state hub-hub edge: both masks saturated, so
                    # the verdict is first-argmin(|p|) and the assignment
                    # cannot add mask bits — sizes is the only effect.
                    p = 0
                    best_s = sizes[0]
                    for pp in parts_range1:
                        sp = sizes[pp]
                        if sp < best_s:
                            best_s = sp
                            p = pp
                    sp_append(p)
                    sp = sizes[p] + 1.0
                    sizes[p] = sp
                    if sp > cur_max:
                        cur_max = sp
                    continue
                if bb and tier_ok and cur_max - min_lb < gap_lim:
                    p = -1
                    best_s = np.inf
                    m = bb
                    while m:
                        low = m & -m
                        pp = low.bit_length() - 1
                        sp = sizes[pp]
                        if sp < best_s:
                            best_s = sp
                            p = pp
                        m ^= low
                else:
                    p = _pick_score(mi, mj, i, j)
            else:
                p = _dispatch_edge(i, j)
                if p < 0:
                    sp_append(-1)
                    continue
            sp_append(p)
            sp = sizes[p] + 1.0
            sizes[p] = sp
            if sp > cur_max:
                cur_max = sp
            bit = 1 << p
            masks_l[i] = mi | bit
            masks_l[j] = masks_l[j] | bit
            d_append(i)
            d_append(j)
        edge_part[lo + spos] = np.array(spart, dtype=np.int16)
        if v < nv:
            _apply_effects_bulk(masks_np, masks_l, sizes, vpart[v:],
                                vnode[v:], num_parts)
            cur_max = max(sizes)
        if dirty:
            dn = np.array(dirty, dtype=np.int64)
            masks_np[dn] = np.array([masks_l[x] for x in dirty],
                                    dtype=np.uint64)

    # --- epilogue: shared nodes (Alg.1 lines 17-22) -----------------------
    popcnt = _popcount(masks_np)
    shared = np.nonzero(popcnt > 1)[0].astype(np.int64)
    if shared_to_all and shared.size:
        masks_np[shared] = np.uint64(full_mask)
    elapsed = time.perf_counter() - t0

    return PartitionResult(
        num_parts=num_parts,
        num_nodes=num_nodes,
        edge_part=edge_part,
        node_masks=masks_np,
        shared_nodes=shared,
        hubs=(hubs.copy() if restrict else None),
        elapsed_s=elapsed,
        algorithm=algorithm,
    )


def _apply_effects_bulk(masks_np: np.ndarray, masks_l: list, sizes: list,
                        vpart: np.ndarray, vnode: np.ndarray,
                        num_parts: int) -> None:
    """Apply vectorized edges' side effects (order-commutative adds/ORs)."""
    if len(vpart) == 0:
        return
    counts = np.bincount(vpart, minlength=num_parts)
    for p in range(num_parts):
        sizes[p] += float(counts[p])
    upd = vnode >= 0
    if upd.any():
        np.bitwise_or.at(
            masks_np, vnode[upd],
            np.uint64(1) << vpart[upd].astype(np.uint64))
        for n, q in zip(vnode[upd].tolist(), vpart[upd].tolist()):
            masks_l[n] |= 1 << q


def _popcount(masks: np.ndarray) -> np.ndarray:
    try:
        return np.bitwise_count(masks).astype(np.int64)
    except AttributeError:  # numpy < 2.0
        return np.array([int(m).bit_count() for m in masks], dtype=np.int64)
