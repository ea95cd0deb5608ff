"""PAC — Parallel Acceleration Component, host-side logic (paper §II-C),
copied from ``repro/core/pac.py``.

This module holds the *schedule* half of PAC (pure numpy, device-free):

  * ``shuffle_combine``  — the paper's random-shuffling strategy: partition
    into |P| > N small parts, then before every epoch randomly group them
    into N super-partitions.  Edges between small parts that land in the same
    group are *recovered* (trained this epoch).
  * ``build_subgraph``   — E_k = {(i,j,t) in E | i,j in V_k}: materialize a
    super-partition's edge stream (this is what recovers deleted edges).
  * ``LocalIndex``       — global<->local node-id mapping per device, with
    all partitions padded to the same local node count so one memory tensor
    (N_max_local, d) serves every device (the paper's "initialize a memory
    store module for each GPU with only maximisation of all GPUs nodes
    count").
  * ``cycle_schedule``   — Alg.2 loop-within-epoch: devices with fewer edges
    wrap around; steps_per_epoch = max_k(batches_k); per-device cycle length
    for the memory backup/restore rule.
  * ``sync_shared_memory`` — reference (numpy) implementation of the two
    shared-node memory synchronization modes: "latest" (largest timestamp
    wins — the paper's choice) and "mean".

The device half (the partitions' lockstep steps as one step over their
disjoint union, the mean of their losses, row-masked memory backup) lives
in ``repro_torch.tig.distributed`` and follows this schedule exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np

from repro_torch.core.sep import PartitionResult

__all__ = [
    "shuffle_combine",
    "member_mask",
    "subgraph_mask",
    "build_subgraph",
    "LocalIndex",
    "make_local_indices",
    "cycle_schedule",
    "CycleSchedule",
    "sync_shared_memory",
    "derived_speedup",
]


def shuffle_combine(
    node_lists: Sequence[np.ndarray],
    num_devices: int,
    rng: np.random.Generator,
) -> list[np.ndarray]:
    """Randomly group |P| small parts into ``num_devices`` super-partitions.

    |P| must be a multiple of N (the paper uses |P|=8 -> N=4).  Returns the
    union node list per super-partition.  Re-invoked before every epoch so
    different "deleted" edges are recovered across epochs (paper Fig.7).
    """
    p = len(node_lists)
    if p % num_devices:
        raise ValueError(f"|P|={p} not divisible by N={num_devices}")
    order = rng.permutation(p)
    group = p // num_devices
    combined = []
    for d in range(num_devices):
        ids = order[d * group: (d + 1) * group]
        combined.append(
            np.unique(np.concatenate([node_lists[i] for i in ids]))
        )
    return combined


def member_mask(nodes: np.ndarray, num_nodes: int) -> np.ndarray:
    """(num_nodes,) bool membership table for one device's node set."""
    member = np.zeros(num_nodes, dtype=bool)
    member[nodes] = True
    return member


def subgraph_mask(
    member: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> np.ndarray:
    """Per-edge mask: BOTH endpoints inside ``member`` (E_k of §II-C).

    Takes a prebuilt membership table so chunked callers (out-of-core
    localization over ``ShardedStream.edge_chunks``) pay the O(N) mask
    build once per device, not once per chunk."""
    return member[src] & member[dst]


def build_subgraph(
    src: np.ndarray,
    dst: np.ndarray,
    nodes: np.ndarray,
    num_nodes: int,
) -> np.ndarray:
    """Indices of edges with BOTH endpoints inside ``nodes`` (E_k of §II-C)."""
    keep = subgraph_mask(member_mask(nodes, num_nodes), src, dst)
    return np.nonzero(keep)[0]


@dataclasses.dataclass
class LocalIndex:
    """Global<->local node-id mapping for one device's memory shard.

    ``globals_`` is the sorted global-id vector (padded with -1 up to
    ``capacity`` so every device's mapping has identical shape);
    ``to_local`` is a (num_nodes,) int32 lookup, -1 for non-members.
    """

    globals_: np.ndarray   # (capacity,) int64, -1 padded
    to_local: np.ndarray   # (num_nodes,) int32
    num_real: int
    capacity: int

    def localize_edges(
        self, src: np.ndarray, dst: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.to_local[src], self.to_local[dst]


def make_local_indices(
    node_lists: Sequence[np.ndarray], num_nodes: int
) -> list[LocalIndex]:
    """Build per-device mappings, all padded to max partition node count."""
    cap = max((len(n) for n in node_lists), default=0)
    out = []
    for nodes in node_lists:
        nodes = np.sort(np.asarray(nodes, dtype=np.int64))
        g = np.full(cap, -1, dtype=np.int64)
        g[: len(nodes)] = nodes
        to_local = np.full(num_nodes, -1, dtype=np.int32)
        to_local[nodes] = np.arange(len(nodes), dtype=np.int32)
        out.append(
            LocalIndex(
                globals_=g,
                to_local=to_local,
                num_real=len(nodes),
                capacity=cap,
            )
        )
    return out


@dataclasses.dataclass
class CycleSchedule:
    """Alg.2 — lockstep steps with per-device wrap-around.

    At global step s, device k trains on its batch ``s % batches[k]``.
    Its data cycle ends whenever ``(s + 1) % batches[k] == 0`` — at that
    moment the device *backs up* its node memory; after the final step the
    memory is *restored* from the backup, so partially-replayed batches never
    leak into the next epoch (paper Alg.2 lines 10-11 + §II-C).
    """

    batches: np.ndarray          # (N,) int — real batches per device
    steps_per_epoch: int         # max_k batches[k]

    def batch_index(self, step: int) -> np.ndarray:
        return step % self.batches

    def is_cycle_end(self, step: int) -> np.ndarray:
        return (step + 1) % self.batches == 0


def cycle_schedule(edges_per_device: Sequence[int], batch_size: int) -> CycleSchedule:
    batches = np.maximum(
        1, -(-np.asarray(edges_per_device, dtype=np.int64) // batch_size)
    )
    return CycleSchedule(
        batches=batches, steps_per_epoch=int(batches.max())
    )


def sync_shared_memory(
    memories: np.ndarray,        # (N_dev, capacity, d)
    last_update: np.ndarray,     # (N_dev, capacity)
    shared_local: np.ndarray,    # (N_dev, S) local row of each shared node
    mode: Literal["latest", "mean"] = "latest",
) -> np.ndarray:
    """Reference shared-node memory synchronization (paper §II-C).

    ``shared_local[d, s]`` is the local row of global shared node s on device
    d (shared nodes exist on ALL devices per Alg.1 line 20).  Returns the
    synchronized copy of ``memories``.

      * "latest": every device adopts the replica with the largest
        last-update timestamp (the paper's choice).
      * "mean":   every device adopts the across-device mean.
    """
    n_dev, _, d = memories.shape
    s = shared_local.shape[1]
    out = memories.copy()
    if s == 0:
        return out
    dev = np.arange(n_dev)[:, None]
    rows = memories[dev, shared_local]          # (N_dev, S, d)
    times = last_update[dev, shared_local]      # (N_dev, S)
    if mode == "latest":
        winner = np.argmax(times, axis=0)       # (S,)
        chosen = rows[winner, np.arange(s)]     # (S, d)
    elif mode == "mean":
        chosen = rows.mean(axis=0)
    else:
        raise ValueError(mode)
    for k in range(n_dev):
        out[k, shared_local[k]] = chosen
    return out


def derived_speedup(edges_per_device: Sequence[int]) -> float:
    """Perfect-overlap speed-up bound: total_edges / max_device_edges.

    This is the schedule-derived bound, reported beside the measured
    per-edge step time.  With balanced partitions and N devices it
    approaches N; imbalance (e.g. KL's) directly shows up as a lower bound —
    the paper's Tab.VII effect.
    """
    e = np.asarray(edges_per_device, dtype=np.float64)
    if e.max() <= 0:
        return 1.0
    return float(e.sum() / e.max())
