"""PAC — parallel training of TIG models over SEP partitions (paper §II-C,
Alg.2), on one card, as ``repro/tig/distributed.py``'s single-host
executor.

The JAX package runs one device epoch per partition under
``jax.vmap(..., axis_name="part")``: P lockstep scans with their
gradients ``pmean``'d. Here the P partitions' steps are ONE step over the
disjoint union of their sub-graphs, so the model and its kernels run
unchanged, once a step, over P x B rows:

* partition k's local node i is union row ``k * cap + i`` and every local
  dump row maps to the one union dump row ``P * cap`` (the kernels take
  the last row as the dump row); edge rows likewise with ``e_cap``;
* the flat batch grid's ids are offset on the host (``union_plan``), and
  at lockstep step s partition k reads its grid row
  ``offsets[k] + s % n_batches[k]`` and samples as of batch
  ``s % n_batches[k]`` (a per-row batch index: still one sampling launch);
* each partition's loss is its own batch mean, and the step descends the
  mean of the P losses, whose gradient is the ``pmean`` of theirs;
* Alg.2's cycle runs per partition as row-masked selects: a partition's
  rows are reset at ``s % n_k == 0`` and backed up at
  ``(s + 1) % n_k == 0``; the epoch returns the backup.

The step is ``engine._Epoch``'s, so on the card the epoch replays one
captured CUDA graph a step (``make_pac_epoch``) and on the CPU it is a
plain loop (``scan_pac_epoch``). The shared-node memory sync runs once an
epoch, outside the graph, on the states unstacked to the JAX package's
(P, cap + 1, ...) layout.

Host planning (``EpochPlan``, ``plan_epoch``) is a copy of the JAX
package's, drawing from the same numpy generators in the same order, so
the plans are equal array for array; ``pac_train`` builds the next
epoch's plan on an ``EpochPrefetcher`` worker while the current epoch
replays. Ported: an in-memory ``TemporalGraph`` source and an out-of-core
``ShardedStream`` one (localized shard by shard, the graph never
materialized), the replicated flat layout and the row-range-sharded one
(``layout="sharded"``, ``local_ranks``), ``plan="host"`` and
``"device"``, ``n_layers`` > 1, node classification and the restarter
warm-up of the scoring.

Several cards (``pac_train(mesh=launch.mesh.make_tig_mesh())``, the
counterpart of the JAX package's ``shard_map`` over a process-spanning
"part" axis): one process (rank) a card, each holding a contiguous block
of the P partitions. A rank plans only its own partitions' rows
(``plan_epoch(layout="sharded", local_ranks=...)``) and runs their union
step; the ranks meet in one all-reduce (an average) of the gradients a
lockstep step (inside the captured step on the card) and in the
shared-node sync at each epoch boundary, through ``torch.distributed``
(NCCL on the cards, gloo on the CPU).

The epoch boundary is overlapped by default (``epoch_boundary=
"overlap"``): on the card the shared-node sync of epoch e runs on a side
stream of its own while epoch e+1 replays, and the loss reads are
collected after the loop. ``pac_train`` also snapshots ``{params,
opt_state, states}`` every ``ckpt_every`` epochs in the JAX package's
checkpoint format, resumes from the newest one (``resume``), fires the
fault sites of ``repro_torch.faults`` and, over several ranks, reports a
lost peer as ``faults.HostLossError`` (what ``launch.pac_cluster``'s
elastic supervisor re-forms the world on).

``host_replay=True`` is the parity oracle of the wrap-around: the host
replays each device's batch grid to the epoch's ``steps`` rows
(``plan_epoch``) and a lockstep step reads row s of each device's
replayed grid, no ``s % n_batches[k]``; it runs the same graphed step,
and gives the same bits as the default.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Literal, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.pac import (build_subgraph, cycle_schedule,
                                  derived_speedup, make_local_indices,
                                  shuffle_combine, subgraph_mask)
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.sep import PartitionResult
from repro_torch.device import resolve_device
from repro_torch.faults import FaultInjector, HostLossError, is_host_loss
from repro_torch.launch.mesh import local_part_ranks
from repro_torch.optim import Optimizer, adamw
from repro_torch.tig import engine
from repro_torch.tig.batching import (LocalStream, build_batch_program,
                                      concat_batch_programs, make_tables,
                                      pad_batch_programs)
from repro_torch.tig.cache import lru_get
from repro_torch.tig.graph import TemporalGraph
from repro_torch.tig.models import TIGConfig, init_state
from repro_torch.tig.protocol import run_protocol, split_views, time_scale_of
from repro_torch.tig.restart import build_restarter, save_restarter
from repro_torch.tig.sampler import ChronoNeighborIndex
from repro_torch.tig.stream import (EpochPrefetcher, RowStager,
                                    ShardedStream, stage_device_tables,
                                    stage_partitioned, stage_replicated)
from repro_torch.tig.train import _initial_params, epoch_rng
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["EpochPlan", "plan_epoch", "union_plan", "unstack_states",
           "scan_pac_epoch", "make_pac_epoch", "sync_shared_memory",
           "make_pac_sync", "globalize_memory", "stage_replicated_tree", "PACResult",
           "pac_train"]

_GRAPHS_MAX = 4          # captured PAC epochs a program keeps (LRU)
StreamSource = Union[TemporalGraph, ShardedStream]


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported to repro_torch yet")


# ======================================================================
# host-side epoch planning
# ======================================================================

@dataclasses.dataclass
class EpochPlan:
    """Everything one PAC epoch needs.

    Replicated layout: ``batches`` is a flat (sum_k n_batches_k, ...)
    dict of numpy arrays — each device's real batch grid, concatenated,
    in its LOCAL ids — and ``offsets`` holds each device's start row;
    device k reads row ``offsets[k] + s % n_batches[k]`` at lockstep step
    s (Alg.2 wrap-around). A device plan's ``tcsr`` holds an (N_dev,
    cap+1) ``indptr``, each row offset by its device's base in the flat
    event arrays ``nbr`` / ``t`` / ``eidx`` / ``bat`` (the per-device
    ``device_export``s concatenated, each with its front pad).

    ``layout="sharded"`` cuts the same plan by per-device row ranges:
    ``batches`` is a zero-padded (N_held, rows_cap, ...) stack (rows_cap
    = the global max n_batches_k), ``offsets`` is all zero, and a device
    plan's ``tcsr`` keeps per-device UNOFFSET ``indptr`` rows and event
    rows padded to the global ``ev_cap``. With ``local_ranks`` only those
    devices' rows are built (N_held = len(local_ranks)); the schedule
    (``n_batches``, ``steps``, the capacities, ``shared_local``) stays
    global, so every rank plans the same lockstep epoch.

    ``host_replay`` (the oracle): ``batches`` is (N_dev, steps, ...),
    each device's grid replayed on the host, row s its batch
    ``s % n_batches[k]``, and ``offsets`` is None.
    """

    batches: dict                 # flat (sum real, ...) / sharded
                                  # (N_held, rows_cap, ...) / replayed
                                  # (N_dev, steps, ...)
    n_batches: np.ndarray         # (N_dev,) real batches per device
    nfeat_local: np.ndarray       # (N_held, cap+1, d_n)
    efeat_local: np.ndarray       # (N_held, e_cap+1, d_e)
    shared_local: np.ndarray      # (N_dev, S) local rows of shared nodes
    node_lists: list[np.ndarray]  # global ids per device
    capacity: int                 # padded local node count
    edge_capacity: int            # padded local edge count
    steps: int
    edges_per_device: np.ndarray  # (N_dev,)
    offsets: Optional[np.ndarray] = None   # (N_dev,) flat-grid start rows
    host_replay: bool = False
    tcsr: Optional[dict] = None   # device plan only
    layout: str = "replicated"    # "replicated" | "sharded"
    local_ranks: Optional[np.ndarray] = None  # devices built here

    def held_ranks(self) -> np.ndarray:
        """The devices whose rows the plan's arrays hold, in their order
        (every device unless it was planned with ``local_ranks``)."""
        if self.local_ranks is None:
            return np.arange(len(self.n_batches))
        return self.local_ranks

    def grid_bytes(self) -> int:
        """Host bytes of the batch grids (what the epoch must transfer)."""
        return int(sum(np.asarray(v).nbytes for v in self.batches.values()))

    def tcsr_bytes(self) -> int:
        """Host bytes of the exported T-CSR (0 for host-sampled plans)."""
        if self.tcsr is None:
            return 0
        return int(sum(np.asarray(v).nbytes for v in self.tcsr.values()))

    def plan_bytes(self) -> int:
        """Host bytes of the batch grids and (device plan) the T-CSR."""
        return self.grid_bytes() + self.tcsr_bytes()

    def device_input_bytes(self) -> int:
        """Grid and T-CSR bytes ONE device receives: the replicated layout
        ships every device the whole flat grid and event buffer, the
        sharded one and the host replay only the device's own row."""
        if self.layout == "sharded" or self.host_replay:
            held = len(np.asarray(next(iter(self.batches.values()))))
            return self.plan_bytes() // max(held, 1)
        return self.plan_bytes()


def _localize_in_memory(g: TemporalGraph, node_lists: list[np.ndarray],
                        local, cap: int, time_scale: float, ranks: list):
    """Per-device localized streams and feature gathers from an in-memory
    ``TemporalGraph``; edge ids are LOCAL, into each device's own feature
    table. Only the devices in ``ranks`` are built (streams None for the
    others, feature rows in ``ranks`` order); the edge counts are every
    device's, for the global schedule."""
    n_dev = len(node_lists)
    held = set(ranks)
    streams: list[Optional[LocalStream]] = []
    edges_per_device = np.zeros(n_dev, dtype=np.int64)
    edge_globals: dict[int, np.ndarray] = {}
    for k, (nodes, li) in enumerate(zip(node_lists, local)):
        eidx = build_subgraph(g.src, g.dst, nodes, g.num_nodes)
        edges_per_device[k] = len(eidx)
        if k not in held:
            streams.append(None)
            continue
        edge_globals[k] = eidx
        streams.append(LocalStream(
            src=li.to_local[g.src[eidx]].astype(np.int64),
            dst=li.to_local[g.dst[eidx]].astype(np.int64),
            t=g.t[eidx] / time_scale,
            eidx=np.arange(len(eidx), dtype=np.int64),
            num_local_nodes=cap,
            labels=None if g.labels is None else g.labels[eidx],
        ))

    nfeat_local = np.zeros((len(ranks), cap + 1, g.dim_node), np.float32)
    for row, k in enumerate(ranks):
        li = local[k]
        real_ids = li.globals_[: li.num_real]
        nfeat_local[row, : li.num_real] = g.node_feat[real_ids]

    e_cap = int(edges_per_device.max()) if n_dev else 0
    efeat_local = np.zeros((len(ranks), e_cap + 1, g.dim_edge), np.float32)
    for row, k in enumerate(ranks):
        eg = edge_globals[k]
        efeat_local[row, : len(eg)] = g.edge_feat[eg]
    return streams, edges_per_device, nfeat_local, efeat_local


def _localize_sharded(shards: ShardedStream, node_lists: list[np.ndarray],
                      local, cap: int, cfg: TIGConfig, time_scale: float,
                      ranks: list):
    """Per-device localized streams, their T-CSRs and feature gathers
    straight from ``tig-shards-v1`` row-range chunks; the graph is never
    materialized. One pass over ``edge_chunks(features=True)`` classifies
    each shard's edges against every device's membership (the counts
    drive the global schedule), and localizes ids and gathers feature rows
    for the devices in ``ranks`` only, so the host holds one shard plus
    those devices' own streams and rows. Each device's index is built by
    ``ChronoNeighborIndex.from_chunks`` over its pieces (the one-shot
    build's arrays); edge ids are LOCAL, into its own feature table."""
    n_dev = len(node_lists)
    held = set(ranks)
    members = [li.to_local >= 0 for li in local]
    pieces: list[list[tuple]] = [[] for _ in range(n_dev)]
    feat_parts: list[list[np.ndarray]] = [[] for _ in range(n_dev)]
    cursors = np.zeros(n_dev, dtype=np.int64)

    for src, dst, t, _eidx, efeat in shards.edge_chunks(features=True):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        for k, li in enumerate(local):
            keep = subgraph_mask(members[k], src, dst)
            m = int(keep.sum())
            if m == 0:
                continue
            # rows are appended in stream order: local ids are the cursor
            eidx_local = np.arange(cursors[k], cursors[k] + m,
                                   dtype=np.int64)
            cursors[k] += m
            if k not in held:
                continue
            pieces[k].append((
                li.to_local[src[keep]].astype(np.int64),
                li.to_local[dst[keep]].astype(np.int64),
                np.asarray(t, np.float64)[keep] / time_scale,
                eidx_local,
            ))
            feat_parts[k].append(efeat[keep])

    streams: list[Optional[LocalStream]] = [None] * n_dev
    indexes: list[Optional[ChronoNeighborIndex]] = [None] * n_dev
    edges_per_device = cursors.copy()
    e_cap = int(edges_per_device.max()) if n_dev else 0
    efeat_local = np.zeros((len(ranks), e_cap + 1, shards.dim_edge),
                           np.float32)
    for row, k in enumerate(ranks):
        chunks = pieces[k]

        def cat(i, chunks=chunks):
            return (np.concatenate([c[i] for c in chunks]) if chunks
                    else np.zeros(0, np.int64 if i != 2 else np.float64))

        streams[k] = LocalStream(
            src=cat(0), dst=cat(1), t=cat(2), eidx=cat(3),
            num_local_nodes=cap, labels=None)
        # an edge-less device is one padding batch, which the one-shot
        # build handles (from_chunks would count 0 batches)
        indexes[k] = (ChronoNeighborIndex.from_chunks(
            chunks, cap, cfg.num_neighbors, cfg.batch_size)
            if chunks else None)
        if feat_parts[k]:
            efeat_local[row, : edges_per_device[k]] = \
                np.concatenate(feat_parts[k])
        # the device's stream and index own new arrays: free the pieces
        feat_parts[k] = []
        pieces[k] = []

    nfeat_local = np.zeros((len(ranks), cap + 1, shards.dim_node),
                           np.float32)
    nfeat = shards.node_feat()          # memory-mapped (or zeros)
    for row, k in enumerate(ranks):
        li = local[k]
        real_ids = li.globals_[: li.num_real]
        nfeat_local[row, : li.num_real] = np.asarray(nfeat[real_ids],
                                                     np.float32)
    return streams, indexes, edges_per_device, nfeat_local, efeat_local


def plan_epoch(
    source: StreamSource,
    node_lists: list[np.ndarray],
    shared_nodes: np.ndarray,
    cfg: TIGConfig,
    rng: np.random.Generator,
    *,
    steps_override: Optional[int] = None,
    time_scale: Optional[float] = None,
    host_replay: bool = False,
    plan: str = "host",
    layout: str = "replicated",
    local_ranks=None,
) -> EpochPlan:
    """Localize each device's sub-graph and build its batch program, as
    the JAX package's ``plan_epoch`` does: one child seed per device drawn
    from ``rng`` first, then each device's negatives from its own
    generator. ``source`` is an in-memory ``TemporalGraph`` or an
    out-of-core ``ShardedStream`` (localized shard by shard; the same
    plan). ``plan="device"`` ships raw-edge programs and the per-device
    T-CSRs; ``plan="host"`` pre-samples the neighbor grids.
    ``steps_override`` cuts the lockstep epoch short.

    ``layout="sharded"`` cuts the plan by per-device row ranges (see
    ``EpochPlan``); ``local_ranks`` (sharded only) builds only those
    devices' programs, features and T-CSRs, while the edge counts and the
    per-device child seeds are drawn for every device, so each rank
    derives the same global schedule and device k's stream does not
    depend on which devices a rank plans.

    ``host_replay=True`` (the parity oracle; host plan, replicated layout)
    replays each device's batch grid on the host to ``steps`` rows, row s
    being its batch ``s % n_batches[k]``: ``batches`` is (N_dev, steps,
    ...) and ``offsets`` None.
    """
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    if host_replay and plan == "device":
        raise ValueError(
            "host_replay is the host-planned parity oracle; it cannot be "
            "combined with plan='device'")
    if layout not in ("replicated", "sharded"):
        raise ValueError(
            f"layout={layout!r}: expected 'replicated' or 'sharded'")
    if host_replay and layout == "sharded":
        raise ValueError(
            "host_replay IS the legacy replicated-schedule oracle; use "
            "layout='sharded' without it")
    if not isinstance(source, (TemporalGraph, ShardedStream)):
        raise _not_ported(f"a {type(source).__name__} source")
    n_dev = len(node_lists)
    if local_ranks is not None:
        if layout != "sharded":
            raise ValueError(
                "local_ranks requires layout='sharded' (the replicated "
                "flat grid needs every device's rows)")
        ranks = [int(r) for r in np.asarray(local_ranks).ravel()]
        if ranks != sorted(set(ranks)) or not ranks \
                or ranks[0] < 0 or ranks[-1] >= n_dev:
            raise ValueError(f"local_ranks={ranks}: expected sorted unique "
                             f"ranks within [0, {n_dev})")
    else:
        ranks = list(range(n_dev))
    local = make_local_indices(node_lists, source.num_nodes)
    cap = local[0].capacity if local else 0
    seeds = rng.integers(0, 2**63, size=n_dev) if n_dev else []
    if isinstance(source, ShardedStream):
        if time_scale is None:
            time_scale = time_scale_of(source.column("t"))
        streams, indexes, edges_per_device, nfeat_local, efeat_local = \
            _localize_sharded(source, node_lists, local, cap, cfg,
                              time_scale, ranks)
    else:
        time_scale = time_scale or time_scale_of(source.t)
        streams, edges_per_device, nfeat_local, efeat_local = \
            _localize_in_memory(source, node_lists, local, cap, time_scale,
                                ranks)
        indexes = [None] * n_dev

    sched = cycle_schedule(edges_per_device, cfg.batch_size)
    steps = steps_override or sched.steps_per_epoch

    programs, exports = [], []          # aligned with ranks
    for k in ranks:
        stream, idx = streams[k], indexes[k]
        if plan == "device" and idx is None:
            # the device plan exports the index itself (an edge-less
            # stream gives the empty index: all -1 samples)
            idx = ChronoNeighborIndex(
                stream.src, stream.dst, stream.t, stream.eidx,
                cap, cfg.num_neighbors, cfg.batch_size)
        if plan == "device":
            exports.append(idx.device_export(depth=cfg.n_layers))
        real, _ = build_batch_program(
            stream, cfg, np.random.default_rng(int(seeds[k])),
            index=idx if (idx is not None and stream.num_edges) else None,
            plan=plan)
        real.pop("labels", None)
        programs.append(real)
    # the real batch counts are global (the lockstep schedule); the built
    # programs must agree with the cycle schedule
    real_batches = np.asarray(sched.batches, dtype=np.int64)
    for row, k in enumerate(ranks):
        if len(programs[row]["src"]) != real_batches[k]:
            raise AssertionError((k, len(programs[row]["src"]),
                                  real_batches[k]))
    n_batches = np.minimum(real_batches, steps).astype(np.int32)

    tcsr = None
    if plan == "device" and layout == "sharded":
        # per-device rows with UNOFFSET indptr, events padded to a global
        # cap derived from the edge counts alone (an export holds 2 events
        # an edge and K * depth front pad), so every rank pads alike; the
        # pad events lie past indptr[cap] and are never read
        ev_cap = int((2 * edges_per_device
                      + cfg.num_neighbors * cfg.n_layers).max())
        for k, e in zip(ranks, exports):
            if len(e["nbr"]) != 2 * edges_per_device[k] + \
                    cfg.num_neighbors * cfg.n_layers:
                raise AssertionError((k, len(e["nbr"])))
        tcsr = {
            "indptr": np.stack([e["indptr"] for e in exports]),
            **{key: np.stack([np.pad(e[key], (0, ev_cap - len(e[key])))
                              for e in exports])
               for key in ("nbr", "t", "eidx", "bat")},
        }
    elif plan == "device":
        lens = [len(e["nbr"]) for e in exports]
        bases = np.cumsum([0] + lens)[:-1]
        tcsr = {
            "indptr": np.stack([e["indptr"] + np.int32(b)
                                for e, b in zip(exports, bases)]),
            **{key: np.concatenate([e[key] for e in exports])
               for key in ("nbr", "t", "eidx", "bat")},
        }

    trimmed = [{kk: v[: n_batches[k]] for kk, v in p.items()}
               for k, p in zip(ranks, programs)]
    offsets = None
    if host_replay:
        # Alg.2's wrap-around on the host: each device's grid replayed
        # from its start to the lockstep length
        replayed = [{kk: v[np.arange(steps) % len(p["src"])]
                     for kk, v in p.items()} for p in programs]
        batches = {kk: np.stack([d[kk] for d in replayed])
                   for kk in replayed[0]}
    elif layout == "sharded":
        # device k owns row k of a padded stack: offsets are all zero
        rows_cap = int(n_batches.max()) if n_dev else 0
        batches = pad_batch_programs(trimmed, rows_cap)
        offsets = np.zeros(n_dev, np.int32)
    else:
        batches, offsets = concat_batch_programs(trimmed)

    shared_local = np.zeros((n_dev, len(shared_nodes)), np.int32)
    for k, li in enumerate(local):
        rows = li.to_local[shared_nodes] if len(shared_nodes) else \
            np.zeros(0, np.int32)
        if len(shared_nodes) and (rows < 0).any():
            raise ValueError(
                "shared nodes must be present on every device "
                "(Alg.1 line 20 shared_to_all)")
        shared_local[k] = rows

    return EpochPlan(
        batches=batches,
        n_batches=n_batches,
        nfeat_local=nfeat_local,
        efeat_local=efeat_local,
        shared_local=shared_local,
        node_lists=list(node_lists),
        capacity=cap,
        edge_capacity=int(edges_per_device.max()) if n_dev else 0,
        steps=steps,
        edges_per_device=edges_per_device,
        offsets=offsets,
        host_replay=host_replay,
        tcsr=tcsr,
        layout=layout,
        local_ranks=None if local_ranks is None
        else np.asarray(ranks, np.int64),
    )


# ======================================================================
# the disjoint union of the partitions
# ======================================================================

_NODE_KEYS = ("src", "dst", "neg", "nbr_src", "nbr_dst", "nbr_neg")
_EDGE_KEYS = ("eidx", "nbre_src", "nbre_dst", "nbre_neg")


def union_plan(plan: EpochPlan, cfg: TIGConfig, ranks=None) -> dict:
    """The epoch plan over the disjoint union of the partitions ``ranks``
    (default: every device whose rows the plan holds), as numpy arrays:
    the j-th of them, device k, has its local node i at union row
    ``j * cap + i`` and its local edge at row ``j * e_cap + e``, and every
    local dump row maps to the union's one dump row (``n * cap`` /
    ``n * e_cap`` for n partitions). A rank of a mesh passes its own
    partitions and builds no array of another rank's.

    * ``batches``: the devices' real grid rows, concatenated, their node
      and edge ids offset by their device's position (-1 stays -1);
      ``offsets`` / ``n_batches`` the devices' start rows and cycle
      lengths in it (the same arrays from either layout); from a
      ``host_replay`` plan, each device's ``steps`` replayed rows, and
      ``host_replay`` True: step s reads row ``offsets[j] + s``;
    * ``nfeat`` (n cap + 1, d_n) / ``efeat`` (n e_cap + 1, d_e): the
      devices' feature rows restacked, zero dump rows last;
    * ``tcsr`` (device plan): ONE front pad of ``K * n_layers`` zero
      events, then each device's real events (its own pad dropped), ids
      and edge rows offset, ``bat`` as it was; ``indptr`` (n cap + 2,)
      gives union row ``j * cap + i`` device k's segment of node i, and
      the dump row an empty one. The devices' own pads are dropped, not
      offset: a node's segment ends where the next begins, so a pad
      between two devices would end the last node of the first;
    * ``parts`` n, ``ranks`` the devices, ``steps`` and the capacities
      as the plan's.
    """
    held = [int(k) for k in plan.held_ranks()]
    ranks = held if ranks is None else [int(k) for k in np.ravel(ranks)]
    if not set(ranks) <= set(held):
        raise ValueError(f"ranks {ranks}: the plan holds only {held}")
    row_of = {k: j for j, k in enumerate(held)}
    cap, e_cap = plan.capacity, plan.edge_capacity
    sharded = plan.layout == "sharded"

    def grid(key, k):
        v = plan.batches[key]
        if plan.host_replay:
            return v[row_of[k]]
        if sharded:
            return v[row_of[k], : plan.n_batches[k]]
        return v[plan.offsets[k]: plan.offsets[k] + plan.n_batches[k]]

    def shift(v, off):
        return np.where(v >= 0, v + off, v).astype(v.dtype)

    batches = {}
    for key in plan.batches:
        stride = (cap if key in _NODE_KEYS else
                  e_cap if key in _EDGE_KEYS else 0)
        batches[key] = np.concatenate([
            shift(grid(key, k), j * stride) if stride else grid(key, k)
            for j, k in enumerate(ranks)])
    n_batches = plan.n_batches[ranks]
    lengths = (np.full(len(ranks), plan.steps) if plan.host_replay
               else n_batches)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]
                             ).astype(np.int32)

    def restack(local, n):
        d = local.shape[-1]
        rows = [local[row_of[k], :n] for k in ranks]
        return np.concatenate(rows + [np.zeros((1, d), local.dtype)])

    out = {"batches": batches, "offsets": offsets, "n_batches": n_batches,
           "host_replay": plan.host_replay,
           "steps": plan.steps, "parts": len(ranks),
           "ranks": np.asarray(ranks, np.int64),
           "capacity": cap, "edge_capacity": e_cap,
           "nfeat": restack(plan.nfeat_local, cap),
           "efeat": restack(plan.efeat_local, e_cap), "tcsr": None}
    if plan.tcsr is not None:
        pad = cfg.num_neighbors * cfg.n_layers
        keys = [key for key in plan.tcsr if key != "indptr"]
        events = {key: [np.zeros(pad, plan.tcsr[key].dtype)]
                  for key in keys}
        rows, total = [], pad
        for j, k in enumerate(ranks):
            ptr = plan.tcsr["indptr"][row_of[k]]
            lo, hi = ptr[0], ptr[cap]                 # real events of k
            for key, parts in events.items():
                v = plan.tcsr[key]
                v = (v[row_of[k]] if sharded else v)[lo:hi]
                if key == "nbr":
                    v = v + np.int32(j * cap)
                elif key == "eidx":
                    v = v + np.int32(j * e_cap)
                parts.append(v)
            rows.append(ptr[:cap] - lo + np.int32(total))
            total += int(hi - lo)
        out["tcsr"] = {
            "indptr": np.concatenate(rows + [np.full(2, total, np.int32)]
                                     ).astype(np.int32),
            **{key: np.concatenate(parts) for key, parts in events.items()},
        }
    return out


def unstack_states(state: dict, parts: int, cap: int, b: int) -> dict:
    """A union state as the stacked per-device states of the JAX package:
    ``mem`` / ``mem2`` (P, cap + 1, d), ``last`` (P, cap + 1), and the
    pending rows (P, 2B, ...) in local ids (the union lays them out as
    every device's src rows, then every device's dst rows)."""
    n = parts * cap
    out = {}
    for key in ("mem", "mem2", "last"):
        x = state[key]
        rows = x[:n].reshape((parts, cap) + x.shape[1:])
        dump = x[n:].expand((parts, 1) + x.shape[1:]) if x.dim() > 1 else \
            x[n:].expand(parts, 1)
        out[key] = torch.cat([rows, dump], dim=1)

    def per_device(x):
        x = x.reshape((2, parts, b) + x.shape[1:]).transpose(0, 1)
        return x.reshape((parts, 2 * b) + x.shape[3:])

    ids = per_device(state["pend_ids"])
    base = (torch.arange(parts, device=ids.device, dtype=ids.dtype)
            * cap)[:, None]
    out["pend_ids"] = torch.where(ids < n, ids - base, cap).to(ids.dtype)
    out["pend_raw"] = per_device(state["pend_raw"])
    out["pend_t"] = per_device(state["pend_t"])
    return out


# ======================================================================
# the epoch program
# ======================================================================

def _union_rows(x: torch.Tensor) -> torch.Tensor:
    """The P devices' grid rows of one lockstep step, (P, B, ...), as the
    union's (P B, ...); the multi-layer host grids (P, L, B, K) as
    (L, P B, K), the layer axis first as ``step_loss`` takes it."""
    if x.dim() == 4:
        return x.transpose(0, 1).flatten(1, 2)
    return x.flatten(0, 1)


class _PACEpoch(engine._Epoch):
    """One PAC epoch over the union of P partitions: the tensors it owns
    (params, AdamW state, the union state and its Alg.2 backup, the flat
    grid, offsets and cycle lengths, feature tables, T-CSR, the step
    counter, (steps, P) losses) and its step. ``load`` copies an epoch's
    plan into them, so one captured graph serves every epoch of the same
    shapes.

    With a process ``group`` the union is this rank's block of the
    partitions, and each step averages the gradients over the group (one
    all-reduce, captured with the step on the card)."""

    def __init__(self, cfg: TIGConfig, opt: Optimizer, params, opt_state,
                 union: dict, device, group=None):
        self.cfg, self.opt, self.device = cfg, opt, device
        p, cap, b = union["parts"], union["capacity"], cfg.batch_size
        self.parts, self.cap, self.b = p, cap, b
        self.group = group
        self.steps = union["steps"]

        def own(x):
            return torch.as_tensor(x).detach().to(device, copy=True)

        self.params = tree_map(lambda x: own(x).requires_grad_(True), params)
        self.opt_state = tree_map(own, opt_state)
        ucfg = dataclasses.replace(cfg, batch_size=p * b)
        self.state = init_state(ucfg, p * cap, device)
        self.backup = init_state(ucfg, p * cap, device)
        self.batches = {k: own(v) for k, v in
                        engine._staged(union["batches"]).items()}
        self.offsets = own(union["offsets"])
        self.n_batches = own(union["n_batches"])
        self.host_replay = bool(union["host_replay"])
        self.tables = {k: own(union[k]) for k in ("nfeat", "efeat")}
        self.tcsr = None if union["tcsr"] is None else {
            k: own(v) for k, v in union["tcsr"].items()}
        engine.check_depth(self.tcsr, cfg)
        # the device of each union row (the dump row: P) and of each
        # pending row (src rows of every device, then dst rows)
        rows = torch.arange(p * cap + 1, device=device)
        self.node_dev = rows // max(cap, 1)
        self.pend_dev = (torch.arange(2 * p * b, device=device) % (p * b)
                         ) // b
        self.no = torch.zeros((1,), dtype=torch.bool, device=device)
        self.counter = torch.zeros((), dtype=torch.int32, device=device)
        self.out = {"loss": torch.zeros((self.steps, p), dtype=torch.float32,
                                        device=device)}
        self.graph = None
        self.per_replay: dict = {}

    @torch.no_grad()
    def load(self, params, opt_state, union: dict) -> None:
        """Copy a call's params, AdamW state and plan into the epoch's
        tensors; fresh state and backup; counter to 0."""
        for own, given in ((self.params, params),
                           (self.opt_state, opt_state)):
            for d, s in zip(tree_leaves(own), tree_leaves(given)):
                d.copy_(s)
        for k, v in engine._staged(union["batches"]).items():
            self.batches[k].copy_(v)
        self.offsets.copy_(torch.from_numpy(union["offsets"]))
        self.n_batches.copy_(torch.from_numpy(union["n_batches"]))
        for k, v in self.tables.items():
            v.copy_(torch.from_numpy(union[k]))
        for k, v in (self.tcsr or {}).items():
            v.copy_(torch.from_numpy(union["tcsr"][k]))
        everyone = torch.ones((self.parts + 1,), dtype=torch.bool,
                              device=self.device)
        for tree in (self.state, self.backup):
            self._fresh(tree, everyone)
        self.counter.zero_()

    def _fresh(self, tree: dict, devs: torch.Tensor) -> None:
        """Reset the rows of the devices marked in ``devs`` (P + 1: the
        last entry is the dump row) to ``init_state``'s values, in place."""
        rows = devs[self.node_dev]
        pend = devs[self.pend_dev]
        tree["mem"].masked_fill_(rows[:, None], 0.0)
        tree["mem2"].masked_fill_(rows[:, None], 0.0)
        tree["last"].masked_fill_(rows, 0.0)
        tree["pend_ids"].masked_fill_(pend, self.parts * self.cap)
        tree["pend_raw"].masked_fill_(pend[:, None], 0.0)
        tree["pend_t"].masked_fill_(pend, 0.0)

    def _objective(self, _loss, aux):
        """Each device's loss is its own batch mean (``step_loss``'s on
        its rows); the step descends their mean, whose gradient is the
        ``pmean`` of theirs. Every rank holds as many partitions, so the
        average of the ranks' gradients (``_reduce``) is the gradient of
        the mean over all of them."""
        p, b = self.parts, self.b
        v = aux["valid"].view(p, b).to(torch.float32)
        nv = v.sum(1).clamp(min=1.0)
        bce = (F.softplus(-aux["pos_logit"]) + F.softplus(aux["neg_logit"])
               ).view(p, b)
        per = (bce * v).sum(1) / (2.0 * nv)
        return per.mean(), per

    def _reduce(self, grads: list) -> list:
        """With a group, the gradients averaged over its ranks: one
        all-reduce of one flat buffer, not one a leaf. An average, not a
        sum of shares, so a rank's objective stays one card's (the mean
        of its partitions' losses) and a world of one, which divides by
        1, changes no bit. The eager warm-up steps before a capture run
        it first, so the communicator exists by then."""
        if self.group is None:
            return grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self.group)
        return [x.view(g.shape) for x, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def _batch_index(self, s):
        """Each device's batch index at lockstep step ``s`` (Alg.2's
        wrap-around, (P,) int32) and the flat grid row it reads (int64):
        ``offsets + at``, or from a host-replayed grid ``offsets + s``."""
        at = s % self.n_batches
        return at, (self.offsets + (s if self.host_replay else at)).long()

    def step(self) -> None:
        """Lockstep step ``counter`` of every device: Alg.2's reset of the
        devices starting a cycle, their rows of the flat grid, one sample
        with each row's own batch index, the loss and AdamW, and the
        backup of the devices ending a cycle."""
        s = self.counter
        at, rows = self._batch_index(s)
        with torch.no_grad():
            self._fresh(self.state, torch.cat([at == 0, self.no]))
        batch = {k: _union_rows(v.index_select(0, rows))
                 for k, v in self.batches.items()}
        if self.tcsr is not None:
            # one batch index a sampled row: (3 P B,), repeated for each
            # layer's window by the sampler
            batch_of = at[:, None].expand(self.parts, self.b).reshape(-1)
            batch = engine.sample_batch_neighbors(
                batch, self.tcsr, batch_of.repeat(3), self.cfg)
        state = self._aliases()
        losses, new = self._update(state, batch, self._objective)
        self.out["loss"].index_copy_(0, s.view(1).long(), losses[None])
        self._write_back(state, new)
        with torch.no_grad():
            end = torch.cat([(s + 1) % self.n_batches == 0, self.no])
            rows_end, pend_end = end[self.node_dev], end[self.pend_dev]
            for k, v in self.backup.items():
                mask = pend_end if k.startswith("pend") else rows_end
                mask = mask.view((-1,) + (1,) * (v.dim() - 1))
                v.copy_(torch.where(mask, self.state[k], v))
        engine._advance(s)

    def result(self, copy: bool):
        """``(params, opt_state, states, losses)``: the devices' backups
        unstacked to (P, cap + 1, ...) states, and (P, steps) losses."""
        def out(x):
            return x.detach().clone() if copy else x.detach()

        states = unstack_states({k: out(v) for k, v in self.backup.items()},
                                self.parts, self.cap, self.b)
        return (tree_map(out, self.params), tree_map(out, self.opt_state),
                states, out(self.out["loss"]).T.contiguous())


def _mesh_device(device, mesh):
    """The device an entry point runs on: the mesh's (a rank's card, or
    the CPU of a gloo group), else ``device``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device).type != \
            mesh.device.type:
        raise ValueError(f"device={device!r}, but this rank of the mesh "
                         f"runs on {mesh.device}")
    return mesh.device


def scan_pac_epoch(params, opt_state, union: dict, *, cfg: TIGConfig,
                   opt: Optimizer, device=None, mesh=None):
    """One PAC epoch over a ``union_plan``, as a plain loop of eager
    steps (the CPU's program, and on the card what the graphed one is
    held against). Returns ``(params, opt_state, states, losses)``:
    states stacked (P, cap + 1, ...) as the JAX package's vmap returns
    them (before the shared-node sync), losses (P, steps). With a
    ``mesh`` (``launch.mesh.make_tig_mesh``) the union is this rank's
    partitions and the gradients are averaged over the ranks."""
    device = _mesh_device(device, mesh)
    epoch = _PACEpoch(cfg, opt, params, opt_state, union, device,
                      None if mesh is None else mesh.group)
    epoch.run_eager()
    return epoch.result(copy=False)


def make_pac_epoch(cfg: TIGConfig, opt: Optimizer, *, device=None,
                   mesh=None, before_capture=None):
    """The PAC epoch program: ``(params, opt_state, union) -> (params,
    opt_state, states, losses)``, as ``scan_pac_epoch`` returns them.

    On the card (``device`` defaults to ``"cuda"``, or the mesh's card;
    raises without one) each shape of plan gets one captured step, kept
    with the program in ``.graphs`` (LRU, ``_GRAPHS_MAX``), and every
    epoch of that shape copies its plan into the captured epoch's tensors
    and replays it; on the CPU the program is ``scan_pac_epoch``. With a
    ``mesh`` each rank runs its own partitions' union, and the gradient
    all-reduce is part of the captured step. ``before_capture()``, when
    given, is called before a new shape's epoch is built and captured
    (``pac_train`` waits there for a sync still running on its side
    stream)."""
    device = _mesh_device(device, mesh)
    group = None if mesh is None else mesh.group
    if device.type != "cuda":
        def cpu_epoch(params, opt_state, union):
            return scan_pac_epoch(params, opt_state, union, cfg=cfg,
                                  opt=opt, device=device, mesh=mesh)
        return cpu_epoch
    graphs: dict = {}

    def pac_epoch(params, opt_state, union):
        key = (union["parts"], union["capacity"], union["steps"],
               union["host_replay"],
               engine._layout(params), engine._layout(opt_state),
               *((k, np.shape(union[k])) for k in (
                   "offsets", "nfeat", "efeat")),
               tuple((k, v.shape, v.dtype.str) for k, v in sorted(
                   union["batches"].items())),
               tuple((k, v.shape) for k, v in sorted(
                   (union["tcsr"] or {}).items())))
        def build():
            if before_capture is not None:
                before_capture()
            return _PACEpoch(cfg, opt, params, opt_state, union, device,
                             group)

        epoch = lru_get(graphs, key, _GRAPHS_MAX, build)
        epoch.load(params, opt_state, union)
        epoch.replay()
        return epoch.result(copy=True)

    pac_epoch.graphs = graphs
    return pac_epoch


# ======================================================================
# the epoch boundary
# ======================================================================

def _all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's (P_held, ...) block of ``x`` in rank order, (P, ...):
    the partitions in their global order (a rank holds a contiguous
    block), over the mesh's boundary group. Without a mesh, ``x``."""
    if mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.boundary)
    return torch.cat(parts)


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the ranks, in place, over the mesh's boundary
    group. Without a mesh, ``x``."""
    if mesh is not None:
        dist.all_reduce(x, group=mesh.boundary)
    return x


@torch.no_grad()
def sync_shared_memory(states: dict, shared_local, *,
                       sync_mode: Literal["latest", "mean"] = "latest",
                       mesh=None) -> dict:
    """Shared-node memory synchronization (paper §II-C) of stacked
    (P, cap + 1, ...) epoch-end states; returns new states.

    ``shared_local[k, j]`` is device k's row of shared node j. "latest":
    every device adopts the replica with the largest last-update time
    (the first device wins ties, as ``argmax`` does in the JAX package),
    and ``last`` becomes that time; "mean": the mean over devices of
    ``mem``, ``mem2`` and ``last``. As in the JAX package, "latest"
    gathers only the (P, S) times and adds the winners' rows by a
    winner-masked sum (exact: one value and zeros).

    With a ``mesh`` (``launch.mesh.make_tig_mesh``) ``states`` and
    ``shared_local`` are this rank's (P_held, ...) rows and the sync
    spans the ranks: the times are all-gathered into (P, S) in global
    partition order (so ties go to the lowest partition), and the masked
    or plain sums are all-reduced; every rank returns its own rows. The
    collectives run on the mesh's boundary group (``TIGMesh.boundary``),
    not on the group of the step's gradient all-reduce."""
    if sync_mode not in ("latest", "mean"):
        raise ValueError(f"sync_mode={sync_mode!r}")
    mem = states["mem"]
    shared = torch.as_tensor(shared_local, dtype=torch.int64,
                             device=mem.device)
    p, s = shared.shape
    held = np.arange(p) if mesh is None else local_part_ranks(mesh)
    total = p if mesh is None else mesh.num_parts
    if len(held) != p:
        raise ValueError(f"shared_local holds {p} partitions' rows; this "
                         f"rank holds {len(held)}")
    if s == 0:
        return dict(states)
    dev = torch.arange(p, device=mem.device)[:, None]
    rows_t = states["last"][dev, shared]                  # (P_held, S)
    if sync_mode == "latest":
        all_t = _all_gather(rows_t, mesh)                 # (P, S)
        win = all_t.argmax(0)                             # (S,)
        # a rank's partitions are contiguous: no host array to copy (a
        # copy from pageable memory would block the host on the stream)
        mine = win[None] == dev + int(held[0])            # (P_held, S)

        def pick(x):
            rows = x[dev, shared]
            m = mine.view(mine.shape + (1,) * (rows.dim() - 2))
            return _all_reduce((rows * m.to(rows.dtype)).sum(0), mesh)

        new_t = all_t.max(0).values
    else:
        def pick(x):
            return _all_reduce(x[dev, shared].sum(0), mesh) / total

        new_t = pick(states["last"])
    out = dict(states)
    for key, new in (("mem", pick(states["mem"])),
                     ("mem2", pick(states["mem2"])), ("last", new_t)):
        x = states[key].clone()
        x[dev, shared] = new
        out[key] = x
    return out


def make_pac_sync(*, sync_mode: Literal["latest", "mean"] = "latest",
                  mesh=None):
    """The standalone shared-node sync, ``(states, shared_local) ->
    states`` over stacked (P, ...) inputs (with a ``TIGMesh``, this
    rank's (P_held, ...) rows, over the mesh's collectives):
    ``sync_shared_memory`` with its mode and mesh bound, the math the
    epoch boundary runs. The JAX package jits a vmap (or a shard_map over the mesh);
    here the stacked partitions are already a batch dimension."""
    if sync_mode not in ("latest", "mean"):
        raise ValueError(f"sync_mode={sync_mode!r}")
    return functools.partial(sync_shared_memory, sync_mode=sync_mode,
                             mesh=mesh)


def globalize_memory(states: dict, plan: EpochPlan, num_nodes: int,
                     cfg: TIGConfig, *, time_rescale: float = 1.0,
                     device=None) -> dict:
    """Merge stacked (P, ...) post-sync memories into one global-row
    state for the evaluation protocol, on ``device``: each device
    contributes its real local rows (local id = rank in its sorted node
    list); a node hosted by several devices takes the replica with the
    largest last-update time (the first host wins ties). ``time_rescale``
    converts the plan-scale ``last`` into the consumer's units. Pending
    messages are not carried over."""
    device = resolve_device(device)
    host = {k: states[k].detach().cpu().numpy()
            for k in ("mem", "mem2", "last")}
    d = host["mem"].shape[-1]
    mem = np.zeros((num_nodes + 1, d), np.float32)
    mem2 = np.zeros((num_nodes + 1, d), np.float32)
    last = np.zeros((num_nodes + 1,), np.float32)
    written = np.zeros(num_nodes + 1, dtype=bool)
    for k, nodes in enumerate(plan.node_lists):
        nodes = np.sort(np.asarray(nodes, np.int64))
        n = len(nodes)
        m, m2 = host["mem"][k][:n], host["mem2"][k][:n]
        lt = host["last"][k][:n] * np.float32(time_rescale)
        take = (~written[nodes]) | (lt > last[nodes])
        tgt = nodes[take]
        mem[tgt], mem2[tgt], last[tgt] = m[take], m2[take], lt[take]
        written[tgt] = True
    out = init_state(cfg, num_nodes, device)
    out.update({k: torch.from_numpy(v).to(device)
                for k, v in (("mem", mem), ("mem2", mem2), ("last", last))})
    return out


# ======================================================================
# the training driver
# ======================================================================

def stage_replicated_tree(tree, mesh):
    """Every leaf of ``tree`` on this rank's device with rank 0's value
    (``stream.stage_replicated``): the params and AdamW state at the start
    of a PAC run over a mesh."""
    return tree_map(lambda x: stage_replicated(x, mesh), tree)


@functools.cache
def _sync_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream of the overlapped epoch boundary on ``device``, made
    once. Not ``engine._side_stream`` (the captures' warm-up stream), and
    never one a call: each stream a library runs on may keep its own
    workspace for the life of the process."""
    return torch.cuda.Stream(device)


class _Boundary:
    """Where ``pac_train``'s epoch boundary runs. Serial, or on the CPU:
    inline, in program order. Overlapped on the card: on the device's
    sync stream (``_sync_stream``), which first waits for everything
    issued so far on the main stream, so the sync of epoch e runs beside
    epoch e+1's steps; its losses stay where they are until ``drain``
    reads them after the loop."""

    def __init__(self, device: torch.device, overlap: bool):
        self.device, self.overlap = device, overlap
        self.side = _sync_stream(device) if (
            overlap and device.type == "cuda") else None
        self.pending = None          # the event of the last sync

    def run(self, fn, reads: list):
        """``fn()`` at the boundary. On the sync stream ``reads`` (the main
        stream's tensors it reads) are marked used there, so the main
        stream's allocator does not hand them out before it is done."""
        if self.side is None:
            return fn()
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        for t in reads:
            t.record_stream(self.side)
        with torch.cuda.stream(self.side):
            out = fn()
        self.pending = torch.cuda.Event()
        self.pending.record(self.side)
        return out

    def to_host(self, x: torch.Tensor):
        """``x`` on its way to the host: serial, a numpy array now;
        overlapped, the tensor, left for ``drain`` (a read now would wait
        for the sync)."""
        return x.cpu().numpy() if not self.overlap else x

    def quiesce(self) -> None:
        """Wait on the host until the last sync is done: nothing may run on
        the sync stream while the main stream captures a new step."""
        if self.pending is not None:
            self.pending.synchronize()

    def join(self, tensors) -> None:
        """Make the main stream wait for the boundary before it reads
        ``tensors`` (made on the sync stream), and mark them used there."""
        if self.side is None:
            return
        main = torch.cuda.current_stream(self.device)
        main.wait_stream(self.side)
        for t in tensors:
            t.record_stream(main)

    def drain(self, losses: list) -> list:
        """The per-epoch losses as numpy arrays, once the last sync is
        done."""
        self.quiesce()
        return [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                for x in losses]


@dataclasses.dataclass
class PACResult:
    params: dict
    memory_states: dict           # stacked (N_dev, ...) post-sync states
    losses: list                  # per epoch: (N_dev, steps_e) arrays
    derived_speedup: float
    edges_per_device: np.ndarray
    plan: EpochPlan
    metrics: Optional[dict] = None   # run_protocol output (eval_graph given)
    epoch_seconds: list = dataclasses.field(default_factory=list)
    plan_seconds: list = dataclasses.field(default_factory=list)

    def mean_loss_per_epoch(self) -> np.ndarray:
        return np.array([float(l.mean()) for l in self.losses])


def pac_train(
    g_train: StreamSource,
    partition: PartitionResult,
    cfg: TIGConfig,
    *,
    num_devices: int,
    epochs: int = 3,
    lr: float = 1e-3,
    seed: int = 0,
    shuffle_parts: bool = True,
    sync_mode: Literal["latest", "mean"] = "latest",
    prefetch: bool = True,
    depth: int = 1,
    epoch_boundary: Literal["overlap", "serial"] = "overlap",
    plan: str = "device",
    host_replay: bool = False,
    eval_graph: Optional[StreamSource] = None,
    eval_warm: Literal["memory", "replay", "restart"] = "memory",
    eval_node_class: bool = False,
    params: Optional[dict] = None,
    device=None,
    mesh=None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
    faults: Optional[FaultInjector] = None,
) -> PACResult:
    """Train a TIG model with SEP partitions and PAC (the paper's
    pipeline) on one card: each epoch plans on the host (shuffle-combine
    when the partition has more parts than devices, ``plan_epoch``,
    ``union_plan``), runs the ``make_pac_epoch`` program and the
    shared-node sync. The same generators as the JAX package's
    ``pac_train``, so with ``params`` converted from its
    ``init_params(PRNGKey(seed), cfg)`` both compute the same thing;
    by default params are drawn from a ``torch.Generator`` seeded with
    ``seed``.

    ``g_train`` is the train split, an in-memory ``TemporalGraph`` or an
    out-of-core ``ShardedStream`` (localized shard by shard; the same
    plans). With ``prefetch`` (the default) epoch e+1's plan is built on
    an ``EpochPrefetcher`` worker while epoch e replays (``depth`` plans
    ahead; per-epoch generators keep it bitwise equal to serial
    planning).

    ``epoch_boundary="overlap"`` (the default, as in the JAX package)
    makes the boundary asynchronous: on the card the shared-node sync of
    epoch e and the loss gather run on a side stream of their own
    (``_sync_stream``) beside epoch e+1's steps, the shared rows staged
    through one pinned buffer (``stream.RowStager``), and the losses stay
    on the card until they are read after the loop; on the CPU
    it is the same arithmetic in the same order, with the loss reads
    deferred. ``"serial"`` syncs and reads each epoch's losses before the
    next begins: the oracle, which ``"overlap"`` equals bit for bit.
    ``epoch_seconds[e]`` is the wall time from epoch e's wait for its
    plan to epoch e+1's (the last: to the end of the loop, the losses
    collected), so the list sums to the loop's wall time in both modes;
    under ``"serial"`` an entry holds its whole device epoch and sync,
    overlapped the sync of epoch e may finish inside entry e+1.
    ``plan_seconds`` is the wait for each plan (all of the planning
    without prefetch).

    ``host_replay=True`` (the parity oracle of the wrap-around; it
    implies ``plan="host"`` and the replicated layout, also over a mesh)
    reads each lockstep step from grids replayed on the host
    (``plan_epoch(host_replay=True)``) through the same graphed step: the
    same bits as the default.

    ``eval_graph`` (the full stream of which ``g_train`` is the train
    split, a ``TemporalGraph`` or a ``ShardedStream``) scores val and
    test through ``protocol.run_protocol`` into ``PACResult.metrics``,
    from PAC's synchronized memories merged to global rows
    (``eval_warm="memory"``; ``train_ap`` NaN), from a replay of the
    train split (``"replay"``) or from TIGER's restarter, fitted on an
    embedding bank of the train split (``"restart"``,
    ``restart.build_restarter``; ``train_ap`` NaN; with ``ckpt_dir`` the
    restarter is also saved there as ``restarter.npz``, so a relaunch can
    warm memory without a replay); ``eval_node_class`` adds the node
    classification AUROC.

    ``mesh`` (``launch.mesh.make_tig_mesh``, over ``torch.distributed``)
    runs the P = ``num_devices`` partitions over its ranks, one card (or
    CPU process of a gloo group) a rank, each rank on its contiguous
    block of partitions. Every rank calls ``pac_train`` with the same
    arguments: each plans only its own partitions' rows
    (``plan_epoch(local_ranks=...)`` with the sharded layout) and runs
    their union step; the gradients are all-reduced every lockstep step
    and the shared-node sync crosses the ranks. After the loop the states
    and losses are all-gathered, so every rank holds the (P, ...) result
    and runs the scoring itself. A mesh plans the sharded layout, no
    mesh the replicated one; the two give the same union, so the same
    result (the JAX package's ``grid_layout`` is not an option here).
    The boundary's collectives (the sync, the loss and state gathers) run
    on the mesh's boundary group (``TIGMesh.boundary``), not on the group
    of the step's captured all-reduce.

    Fault tolerance: ``ckpt_dir`` + ``ckpt_every=k`` saves ``{params,
    opt_state, states}`` (the post-sync states, (P, cap + 1, ...)) every
    k epochs in the JAX package's checkpoint format, crash-atomic, with
    ``metadata={"epoch": ep}`` (over a mesh every rank joins the states'
    gather and rank 0 writes). ``resume=True`` restores params and AdamW
    state from the newest complete step and continues at the next epoch:
    bitwise an uninterrupted run, since each epoch's plan generator and
    its fresh memory depend on ``(seed, ep)`` alone. With nothing left to
    train (``epochs=0``, or a resume past the last epoch) the result
    holds the plan of epoch 0, fresh memories and no losses. ``faults``
    (default: ``FaultInjector.from_env()``, ``$REPRO_FAULTS``) fires
    ``prefetch_worker`` in the plan build, ``host_kill`` at the top of
    each epoch, ``staging_oom`` where an epoch's plan is staged (just
    before its program) and ``sync_fail`` before the sync. Over several
    ranks an exception that ``faults.is_host_loss`` classifies as a lost
    peer is raised as ``faults.HostLossError``.
    """
    if mesh is not None and num_devices != mesh.num_parts:
        raise ValueError(f"num_devices={num_devices}, but the mesh has "
                         f"{mesh.num_parts} partition slots")
    if epoch_boundary not in ("overlap", "serial"):
        raise ValueError(f"epoch_boundary={epoch_boundary!r}: expected "
                         "'overlap' or 'serial'")
    if eval_warm not in ("memory", "replay", "restart"):
        raise ValueError(f"eval_warm={eval_warm!r}: expected 'memory', "
                         "'replay' or 'restart'")
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    if host_replay:
        plan = "host"
    if resume and not ckpt_dir:
        raise ValueError("resume=True needs ckpt_dir")
    injector = faults if faults is not None else FaultInjector.from_env()
    device = _mesh_device(device, mesh)
    # a rank plans only its own partitions' rows (the host replay: every
    # partition's, in the replicated layout)
    held = None if mesh is None else local_part_ranks(mesh)
    layout = "replicated" if mesh is None or host_replay else "sharded"
    multirank = mesh is not None and mesh.world > 1
    writer = mesh is None or mesh.rank == 0
    small_parts = partition.node_lists()
    if isinstance(g_train, ShardedStream):
        time_scale = time_scale_of(g_train.column("t"))
    else:
        time_scale = time_scale_of(g_train.t)
    params = _initial_params(params, cfg, seed, device)
    opt = adamw(lr=lr, max_grad_norm=1.0)
    opt_state = opt.init(params)
    if mesh is not None:
        params = stage_replicated_tree(params, mesh)
        opt_state = stage_replicated_tree(opt_state, mesh)
    boundary = _Boundary(device, epoch_boundary == "overlap")
    stager = RowStager(device)       # the shared rows, an epoch at a time
    program = make_pac_epoch(cfg, opt, device=device, mesh=mesh,
                             before_capture=boundary.quiesce)

    def build(ep: int) -> tuple:
        injector.fire("prefetch_worker", epoch=ep)
        rng_ep = epoch_rng(seed, ep, 11)
        if shuffle_parts and len(small_parts) > num_devices:
            node_lists = shuffle_combine(small_parts, num_devices, rng_ep)
        elif len(small_parts) == num_devices:
            node_lists = small_parts
        else:
            node_lists = shuffle_combine(
                small_parts, num_devices, np.random.default_rng(seed))
        ep_plan = plan_epoch(g_train, node_lists, partition.shared_nodes,
                             cfg, rng_ep, time_scale=time_scale, plan=plan,
                             host_replay=host_replay, layout=layout,
                             local_ranks=None if host_replay else held)
        return ep_plan, union_plan(ep_plan, cfg, held)

    def gathered(states: dict) -> dict:
        # every rank holds the (P, ...) states, as the JAX package's
        # replicating gather gives every process
        return {k: _all_gather(v, mesh) for k, v in states.items()}

    start_epoch = 0
    if resume:
        step = latest_step(ckpt_dir)
        if step is not None:
            fresh = {"params": params, "opt_state": opt_state}
            # in the fresh trees' dtypes (a captured step's tensors keep
            # theirs: load copies into them)
            restored = tree_map(lambda new, old: new.to(old.dtype),
                                restore_checkpoint(ckpt_dir, step, fresh),
                                fresh)
            params, opt_state = restored["params"], restored["opt_state"]
            if mesh is not None:
                params = stage_replicated_tree(params, mesh)
                opt_state = stage_replicated_tree(opt_state, mesh)
            start_epoch = step + 1
            print(f"PAC_RESUME: step {step} restored from {ckpt_dir}, "
                  f"continuing at epoch {start_epoch}", flush=True)

    all_losses, marks, plan_secs = [], [], []
    last_plan, states = None, None
    try:
        with EpochPrefetcher(build, epochs, enabled=prefetch,
                             depth=depth) as pf:
            for ep in range(start_epoch, epochs):
                injector.fire("host_kill", epoch=ep)
                marks.append(time.perf_counter())
                ep_plan, union = pf.get(ep)
                plan_secs.append(time.perf_counter() - marks[-1])
                injector.fire("staging_oom")
                params, opt_state, raw, losses = program(params, opt_state,
                                                         union)
                injector.fire("sync_fail", epoch=ep)
                shared = ep_plan.shared_local[union["ranks"]]

                def sync():
                    rows = (stager(shared) if mesh is None else
                            stage_partitioned(shared, mesh, num_devices,
                                              stager))
                    out = sync_shared_memory(raw, rows, sync_mode=sync_mode,
                                             mesh=mesh)
                    return out, boundary.to_host(_all_gather(losses, mesh))

                states, host_losses = boundary.run(
                    sync, list(raw.values()) + [losses])
                all_losses.append(host_losses)
                last_plan = ep_plan
                if ckpt_dir and ckpt_every and (ep + 1) % ckpt_every == 0:
                    boundary.join(states.values())
                    snap = {"params": params, "opt_state": opt_state,
                            "states": gathered(states)}
                    if writer:
                        save_checkpoint(ckpt_dir, ep, snap,
                                        metadata={"epoch": ep})
        all_losses = boundary.drain(all_losses)
        marks.append(time.perf_counter())
        if last_plan is None:
            # nothing trained (epochs=0, or a resume past the end): the
            # plan of the epoch that would have run, fresh memories
            last_plan = build(0)[0]
            states = {k: v.expand((num_devices,) + v.shape).clone()
                      for k, v in init_state(cfg, last_plan.capacity,
                                             device).items()}
        else:
            boundary.join(states.values())
            states = gathered(states)
    except Exception as exc:
        if multirank and is_host_loss(exc):
            raise HostLossError(
                f"peer lost during PAC training: {exc}") from exc
        raise

    metrics = None
    if eval_graph is not None:
        splits = split_views(eval_graph)
        if isinstance(eval_graph, ShardedStream):
            tables = stage_device_tables(eval_graph, device=device)
        else:
            tables = {k: torch.from_numpy(v).to(device)
                      for k, v in make_tables(eval_graph.edge_feat,
                                              eval_graph.node_feat).items()}
        warm = {"warm": "replay"}
        if eval_warm == "memory":
            warm = {"warm": "state", "state": globalize_memory(
                states, last_plan, splits.num_nodes, cfg,
                time_rescale=time_scale / splits.time_scale, device=device)}
        elif eval_warm == "restart":
            rst, _ = build_restarter(params, cfg, splits, tables, seed=seed,
                                     device=device)
            if ckpt_dir and writer:
                os.makedirs(ckpt_dir, exist_ok=True)
                save_restarter(os.path.join(ckpt_dir, "restarter.npz"), rst)
            warm = {"warm": "restart", "restarter": rst}
        metrics = run_protocol(params, cfg, splits, tables, seed=seed,
                               eval_node_class=eval_node_class,
                               prefetch=prefetch, depth=depth,
                               device=device, **warm)
        engine.release(tables)

    return PACResult(
        params=params,
        memory_states=states,
        losses=all_losses,
        derived_speedup=derived_speedup(last_plan.edges_per_device),
        edges_per_device=last_plan.edges_per_device,
        plan=last_plan,
        metrics=metrics,
        epoch_seconds=np.diff(marks).tolist(),
        plan_seconds=plan_secs,
    )
