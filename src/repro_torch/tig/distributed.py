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
materialized), the replicated flat layout, ``plan="host"`` and
``"device"``, ``n_layers`` > 1, node classification and the restarter
warm-up of the scoring. Not ported yet (they raise): the
``host_replay`` oracle, ``layout="sharded"`` / ``local_ranks``, a mesh of
several cards, the overlapped epoch boundary, checkpoints and ``resume``,
and faults.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Literal, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pac import (build_subgraph, cycle_schedule,
                                  derived_speedup, make_local_indices,
                                  shuffle_combine, subgraph_mask)
from repro_torch.core.sep import PartitionResult
from repro_torch.device import resolve_device
from repro_torch.optim import Optimizer, adamw
from repro_torch.tig import engine
from repro_torch.tig.batching import (LocalStream, build_batch_program,
                                      concat_batch_programs, make_tables)
from repro_torch.tig.cache import lru_get
from repro_torch.tig.graph import TemporalGraph
from repro_torch.tig.models import TIGConfig, init_state
from repro_torch.tig.protocol import run_protocol, split_views, time_scale_of
from repro_torch.tig.restart import build_restarter
from repro_torch.tig.sampler import ChronoNeighborIndex
from repro_torch.tig.stream import (EpochPrefetcher, ShardedStream,
                                    stage_device_tables)
from repro_torch.tig.train import _initial_params, epoch_rng
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["EpochPlan", "plan_epoch", "union_plan", "unstack_states",
           "scan_pac_epoch", "make_pac_epoch", "sync_shared_memory",
           "globalize_memory", "PACResult", "pac_train"]

_GRAPHS_MAX = 4          # captured PAC epochs a program keeps (LRU)
StreamSource = Union[TemporalGraph, ShardedStream]


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported to repro_torch yet")


# ======================================================================
# host-side epoch planning
# ======================================================================

@dataclasses.dataclass
class EpochPlan:
    """Everything one PAC epoch needs, in the replicated flat layout.

    ``batches`` is a flat (sum_k n_batches_k, ...) dict of numpy arrays —
    each device's real batch grid, concatenated, in its LOCAL ids — and
    ``offsets`` holds each device's start row; device k reads row
    ``offsets[k] + s % n_batches[k]`` at lockstep step s (Alg.2
    wrap-around). A device plan's ``tcsr`` holds an (N_dev, cap+1)
    ``indptr``, each row offset by its device's base in the flat event
    arrays ``nbr`` / ``t`` / ``eidx`` / ``bat`` (the per-device
    ``device_export``s concatenated, each with its front pad).
    """

    batches: dict                 # flat (sum real, ...)
    n_batches: np.ndarray         # (N_dev,) real batches per device
    nfeat_local: np.ndarray       # (N_dev, cap+1, d_n)
    efeat_local: np.ndarray       # (N_dev, e_cap+1, d_e)
    shared_local: np.ndarray      # (N_dev, S) local rows of shared nodes
    node_lists: list[np.ndarray]  # global ids per device
    capacity: int                 # padded local node count
    edge_capacity: int            # padded local edge count
    steps: int
    edges_per_device: np.ndarray  # (N_dev,)
    offsets: np.ndarray           # (N_dev,) flat-grid start rows
    tcsr: Optional[dict] = None   # device plan only

    def plan_bytes(self) -> int:
        """Host bytes of the batch grids and (device plan) the T-CSR."""
        arrays = list(self.batches.values()) + list((self.tcsr or {})
                                                     .values())
        return int(sum(np.asarray(v).nbytes for v in arrays))


def _localize_in_memory(g: TemporalGraph, node_lists: list[np.ndarray],
                        local, cap: int, time_scale: float):
    """Per-device localized streams and feature gathers from an in-memory
    ``TemporalGraph``; edge ids are LOCAL, into each device's own feature
    table."""
    n_dev = len(node_lists)
    streams: list[LocalStream] = []
    edges_per_device = np.zeros(n_dev, dtype=np.int64)
    edge_globals: list[np.ndarray] = []
    for k, (nodes, li) in enumerate(zip(node_lists, local)):
        eidx = build_subgraph(g.src, g.dst, nodes, g.num_nodes)
        edges_per_device[k] = len(eidx)
        edge_globals.append(eidx)
        streams.append(LocalStream(
            src=li.to_local[g.src[eidx]].astype(np.int64),
            dst=li.to_local[g.dst[eidx]].astype(np.int64),
            t=g.t[eidx] / time_scale,
            eidx=np.arange(len(eidx), dtype=np.int64),
            num_local_nodes=cap,
            labels=None if g.labels is None else g.labels[eidx],
        ))

    nfeat_local = np.zeros((n_dev, cap + 1, g.dim_node), np.float32)
    for k, li in enumerate(local):
        nfeat_local[k, : li.num_real] = g.node_feat[li.globals_[: li.num_real]]

    e_cap = int(edges_per_device.max()) if n_dev else 0
    efeat_local = np.zeros((n_dev, e_cap + 1, g.dim_edge), np.float32)
    for k, eg in enumerate(edge_globals):
        efeat_local[k, : len(eg)] = g.edge_feat[eg]
    return streams, edges_per_device, nfeat_local, efeat_local


def _localize_sharded(shards: ShardedStream, node_lists: list[np.ndarray],
                      local, cap: int, cfg: TIGConfig, time_scale: float):
    """Per-device localized streams, their T-CSRs and feature gathers
    straight from ``tig-shards-v1`` row-range chunks; the graph is never
    materialized. One pass over ``edge_chunks(features=True)`` classifies
    each shard's edges against every device's membership, localizes their
    ids and gathers their feature rows, so the host holds one shard plus
    the devices' own streams and rows. Each device's index is built by
    ``ChronoNeighborIndex.from_chunks`` over its pieces (the one-shot
    build's arrays); edge ids are LOCAL, into its own feature table."""
    n_dev = len(node_lists)
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
            pieces[k].append((
                li.to_local[src[keep]].astype(np.int64),
                li.to_local[dst[keep]].astype(np.int64),
                np.asarray(t, np.float64)[keep] / time_scale,
                eidx_local,
            ))
            feat_parts[k].append(efeat[keep])

    streams: list[LocalStream] = []
    indexes: list[Optional[ChronoNeighborIndex]] = []
    edges_per_device = cursors.copy()
    e_cap = int(edges_per_device.max()) if n_dev else 0
    efeat_local = np.zeros((n_dev, e_cap + 1, shards.dim_edge), np.float32)
    for k in range(n_dev):
        chunks = pieces[k]

        def cat(i, chunks=chunks):
            return (np.concatenate([c[i] for c in chunks]) if chunks
                    else np.zeros(0, np.int64 if i != 2 else np.float64))

        streams.append(LocalStream(
            src=cat(0), dst=cat(1), t=cat(2), eidx=cat(3),
            num_local_nodes=cap, labels=None))
        # an edge-less device is one padding batch, which the one-shot
        # build handles (from_chunks would count 0 batches)
        indexes.append(ChronoNeighborIndex.from_chunks(
            chunks, cap, cfg.num_neighbors, cfg.batch_size)
            if chunks else None)
        if feat_parts[k]:
            efeat_local[k, : edges_per_device[k]] = \
                np.concatenate(feat_parts[k])
        # the device's stream and index own new arrays: free the pieces
        feat_parts[k] = []
        pieces[k] = []

    nfeat_local = np.zeros((n_dev, cap + 1, shards.dim_node), np.float32)
    nfeat = shards.node_feat()          # memory-mapped (or zeros)
    for k, li in enumerate(local):
        real_ids = li.globals_[: li.num_real]
        nfeat_local[k, : li.num_real] = np.asarray(nfeat[real_ids],
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
    """
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    if host_replay:
        raise _not_ported("host_replay (the host-replayed oracle)")
    if layout != "replicated":
        raise _not_ported(f"layout={layout!r}")
    if local_ranks is not None:
        raise _not_ported("local_ranks")
    if not isinstance(source, (TemporalGraph, ShardedStream)):
        raise _not_ported(f"a {type(source).__name__} source")
    n_dev = len(node_lists)
    local = make_local_indices(node_lists, source.num_nodes)
    cap = local[0].capacity if local else 0
    seeds = rng.integers(0, 2**63, size=n_dev) if n_dev else []
    if isinstance(source, ShardedStream):
        if time_scale is None:
            time_scale = time_scale_of(source.column("t"))
        streams, indexes, edges_per_device, nfeat_local, efeat_local = \
            _localize_sharded(source, node_lists, local, cap, cfg,
                              time_scale)
    else:
        time_scale = time_scale or time_scale_of(source.t)
        streams, edges_per_device, nfeat_local, efeat_local = \
            _localize_in_memory(source, node_lists, local, cap, time_scale)
        indexes = [None] * n_dev

    sched = cycle_schedule(edges_per_device, cfg.batch_size)
    steps = steps_override or sched.steps_per_epoch

    programs, exports = [], []
    for k, stream in enumerate(streams):
        idx = indexes[k]
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
    real_batches = np.asarray(sched.batches, dtype=np.int64)
    for k, prog in enumerate(programs):
        if len(prog["src"]) != real_batches[k]:
            raise AssertionError((k, len(prog["src"]), real_batches[k]))
    n_batches = np.minimum(real_batches, steps).astype(np.int32)

    tcsr = None
    if plan == "device":
        lens = [len(e["nbr"]) for e in exports]
        bases = np.cumsum([0] + lens)[:-1]
        tcsr = {
            "indptr": np.stack([e["indptr"] + np.int32(b)
                                for e, b in zip(exports, bases)]),
            **{key: np.concatenate([e[key] for e in exports])
               for key in ("nbr", "t", "eidx", "bat")},
        }

    trimmed = [{kk: v[: n_batches[k]] for kk, v in p.items()}
               for k, p in enumerate(programs)]
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
        tcsr=tcsr,
    )


# ======================================================================
# the disjoint union of the partitions
# ======================================================================

_NODE_KEYS = ("src", "dst", "neg", "nbr_src", "nbr_dst", "nbr_neg")
_EDGE_KEYS = ("eidx", "nbre_src", "nbre_dst", "nbre_neg")


def union_plan(plan: EpochPlan, cfg: TIGConfig) -> dict:
    """The epoch plan over the disjoint union of the partitions, as numpy
    arrays: device k's local node i is row ``k * cap + i``, its local
    edge j row ``k * e_cap + j``, and every local dump row the union's
    one dump row (``P * cap`` / ``P * e_cap``).

    * ``batches``: the flat grid with its node and edge ids offset by
      their row's device (-1 stays -1); ``offsets`` / ``n_batches`` as
      the plan's;
    * ``nfeat`` (P cap + 1, d_n) / ``efeat`` (P e_cap + 1, d_e): the
      devices' feature rows restacked, zero dump rows last;
    * ``tcsr`` (device plan): ONE front pad of ``K * n_layers`` zero
      events, then each device's real events (its own pad dropped), ids
      and edge rows offset, ``bat`` as it was; ``indptr`` (P cap + 2,)
      gives union row ``k * cap + i`` device k's segment of node i, and
      the dump row an empty one. The devices' own pads are dropped, not
      offset: a node's segment ends where the next begins, so a pad
      between two devices would end the last node of the first.
    """
    p, cap, e_cap = len(plan.n_batches), plan.capacity, plan.edge_capacity
    dev_of_row = np.repeat(np.arange(p), plan.n_batches)

    def shift(v, stride):
        off = (dev_of_row * stride).reshape((-1,) + (1,) * (v.ndim - 1))
        return np.where(v >= 0, v + off, v).astype(v.dtype)

    batches = {}
    for key, v in plan.batches.items():
        if key in _NODE_KEYS:
            batches[key] = shift(v, cap)
        elif key in _EDGE_KEYS:
            batches[key] = shift(v, e_cap)
        else:
            batches[key] = v

    def restack(local, n):
        d = local.shape[-1]
        return np.concatenate([local[:, :n].reshape(p * n, d),
                               np.zeros((1, d), local.dtype)])

    out = {"batches": batches, "offsets": plan.offsets,
           "n_batches": plan.n_batches, "steps": plan.steps, "parts": p,
           "capacity": cap, "edge_capacity": e_cap,
           "nfeat": restack(plan.nfeat_local, cap),
           "efeat": restack(plan.efeat_local, e_cap), "tcsr": None}
    if plan.tcsr is not None:
        pad = cfg.num_neighbors * cfg.n_layers
        indptr = plan.tcsr["indptr"]
        lo, hi = indptr[:, 0], indptr[:, cap]          # real events of k
        events = {key: [np.zeros(pad, v.dtype)]
                  for key, v in plan.tcsr.items() if key != "indptr"}
        for k in range(p):
            for key, parts in events.items():
                v = plan.tcsr[key][lo[k]: hi[k]]
                if key == "nbr":
                    v = v + np.int32(k * cap)
                elif key == "eidx":
                    v = v + np.int32(k * e_cap)
                parts.append(v)
        total = pad + int((hi - lo).sum())
        rows = [indptr[k, :cap] - np.int32(k * pad) for k in range(p)]
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
    shapes."""

    def __init__(self, cfg: TIGConfig, opt: Optimizer, params, opt_state,
                 union: dict, device):
        self.cfg, self.opt, self.device = cfg, opt, device
        p, cap, b = union["parts"], union["capacity"], cfg.batch_size
        self.parts, self.cap, self.b = p, cap, b
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
        ``pmean`` of theirs."""
        p, b = self.parts, self.b
        v = aux["valid"].view(p, b).to(torch.float32)
        nv = v.sum(1).clamp(min=1.0)
        bce = (F.softplus(-aux["pos_logit"]) + F.softplus(aux["neg_logit"])
               ).view(p, b)
        per = (bce * v).sum(1) / (2.0 * nv)
        return per.mean(), per

    def _batch_index(self, s):
        """Each device's batch index at lockstep step ``s`` (Alg.2's
        wrap-around, (P,) int32) and the flat grid row it reads (int64)."""
        at = s % self.n_batches
        return at, (self.offsets + at).long()

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


def scan_pac_epoch(params, opt_state, union: dict, *, cfg: TIGConfig,
                   opt: Optimizer, device=None):
    """One PAC epoch over a ``union_plan``, as a plain loop of eager
    steps (the CPU's program, and on the card what the graphed one is
    held against). Returns ``(params, opt_state, states, losses)``:
    states stacked (P, cap + 1, ...) as the JAX package's vmap returns
    them (before the shared-node sync), losses (P, steps)."""
    device = resolve_device(device)
    epoch = _PACEpoch(cfg, opt, params, opt_state, union, device)
    epoch.run_eager()
    return epoch.result(copy=False)


def make_pac_epoch(cfg: TIGConfig, opt: Optimizer, *, device=None):
    """The PAC epoch program: ``(params, opt_state, union) -> (params,
    opt_state, states, losses)``, as ``scan_pac_epoch`` returns them.

    On the card (``device`` defaults to ``"cuda"``; raises without one)
    each shape of plan gets one captured step, kept with the program in
    ``.graphs`` (LRU, ``_GRAPHS_MAX``), and every epoch of that shape
    copies its plan into the captured epoch's tensors and replays it; on
    the CPU the program is ``scan_pac_epoch``."""
    device = resolve_device(device)
    if device.type != "cuda":
        def cpu_epoch(params, opt_state, union):
            return scan_pac_epoch(params, opt_state, union, cfg=cfg,
                                  opt=opt, device=device)
        return cpu_epoch
    graphs: dict = {}

    def pac_epoch(params, opt_state, union):
        key = (union["parts"], union["capacity"], union["steps"],
               engine._layout(params), engine._layout(opt_state),
               *((k, np.shape(union[k])) for k in (
                   "offsets", "nfeat", "efeat")),
               tuple((k, v.shape, v.dtype.str) for k, v in sorted(
                   union["batches"].items())),
               tuple((k, v.shape) for k, v in sorted(
                   (union["tcsr"] or {}).items())))
        epoch = lru_get(graphs, key, _GRAPHS_MAX, lambda: _PACEpoch(
            cfg, opt, params, opt_state, union, device))
        epoch.load(params, opt_state, union)
        epoch.replay()
        return epoch.result(copy=True)

    pac_epoch.graphs = graphs
    return pac_epoch


# ======================================================================
# the epoch boundary
# ======================================================================

@torch.no_grad()
def sync_shared_memory(states: dict, shared_local, *,
                       sync_mode: Literal["latest", "mean"] = "latest"
                       ) -> dict:
    """Shared-node memory synchronization (paper §II-C) of stacked
    (P, cap + 1, ...) epoch-end states; returns new states.

    ``shared_local[k, j]`` is device k's row of shared node j. "latest":
    every device adopts the replica with the largest last-update time
    (the first device wins ties, as ``argmax`` does in the JAX package's
    winner-masked ``psum``), and ``last`` becomes that time; "mean": the
    mean over devices of ``mem``, ``mem2`` and ``last``."""
    if sync_mode not in ("latest", "mean"):
        raise ValueError(f"sync_mode={sync_mode!r}")
    mem = states["mem"]
    shared = torch.as_tensor(np.asarray(shared_local), dtype=torch.int64,
                             device=mem.device)
    p, s = shared.shape
    if s == 0:
        return dict(states)
    dev = torch.arange(p, device=mem.device)[:, None]
    rows_t = states["last"][dev, shared]                  # (P, S)
    if sync_mode == "latest":
        win = rows_t.argmax(0)                            # (S,)
        cols = torch.arange(s, device=mem.device)

        def pick(x):
            return x[dev, shared][win, cols]

        new_t = rows_t.max(0).values
    else:
        def pick(x):
            return x[dev, shared].sum(0) / p

        new_t = rows_t.sum(0) / p
    out = dict(states)
    for key, new in (("mem", pick(states["mem"])),
                     ("mem2", pick(states["mem2"])), ("last", new_t)):
        x = states[key].clone()
        x[dev, shared] = new
        out[key] = x
    return out


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
    epoch_boundary: Literal["overlap", "serial"] = "serial",
    plan: str = "device",
    eval_graph: Optional[StreamSource] = None,
    eval_warm: Literal["memory", "replay", "restart"] = "memory",
    eval_node_class: bool = False,
    params: Optional[dict] = None,
    device=None,
    mesh=None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    faults=None,
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

    ``eval_graph`` (the full stream of which ``g_train`` is the train
    split, a ``TemporalGraph`` or a ``ShardedStream``) scores val and
    test through ``protocol.run_protocol`` into ``PACResult.metrics``,
    from PAC's synchronized memories merged to global rows
    (``eval_warm="memory"``; ``train_ap`` NaN), from a replay of the
    train split (``"replay"``) or from TIGER's restarter, fitted on an
    embedding bank of the train split (``"restart"``,
    ``restart.build_restarter``; ``train_ap`` NaN); ``eval_node_class``
    adds the node classification AUROC. ``epoch_seconds`` covers the wait
    for the plan,
    the device epoch and the sync, synchronized; ``plan_seconds`` is the
    wait (all of the planning without prefetch).

    A ``mesh``, ``epoch_boundary="overlap"`` (the JAX package's default;
    its ``"serial"`` oracle is what runs here), checkpoints (``ckpt_dir``
    / ``resume``; so the restarter bundle is not saved) and ``faults``
    are not ported yet and raise.
    """
    if mesh is not None:
        raise _not_ported("PAC over a mesh of several cards")
    if epoch_boundary != "serial":
        raise _not_ported(f"epoch_boundary={epoch_boundary!r}")
    if eval_warm not in ("memory", "replay", "restart"):
        raise ValueError(f"eval_warm={eval_warm!r}: expected 'memory', "
                         "'replay' or 'restart'")
    if ckpt_dir is not None or resume:
        raise _not_ported("checkpointing (ckpt_dir / resume)")
    if faults is not None:
        raise _not_ported("fault injection")
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    device = resolve_device(device)
    small_parts = partition.node_lists()
    if isinstance(g_train, ShardedStream):
        time_scale = time_scale_of(g_train.column("t"))
    else:
        time_scale = time_scale_of(g_train.t)
    params = _initial_params(params, cfg, seed, device)
    opt = adamw(lr=lr, max_grad_norm=1.0)
    opt_state = opt.init(params)
    program = make_pac_epoch(cfg, opt, device=device)

    def build(ep: int) -> tuple:
        rng_ep = epoch_rng(seed, ep, 11)
        if shuffle_parts and len(small_parts) > num_devices:
            node_lists = shuffle_combine(small_parts, num_devices, rng_ep)
        elif len(small_parts) == num_devices:
            node_lists = small_parts
        else:
            node_lists = shuffle_combine(
                small_parts, num_devices, np.random.default_rng(seed))
        ep_plan = plan_epoch(g_train, node_lists, partition.shared_nodes,
                             cfg, rng_ep, time_scale=time_scale, plan=plan)
        return ep_plan, union_plan(ep_plan, cfg)

    all_losses, epoch_secs, plan_secs = [], [], []
    last_plan, states = None, None
    with EpochPrefetcher(build, epochs, enabled=prefetch, depth=depth) as pf:
        for ep in range(epochs):
            t0 = time.perf_counter()
            ep_plan, union = pf.get(ep)
            plan_secs.append(time.perf_counter() - t0)
            params, opt_state, states, losses = program(params, opt_state,
                                                        union)
            states = sync_shared_memory(states, ep_plan.shared_local,
                                        sync_mode=sync_mode)
            all_losses.append(losses.cpu().numpy())
            epoch_secs.append(time.perf_counter() - t0)
            last_plan = ep_plan
    if last_plan is None:
        raise ValueError("epochs must be >= 1")

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
        epoch_seconds=epoch_secs,
        plan_seconds=plan_secs,
    )
