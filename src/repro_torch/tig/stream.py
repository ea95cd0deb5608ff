"""The chunked data plane, as ``repro/tig/stream.py``: out-of-core shards,
a JODIE CSV block reader, chunked staging of the edge-feature table on the
device, and the epoch prefetcher.

  * a memory-mapped **shard format** for edge streams (below), the same
    bytes as the JAX package's: a directory one package writes, the other
    opens;
  * a **pandas-free block reader** for JODIE/TGN CSVs that ingests a file
    one block at a time (``write_jodie_shards``);
  * **chunked device staging** of the per-edge feature table
    (``stage_device_tables``): the table is allocated on the device once
    and each shard's rows are copied into their slice, so the host holds
    one shard's features at a time;
  * an **EpochPrefetcher** that builds epoch e+1's host plan on a worker
    thread while epoch e runs on the device. The worker builds numpy plans
    only; the main thread stages them (see the class).

Shard format (``tig-shards-v1``)
--------------------------------
A shard directory holds one chronological edge stream split into
row ranges::

    <dir>/meta.json             format tag + sizes (see below)
    <dir>/shard_00000.src.npy   int64   (e_s,)   source node ids
    <dir>/shard_00000.dst.npy   int64   (e_s,)   destination node ids
    <dir>/shard_00000.t.npy     float64 (e_s,)   non-decreasing timestamps
    <dir>/shard_00000.label.npy int64   (e_s,)   dynamic labels (optional)
    <dir>/shard_00000.efeat.npy float32 (e_s, d_e) edge features
    <dir>/node_feat.npy         float32 (N, d_n) node features (optional;
                                absent means all zeros, the paper's default)

``meta.json`` keys: ``format`` ("tig-shards-v1"), ``name``, ``num_nodes``,
``num_edges``, ``num_shards``, ``shard_edges`` (per-shard row counts),
``dim_edge``, ``dim_node``, ``has_labels``. Every array is a plain
``.npy`` read with ``np.load(..., mmap_mode="r")``: opening a stream reads
only ``meta.json``. Shards are row ranges of ONE chronological order, so
shard boundaries carry no meaning and any re-chunking is valid
(``ChronoNeighborIndex.from_chunks`` relies on it).

Staging over a mesh of ranks (``launch.mesh.make_tig_mesh``):
``stage_partitioned`` puts this rank's rows of a partitioned array on its
device, ``stage_replicated`` rank 0's value on every rank's.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.tig.graph import TemporalGraph

__all__ = [
    "SHARD_FORMAT",
    "DEFAULT_SHARD_EDGES",
    "ShardedStream",
    "write_graph_shards",
    "write_jodie_shards",
    "iter_jodie_blocks",
    "stage_device_tables",
    "stage_partitioned",
    "stage_replicated",
    "EpochPrefetcher",
]

SHARD_FORMAT = "tig-shards-v1"
DEFAULT_SHARD_EDGES = 262_144


# ======================================================================
# shard container
# ======================================================================

@dataclasses.dataclass
class ShardedStream:
    """A memory-mapped ``tig-shards-v1`` directory (see module docstring)."""

    path: str
    meta: dict

    @classmethod
    def open(cls, path: str) -> "ShardedStream":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != SHARD_FORMAT:
            raise ValueError(
                f"{path}: not a {SHARD_FORMAT} directory "
                f"(format={meta.get('format')!r})")
        return cls(path=path, meta=meta)

    @property
    def num_edges(self) -> int:
        return int(self.meta["num_edges"])

    @property
    def num_nodes(self) -> int:
        return int(self.meta["num_nodes"])

    @property
    def num_shards(self) -> int:
        return int(self.meta["num_shards"])

    @property
    def shard_edges(self) -> list[int]:
        return list(self.meta["shard_edges"])

    @property
    def dim_edge(self) -> int:
        return int(self.meta["dim_edge"])

    @property
    def dim_node(self) -> int:
        return int(self.meta["dim_node"])

    @property
    def has_labels(self) -> bool:
        return bool(self.meta["has_labels"])

    @property
    def name(self) -> str:
        return str(self.meta.get("name", os.path.basename(self.path)))

    def _file(self, s: int, field: str) -> str:
        return os.path.join(self.path, f"shard_{s:05d}.{field}.npy")

    def shard_offsets(self) -> np.ndarray:
        """(S+1,) global edge offset of each shard boundary."""
        return np.concatenate(
            [[0], np.cumsum(self.shard_edges)]).astype(np.int64)

    def load(self, s: int, field: str, *, mmap: bool = True) -> np.ndarray:
        """One column of one shard; ``mmap=True`` returns a read-only map."""
        return np.load(self._file(s, field),
                       mmap_mode="r" if mmap else None)

    def edge_chunks(self, *, features: bool = False) -> Iterator[tuple]:
        """Yield (src, dst, t, eidx) per shard, id columns materialized a
        shard at a time; ``eidx`` is the global edge index of each row.
        With ``features=True`` each tuple also carries the shard's
        (e_s, d_e) float32 edge-feature rows, one shard at a time."""
        offsets = self.shard_offsets()
        for s in range(self.num_shards):
            src = np.asarray(self.load(s, "src"))
            dst = np.asarray(self.load(s, "dst"))
            t = np.asarray(self.load(s, "t"))
            eidx = np.arange(offsets[s], offsets[s + 1], dtype=np.int64)
            if features:
                efeat = np.asarray(self.load(s, "efeat"), dtype=np.float32)
                yield src, dst, t, eidx, efeat
            else:
                yield src, dst, t, eidx

    def column(self, field: str) -> np.ndarray:
        """One id / time / label column across all shards, as a new array
        (8 bytes an edge; the feature table is what stays on disk)."""
        return np.concatenate(
            [np.asarray(self.load(s, field)) for s in range(self.num_shards)])

    def node_feat(self, *, mmap: bool = True) -> np.ndarray:
        f = os.path.join(self.path, "node_feat.npy")
        if os.path.exists(f):
            return np.load(f, mmap_mode="r" if mmap else None)
        return np.zeros((self.num_nodes, self.dim_node), dtype=np.float32)

    def as_graph(self) -> TemporalGraph:
        """Materialize the whole stream (tests and small datasets)."""
        efeat = np.concatenate(
            [np.asarray(self.load(s, "efeat"))
             for s in range(self.num_shards)])
        return TemporalGraph(
            src=self.column("src"),
            dst=self.column("dst"),
            t=self.column("t"),
            edge_feat=efeat,
            node_feat=np.asarray(self.node_feat(mmap=False)),
            labels=self.column("label") if self.has_labels else None,
            name=self.name,
        )


def _write_meta(out_dir: str, *, name: str, num_nodes: int,
                shard_edges: list[int], dim_edge: int, dim_node: int,
                has_labels: bool) -> ShardedStream:
    meta = {
        "format": SHARD_FORMAT,
        "name": name,
        "num_nodes": int(num_nodes),
        "num_edges": int(sum(shard_edges)),
        "num_shards": len(shard_edges),
        "shard_edges": [int(e) for e in shard_edges],
        "dim_edge": int(dim_edge),
        "dim_node": int(dim_node),
        "has_labels": bool(has_labels),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return ShardedStream(path=out_dir, meta=meta)


def _save_shard(out_dir: str, s: int, src, dst, t, efeat, label) -> None:
    np.save(os.path.join(out_dir, f"shard_{s:05d}.src.npy"),
            np.asarray(src, np.int64))
    np.save(os.path.join(out_dir, f"shard_{s:05d}.dst.npy"),
            np.asarray(dst, np.int64))
    np.save(os.path.join(out_dir, f"shard_{s:05d}.t.npy"),
            np.asarray(t, np.float64))
    np.save(os.path.join(out_dir, f"shard_{s:05d}.efeat.npy"),
            np.asarray(efeat, np.float32))
    if label is not None:
        np.save(os.path.join(out_dir, f"shard_{s:05d}.label.npy"),
                np.asarray(label, np.int64))


def write_graph_shards(g: TemporalGraph, out_dir: str, *,
                       shard_edges: int = DEFAULT_SHARD_EDGES
                       ) -> ShardedStream:
    """Shard an in-memory ``TemporalGraph`` (synthetic presets, tests)."""
    os.makedirs(out_dir, exist_ok=True)
    sizes = []
    for s, lo in enumerate(range(0, max(g.num_edges, 1), shard_edges)):
        hi = min(lo + shard_edges, g.num_edges)
        _save_shard(
            out_dir, s, g.src[lo:hi], g.dst[lo:hi], g.t[lo:hi],
            g.edge_feat[lo:hi],
            None if g.labels is None else g.labels[lo:hi])
        sizes.append(hi - lo)
    if not np.allclose(g.node_feat, 0.0):
        np.save(os.path.join(out_dir, "node_feat.npy"),
                g.node_feat.astype(np.float32))
    return _write_meta(
        out_dir, name=g.name, num_nodes=g.num_nodes, shard_edges=sizes,
        dim_edge=g.dim_edge, dim_node=g.dim_node,
        has_labels=g.labels is not None)


# ======================================================================
# JODIE CSV block reader (pandas-free, out-of-core)
# ======================================================================

def _sniff_columns(path: str, probe_rows: int = 1000) -> tuple[int, bool]:
    """(feature column count, whether a label column exists), from the
    widest of the first data rows, never the header (JODIE exports
    sometimes declare feature names the rows do not carry, and the other
    way round)."""
    cols = 0
    with open(path) as f:
        f.readline()  # header
        for _ in range(probe_rows):
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            cols = max(cols, len(line.split(",")))
    return max(cols - 4, 0), cols >= 4


def _sniff_feat_width(path: str, probe_rows: int = 1000) -> int:
    return _sniff_columns(path, probe_rows)[0]


def _parse_jodie_rows(lines: Sequence[str], n_feat: int):
    """Parse CSV data rows one by one: ragged feature columns are
    zero-padded or truncated to ``n_feat``, missing labels default to 0,
    integer and float timestamps both accepted, blank lines skipped.
    Returns (users, items, t, labels, feats) numpy columns."""
    users, items, ts, labels = [], [], [], []
    feats = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        parts = line.split(",")
        if len(parts) < 3:
            raise ValueError(f"unparseable JODIE row: {line!r}")
        users.append(int(float(parts[0])))
        items.append(int(float(parts[1])))
        ts.append(float(parts[2]))
        labels.append(int(float(parts[3]))
                      if len(parts) > 3 and parts[3].strip() else 0)
        row = [float(x) if x.strip() else 0.0 for x in parts[4:4 + n_feat]]
        if len(row) < n_feat:
            row.extend([0.0] * (n_feat - len(row)))
        feats.append(row)
    return (
        np.asarray(users, np.int64),
        np.asarray(items, np.int64),
        np.asarray(ts, np.float64),
        np.asarray(labels, np.int64),
        np.asarray(feats, np.float32).reshape(len(users), n_feat),
    )


def _parse_jodie_rows_fast(lines: Sequence[str], n_feat: int):
    """Parse a well-formed block (every row the same width, no empty
    field) in one pass of numpy's C tokenizer (``np.loadtxt``). Returns
    None for a ragged or irregular block, which the caller then parses
    with ``_parse_jodie_rows``; on the blocks it accepts both parsers give
    the same columns."""
    try:
        a = np.loadtxt(io.StringIO("".join(lines)), delimiter=",",
                       comments=None, ndmin=2, dtype=np.float64)
    except ValueError:
        return None
    if a.size == 0 or a.shape[1] < 3:
        return None                       # the fallback raises the error
    w = a.shape[1]
    # nan / inf in the integer columns (ids, label) would cast to
    # INT64_MIN silently; the fallback raises the proper error
    if not np.isfinite(a[:, :2]).all() or \
            (w > 3 and not np.isfinite(a[:, 3]).all()):
        return None
    n = len(a)
    feats = a[:, 4:4 + n_feat].astype(np.float32)
    if feats.shape[1] < n_feat:
        feats = np.concatenate(
            [feats, np.zeros((n, n_feat - feats.shape[1]), np.float32)],
            axis=1)
    return (
        a[:, 0].astype(np.int64),
        a[:, 1].astype(np.int64),
        a[:, 2],
        a[:, 3].astype(np.int64) if w > 3 else np.zeros(n, np.int64),
        feats.reshape(n, n_feat),
    )


def iter_jodie_blocks(path: str, *, block_rows: int = DEFAULT_SHARD_EDGES,
                      n_feat: Optional[int] = None, fast: bool = True
                      ) -> Iterator[tuple]:
    """Stream a JODIE ``ml_<name>.csv`` as (users, items, t, labels,
    feats) blocks of ``block_rows`` rows; the whole file is never in
    memory. With ``fast`` (the default) a well-formed block is parsed in
    one numpy pass and a ragged one row by row (the same columns either
    way); ``fast=False`` parses every block row by row."""
    if n_feat is None:
        n_feat = _sniff_feat_width(path)
    with open(path) as f:
        f.readline()  # header
        while True:
            lines = []
            for _ in range(block_rows):
                line = f.readline()
                if not line:
                    break
                lines.append(line)
            if not lines:
                return
            block = _parse_jodie_rows_fast(lines, n_feat) if fast else None
            if block is None:
                block = _parse_jodie_rows(lines, n_feat)
            if len(block[0]):
                yield block


def write_jodie_shards(csv_path: str, out_dir: str, *,
                       shard_edges: int = DEFAULT_SHARD_EDGES,
                       d_n: int = 172, name: Optional[str] = None
                       ) -> ShardedStream:
    """A JODIE CSV as ``tig-shards-v1``, in one pass that writes a shard
    at a time. Item ids are stored raw during the pass and moved after the
    user ids (the bipartite convention) by a fix-up pass once the user
    count is known. The stream must already be sorted in time (JODIE
    exports are); out-of-order rows raise."""
    os.makedirs(out_dir, exist_ok=True)
    n_feat, has_labels = _sniff_columns(csv_path)
    sizes: list[int] = []
    max_user = -1
    max_item = -1
    last_t = -np.inf
    s = 0
    for users, items, t, labels, feats in iter_jodie_blocks(
            csv_path, block_rows=shard_edges, n_feat=n_feat):
        if len(t) and (t[0] < last_t or np.any(np.diff(t) < 0)):
            raise ValueError(
                f"{csv_path}: timestamps are not non-decreasing; "
                "sort the export before sharding")
        last_t = float(t[-1])
        max_user = max(max_user, int(users.max()))
        max_item = max(max_item, int(items.max()))
        if feats.shape[1] == 0:
            feats = np.zeros((len(users), 1), dtype=np.float32)
        _save_shard(out_dir, s, users, items, t, feats,
                    labels if has_labels else None)
        sizes.append(len(users))
        s += 1
    if not sizes:
        raise ValueError(f"{csv_path}: no data rows")
    nu = max_user + 1          # fix-up: dst = num_users + item, a shard
    for k in range(s):         # at a time
        f = os.path.join(out_dir, f"shard_{k:05d}.dst.npy")
        arr = np.load(f)
        np.save(f, arr + nu)
    return _write_meta(
        out_dir, name=name or os.path.basename(csv_path),
        num_nodes=nu + max_item + 1, shard_edges=sizes,
        dim_edge=max(n_feat, 1), dim_node=d_n,
        # a 3-column export (user, item, t) has no labels to classify
        has_labels=has_labels)


# ======================================================================
# chunked device staging
# ======================================================================

def stage_device_tables(shards: ShardedStream, *, device=None) -> dict:
    """The feature tables of ``batching.make_tables`` on ``device`` (default
    ``"cuda"``; raises without a card), built without a host copy of the
    whole stream.

    The (E+1, d_e) float32 edge table is allocated on the device once and
    each shard's rows are copied into their slice; the zero dump row comes
    last. A shard is first copied from its read-only memory map into one
    host buffer (a shard's rows), so the host holds one shard at a time.
    Node features are zeros unless the stream has ``node_feat.npy``,
    which is staged the same way in row chunks.
    """
    device = resolve_device(device)
    sizes = shards.shard_edges

    def staged(rows: int, dim: int, chunks) -> torch.Tensor:
        table = torch.zeros((rows + 1, dim), dtype=torch.float32,
                            device=device)
        buf = None
        lo = 0
        for chunk in chunks:
            n = len(chunk)
            if buf is None or len(buf) < n:
                buf = np.empty((n, dim), np.float32)
            buf[:n] = chunk
            table[lo: lo + n].copy_(torch.from_numpy(buf[:n]))
            lo += n
        return table

    efeat = staged(shards.num_edges, shards.dim_edge,
                   (shards.load(s, "efeat") for s in range(len(sizes))))
    n = shards.num_nodes
    nf_path = os.path.join(shards.path, "node_feat.npy")
    chunks = ()
    if os.path.exists(nf_path):
        nf = np.load(nf_path, mmap_mode="r")
        step = max(1, DEFAULT_SHARD_EDGES // max(shards.dim_node, 1))
        chunks = (nf[lo: lo + step] for lo in range(0, n, step))
    return {"efeat": efeat, "nfeat": staged(n, shards.dim_node, chunks)}


# ======================================================================
# staging over a mesh of ranks
# ======================================================================

def stage_partitioned(local_rows: np.ndarray, mesh,
                      n_global: int) -> torch.Tensor:
    """This rank's rows of an (n_global, ...) array partitioned over the
    mesh's partition slots, on the rank's device. A rank owns its rows by
    construction (it planned them: ``plan_epoch(local_ranks=...)``), so
    no rank ever holds another's; the JAX package stitches the global
    array from each process's rows here."""
    if n_global != mesh.num_parts:
        raise ValueError(f"n_global={n_global}, but the mesh has "
                         f"{mesh.num_parts} partition slots")
    rows = np.ascontiguousarray(local_rows)
    if len(rows) != len(mesh.ranks):
        raise ValueError(f"{len(rows)} rows given; this rank holds "
                         f"partitions {mesh.ranks.tolist()}")
    return torch.from_numpy(rows).to(mesh.device)


def stage_replicated(x, mesh) -> torch.Tensor:
    """``x`` on this rank's device with rank 0's value (a broadcast over
    the mesh's group): every rank starts from the same tensor."""
    t = torch.as_tensor(x).detach().to(mesh.device, copy=True).contiguous()
    dist.broadcast(t, src=0, group=mesh.group)
    return t


# ======================================================================
# epoch prefetch
# ======================================================================

_STOP = object()     # worker shutdown sentinel


class EpochPrefetcher:
    """Host planning of up to ``depth`` epochs ahead of the consumer, on
    ONE persistent worker thread.

    ``build_fn(epoch)`` calls run in submission order on the single worker
    (stateful planning RNGs see the serial call sequence), so results are
    bitwise those of inline planning at any ``depth``.

    The worker builds host (numpy) plans only and makes no CUDA call; the
    consumer stages a plan on the main thread (the epoch programs of
    ``engine`` copy it into their own tensors in ``load``). The JAX
    package also moves the plan to the device on the worker; here that
    would break the captures: on the card an epoch program captures its
    step as a CUDA graph on the main thread while the worker plans the
    next epoch, and any CUDA call from another thread during a capture in
    the default (global) mode, be it an allocation, a pinned buffer or a
    copy, fails the capture; a copy on the worker would also race the
    program's ``load``. ``build_fn`` must keep to that.

        with EpochPrefetcher(build, epochs, depth=2) as pf:
            for ep in range(epochs):
                plan = pf.get(ep)   # plan e ready; e+1, e+2 in flight
                ... stage it and run the device epoch ...

    ``get(e)`` returns plan e and refills the pipeline to ``depth`` epochs
    in flight. An exception in the worker surfaces at the corresponding
    ``get`` and cancels the pipeline (no further epoch is submitted).
    ``depth=0``, or ``enabled=False``, builds inline without a thread.
    As a context manager it closes the pipeline on any exit, so the
    worker is joined rather than left behind a failure.
    """

    def __init__(self, build_fn: Callable[[int], object], num_epochs: int,
                 *, enabled: bool = True, depth: int = 1):
        if depth < 0:
            raise ValueError(f"depth={depth}: expected >= 0")
        self._build = build_fn
        self._n = num_epochs
        self._depth = depth if enabled else 0
        self._inbox: queue.Queue = queue.Queue()
        self._futures: dict[int, queue.Queue] = {}
        self._worker: Optional[threading.Thread] = None

    def _worker_loop(self) -> None:
        while True:
            job = self._inbox.get()
            if job is _STOP:
                return
            epoch, out = job
            try:
                out.put((True, self._build(epoch)))
            except BaseException as exc:  # noqa: BLE001 — reraised at get()
                out.put((False, exc))

    def _submit(self, epoch: int) -> None:
        if epoch < 0 or epoch >= self._n or epoch in self._futures:
            return
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True)
            self._worker.start()
        out: queue.Queue = queue.Queue(maxsize=1)
        self._futures[epoch] = out
        self._inbox.put((epoch, out))

    def _cancel(self) -> None:
        """Drop every submission not yet claimed: no further build starts
        (a build the worker already began completes into a dropped
        queue)."""
        self._n = 0
        self._futures.clear()
        while True:
            try:
                self._inbox.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Stop the pipeline: pending submissions are dropped and the
        worker is joined once it finishes the build it has begun. Plans in
        flight are dropped (an early stop or an exception no longer needs
        them)."""
        self._cancel()
        worker, self._worker = self._worker, None
        if worker is not None:
            self._inbox.put(_STOP)
            worker.join()

    def __enter__(self) -> "EpochPrefetcher":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def get(self, epoch: int):
        """The plan of ``epoch`` (built inline when the pipeline is
        disabled); refills the pipeline to ``depth`` epochs in flight."""
        if self._depth == 0:
            return self._build(epoch)
        self._submit(epoch)
        out = self._futures.pop(epoch)
        ok, plan = out.get()
        if not ok:
            self._cancel()      # the pipeline is poisoned past this epoch
            raise plan
        for nxt in range(epoch + 1, epoch + 1 + self._depth):
            self._submit(nxt)
        return plan
