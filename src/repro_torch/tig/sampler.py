"""Host-side temporal neighbor index (T-CSR), copied from
``repro/tig/sampler.py`` so both packages build the same index.

``ChronoNeighborIndex`` is built ONCE per stream with ``np.lexsort``: all
2E endpoint events are sorted by (node, chronological rank) so each node
owns one contiguous, time-sorted segment. Sampling the K most recent
neighbors *as of* any batch boundary is then ``searchsorted`` + slicing.
``from_chunks`` builds the same arrays from a stream in chunks (an
out-of-core ``ShardedStream``) without concatenating it.
``device_export`` stages the index for the device sampler; a
``NeighborSnapshot`` carries the index state after a stream into a later
one (val/test continuation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence, Union

import numpy as np

__all__ = ["NeighborSnapshot", "ChronoNeighborIndex"]

Chunk = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _aligned_chunks(chunks: Iterable[Chunk], align: int) -> Iterable[Chunk]:
    """Re-chunk a (src, dst, t, eidx) stream so every boundary but the
    final tail is a multiple of ``align``: no batch straddles two chunks.
    A leftover is carried into the next input chunk."""
    buf: Chunk | None = None
    for chunk in chunks:
        if buf is not None:
            chunk = tuple(np.concatenate([b, c])
                          for b, c in zip(buf, chunk))  # type: ignore
            buf = None
        n = len(chunk[0])
        keep = (n // align) * align
        if keep:
            yield tuple(c[:keep] for c in chunk)  # type: ignore
        if keep < n:
            buf = tuple(np.asarray(c[keep:]) for c in chunk)  # type: ignore
    if buf is not None and len(buf[0]):
        yield buf


@dataclasses.dataclass
class NeighborSnapshot:
    """Per-node K most recent neighbors after a stream was consumed: rows
    ordered oldest -> newest with empty slots as -1 at the FRONT."""

    nbr: np.ndarray    # (N, K) int64, -1 for empty
    time: np.ndarray   # (N, K) float64, -1.0 for empty
    eidx: np.ndarray   # (N, K) int64, -1 for empty

    @property
    def num_nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def k(self) -> int:
        return self.nbr.shape[1]


class ChronoNeighborIndex:
    """Vectorized chronological neighbor index over a full edge stream.

    Endpoint events are ranked batch by batch, and within a batch by a
    stable sort on event time (equal-time src-side events precede dst-side
    events). Events are then sorted by (node, rank) into per-node
    contiguous segments (T-CSR). ``sample`` with a per-row batch index
    returns, for each queried node, its K most recent events among
    {history} ∪ {stream events in earlier batches}.
    """

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        t: np.ndarray,
        eidx: np.ndarray,
        num_nodes: int,
        k: int,
        batch_size: int,
        history: NeighborSnapshot | None = None,
    ):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        t = np.asarray(t, np.float64)
        eidx = np.asarray(eidx, np.int64)
        n_edges = len(src)
        self.num_nodes = num_nodes
        self.k = k
        self.batch_size = batch_size
        self.num_batches = max(1, -(-n_edges // batch_size)) if n_edges else 0

        edge_i = np.arange(n_edges, dtype=np.int64)
        batch_of = edge_i // batch_size
        # 2E endpoint events: src-side (side 0) then dst-side (side 1)
        ev_node = np.concatenate([src, dst])
        ev_other = np.concatenate([dst, src])
        ev_t = np.concatenate([t, t])
        ev_e = np.concatenate([eidx, eidx])
        ev_batch = np.concatenate([batch_of, batch_of])
        ev_side = np.concatenate([np.zeros(n_edges, np.int64),
                                  np.ones(n_edges, np.int64)])
        ev_edge = np.concatenate([edge_i, edge_i])

        if history is not None:
            if history.num_nodes != num_nodes or history.k < 1:
                raise ValueError("history does not match this index")
            live = history.nbr >= 0                       # (N, Kh)
            h_node, h_slot = np.nonzero(live)
            ev_node = np.concatenate([h_node, ev_node])
            ev_other = np.concatenate([history.nbr[live], ev_other])
            ev_t = np.concatenate([history.time[live], ev_t])
            ev_e = np.concatenate([history.eidx[live], ev_e])
            # history strictly precedes the stream: batch -1, slot order
            nh = len(h_node)
            ev_batch = np.concatenate([np.full(nh, -1, np.int64), ev_batch])
            ev_side = np.concatenate([np.zeros(nh, np.int64), ev_side])
            ev_edge = np.concatenate([h_slot.astype(np.int64), ev_edge])

        # sort by (node, batch, time, side, edge index)
        order = np.lexsort((ev_edge, ev_side, ev_t, ev_batch, ev_node))
        self._nbr = ev_other[order]
        self._t = ev_t[order]
        self._e = ev_e[order]
        node_s = ev_node[order]
        batch_s = ev_batch[order]
        counts = np.bincount(node_s, minlength=num_nodes)
        self._indptr = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts)])
        # combined (node, batch) key for "events before batch b" prefix
        # queries; +1 shifts history's batch -1 to 0.
        self._nb = self.num_batches + 1
        self._bkey = node_s * self._nb + (batch_s + 1)

    @classmethod
    def from_chunks(
        cls,
        chunks: Union[Sequence[Chunk], Callable[[], Iterable[Chunk]]],
        num_nodes: int,
        k: int,
        batch_size: int,
        history: NeighborSnapshot | None = None,
    ) -> "ChronoNeighborIndex":
        """Out-of-core T-CSR build over (src, dst, t, eidx) chunks.

        A two-pass counting sort whose arrays are IDENTICAL to the
        one-shot constructor's, without concatenating the stream: pass 1
        counts each node's events (``_indptr``), pass 2 sorts each chunk
        with the one-shot key and places it at per-node write cursors.
        Chunks are re-aligned to ``batch_size`` first, so no batch
        straddles two; per node the key (batch, t, side, edge) then
        increases across chunks, and chunk-local sorts placed in order
        equal the global sort.

        ``chunks``: a sequence of tuples, or a zero-argument callable that
        returns a fresh iterator for each pass (e.g. over a
        ``ShardedStream``'s memory maps); a one-shot iterator is made a
        list (both passes must see every chunk). ``eidx`` is each row's
        feature row; the stream position is counted here.
        """
        if callable(chunks):
            get_iter = chunks
        else:
            if not isinstance(chunks, (list, tuple)):
                # pass 1 would exhaust a generator and leave pass 2
                # nothing to place
                chunks = list(chunks)
            get_iter = lambda: iter(chunks)  # noqa: E731

        obj = cls.__new__(cls)
        obj.num_nodes = num_nodes
        obj.k = k
        obj.batch_size = batch_size

        # pass 1: per-node event counts (each edge hits both endpoints)
        counts = np.zeros(num_nodes, dtype=np.int64)
        n_edges = 0
        for src, dst, _t, _e in get_iter():
            n_edges += len(src)
            counts += np.bincount(np.asarray(src, np.int64),
                                  minlength=num_nodes)
            counts += np.bincount(np.asarray(dst, np.int64),
                                  minlength=num_nodes)
        obj.num_batches = max(1, -(-n_edges // batch_size)) if n_edges else 0
        obj._nb = obj.num_batches + 1

        nh = 0
        if history is not None:
            if history.num_nodes != num_nodes or history.k < 1:
                raise ValueError("history does not match this index")
            live = history.nbr >= 0
            h_node, h_slot = np.nonzero(live)
            counts += np.bincount(h_node, minlength=num_nodes)
            nh = len(h_node)

        total = 2 * n_edges + nh
        obj._indptr = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts)])
        obj._nbr = np.empty(total, np.int64)
        obj._t = np.empty(total, np.float64)
        obj._e = np.empty(total, np.int64)
        obj._bkey = np.empty(total, np.int64)
        cursor = obj._indptr[:-1].copy()

        def place(node_s, other_s, t_s, e_s, batch_s):
            """Scatter node-sorted events at each node's write cursor."""
            m = len(node_s)
            if m == 0:
                return
            idx = np.arange(m, dtype=np.int64)
            starts = np.concatenate(
                [[0], np.flatnonzero(np.diff(node_s)) + 1])
            runlen = np.diff(np.concatenate([starts, [m]]))
            off = idx - np.repeat(idx[starts], runlen)
            posn = cursor[node_s] + off
            obj._nbr[posn] = other_s
            obj._t[posn] = t_s
            obj._e[posn] = e_s
            obj._bkey[posn] = node_s * obj._nb + (batch_s + 1)
            np.add(cursor, np.bincount(node_s, minlength=num_nodes),
                   out=cursor)

        # pass 2a: history strictly precedes the stream (batch -1)
        if nh:
            h_t = history.time[live]
            order = np.lexsort((h_slot, h_t, h_node))
            place(h_node[order], history.nbr[live][order], h_t[order],
                  history.eidx[live][order], np.full(nh, -1, np.int64))

        # pass 2b: aligned chunks, each sorted with the one-shot key
        pos = 0
        for src, dst, t, eidx in _aligned_chunks(get_iter(), batch_size):
            m = len(src)
            src = np.asarray(src, np.int64)
            dst = np.asarray(dst, np.int64)
            t = np.asarray(t, np.float64)
            eidx = np.asarray(eidx, np.int64)
            edge_i = np.arange(pos, pos + m, dtype=np.int64)
            batch_of = edge_i // batch_size
            ev_node = np.concatenate([src, dst])
            ev_other = np.concatenate([dst, src])
            ev_t = np.concatenate([t, t])
            ev_e = np.concatenate([eidx, eidx])
            ev_batch = np.concatenate([batch_of, batch_of])
            ev_side = np.concatenate([np.zeros(m, np.int64),
                                      np.ones(m, np.int64)])
            ev_edge = np.concatenate([edge_i, edge_i])
            order = np.lexsort((ev_edge, ev_side, ev_t, ev_batch, ev_node))
            place(ev_node[order], ev_other[order], ev_t[order],
                  ev_e[order], ev_batch[order])
            pos += m
        if not np.array_equal(cursor, obj._indptr[1:]):
            raise ValueError(
                "chunk passes disagree: the chunk source must yield the "
                "same stream on every iteration")
        return obj

    def sample(
        self,
        nodes: np.ndarray,
        batch_of: np.ndarray | int,
        window: np.ndarray | int = 0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """K most recent neighbors of ``nodes`` as of batch ``batch_of``.

        ``batch_of`` is scalar or per-row: events of stream batches
        >= batch_of are excluded (history always included). ``window``
        (scalar or per-row) shifts the K-wide gather back in time: window
        w returns events ``[end-(w+1)K, end-wK)``. Shapes: (len(nodes), K)
        ids / times / edge indices, oldest -> newest, -1 front-padded
        (times -1.0).
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        batch_of = np.broadcast_to(np.asarray(batch_of, np.int64),
                                   nodes.shape)
        window = np.broadcast_to(np.asarray(window, np.int64), nodes.shape)
        start = self._indptr[nodes]
        end = np.searchsorted(self._bkey, nodes * self._nb + (batch_of + 1),
                              side="left")
        idx = (end[:, None] - (window[:, None] + 1) * self.k
               + np.arange(self.k)[None, :])
        valid = idx >= start[:, None]
        idx = np.clip(idx, 0, max(len(self._nbr) - 1, 0))
        if len(self._nbr) == 0:
            shape = (len(nodes), self.k)
            return (np.full(shape, -1, np.int64),
                    np.full(shape, -1.0, np.float64),
                    np.full(shape, -1, np.int64))
        ids = np.where(valid, self._nbr[idx], -1)
        tms = np.where(valid, self._t[idx], -1.0)
        eix = np.where(valid, self._e[idx], -1)
        return ids, tms, eix

    def final_snapshot(self) -> NeighborSnapshot:
        """Index state after the full stream (for val/test continuation)."""
        all_nodes = np.arange(self.num_nodes, dtype=np.int64)
        ids, tms, eix = self.sample(all_nodes, self.num_batches)
        return NeighborSnapshot(nbr=ids, time=tms, eidx=eix)

    def device_export(self, depth: int = 1) -> dict[str, np.ndarray]:
        """T-CSR as stageable arrays for the device samplers
        (``kernels.ref.sample_ref`` and the ``neighbor_sample`` kernel).

        The event arrays are FRONT-PADDED with ``k * depth`` zero entries
        and ``indptr`` is shifted to match, so the K-wide gather window
        ``[end - (w+1)k, end - wk)`` is in bounds for every window
        w < depth. ``bat`` stores each event's search key ``batch + 1``
        (history = 0), non-decreasing within a node's segment. Times are
        cast to float32 here, where ``build_batch_program`` casts the
        host-sampled grid.
        """
        if depth < 1:
            raise ValueError(f"depth={depth}: expected >= 1")
        pad = self.k * depth
        total = len(self._nbr)

        def padded(arr, dtype):
            out = np.zeros(pad + total, dtype)
            out[pad:] = arr
            return out

        return {
            "indptr": (self._indptr + pad).astype(np.int32),
            "nbr": padded(self._nbr, np.int32),
            "t": padded(self._t, np.float32),
            "eidx": padded(self._e, np.int32),
            "bat": padded(self._bkey % self._nb, np.int32),
        }
