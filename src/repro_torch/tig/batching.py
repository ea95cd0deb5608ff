"""Host-side batch construction for TIG training, copied from
``repro/tig/batching.py`` (the same numpy RNG use, so an epoch plan is
bit-identical to the JAX package's).

Batches are built chronologically and emitted pre-stacked as (steps, ...)
arrays. Temporal neighbors of (src, dst, neg) come from the
``ChronoNeighborIndex`` built once per stream: every batch samples as of
its own batch boundary, so neighbors strictly precede the batch. All ids
are LOCAL ids; -1 marks padding. The edge-feature table gets one extra
zero row at index E so -1 neighbor edge indices can be remapped on device.

With ``plan="device"`` the pre-sampled neighbor grids are omitted: the
program is raw edge records (src, dst, t, feature rows) and the engine
samples neighbors inside each step from the stream's staged T-CSR.
``plan="host"`` pre-samples them here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.tig.sampler import ChronoNeighborIndex, NeighborSnapshot

__all__ = ["LocalStream", "build_batch_program", "build_batches",
           "concat_batch_programs", "pad_batch_programs", "stack_batches",
           "unstack_batches", "make_tables"]


@dataclasses.dataclass
class LocalStream:
    """A device-local edge stream (already localized node ids).

    ``eidx`` indexes into the local edge-feature table (E_local rows).
    """

    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray
    eidx: np.ndarray
    num_local_nodes: int
    labels: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return len(self.src)


def make_tables(edge_feat: np.ndarray, node_feat: np.ndarray) -> dict:
    """Feature tables with trailing zero dump rows (for -1 remapping)."""
    e = np.concatenate([edge_feat,
                        np.zeros((1, edge_feat.shape[1]), edge_feat.dtype)])
    n = np.concatenate([node_feat,
                        np.zeros((1, node_feat.shape[1]), node_feat.dtype)])
    return {"efeat": e, "nfeat": n}


def _padded(x: np.ndarray, steps: int, b: int, fill) -> np.ndarray:
    """(E, ...) -> (steps, b, ...) chronological grid, tail ``fill``-padded."""
    out = np.full((steps * b,) + x.shape[1:], fill, dtype=x.dtype)
    out[: len(x)] = x
    return out.reshape((steps, b) + x.shape[1:])


def build_batch_program(
    stream: LocalStream,
    cfg,
    rng: np.random.Generator,
    history: Optional[NeighborSnapshot] = None,
    neg_pool: Optional[np.ndarray] = None,
    index: Optional[ChronoNeighborIndex] = None,
    plan: str = "host",
) -> tuple[dict, NeighborSnapshot]:
    """Fully pre-staged epoch plan: a (steps, ...) batch dict of numpy
    arrays.

    Args:
      cfg: a ``TIGConfig`` (``batch_size``, ``num_neighbors`` and
        ``n_layers`` are read).
      history: neighbor index state carried over from an earlier stream
        (e.g. train -> val continuation); defaults to an empty history.
      neg_pool: candidate local ids for negative sampling (defaults to the
        stream's destination nodes — the JODIE/TGN convention).
      index: pre-built neighbor index for this stream (e.g. one reused
        across epochs); mutually exclusive with ``history`` and checked
        against the stream/cfg shape. Defaults to a fresh build.
      plan: ``"host"`` pre-samples the (steps, b, k) neighbor grids here
        ((steps, L, b, k) with ``n_layers`` L > 1); ``"device"`` ships
        only the raw edge records.

    Returns ``(batches, final_history)``: ``batches`` maps each
    ``models.step_loss`` key to a (steps, batch, ...) array;
    ``final_history`` is the neighbor index state after the whole stream.
    """
    if plan not in ("host", "device"):
        raise ValueError(f"plan={plan!r}: expected 'host' or 'device'")
    b, k = cfg.batch_size, cfg.num_neighbors
    if neg_pool is None or len(neg_pool) == 0:
        neg_pool = np.unique(stream.dst)
    n_edges = stream.num_edges
    steps = max(1, -(-n_edges // b))

    if index is None:
        index = ChronoNeighborIndex(
            stream.src, stream.dst, stream.t, stream.eidx,
            stream.num_local_nodes, k, b, history=history)
    else:
        if history is not None:
            raise ValueError("pass history to the index build, not both")
        if (index.num_nodes, index.k, index.batch_size) != \
                (stream.num_local_nodes, k, b):
            raise ValueError("index shape does not match stream/cfg")
        if index.num_batches != steps:
            # a different-length stream would alias into neighboring nodes'
            # (node, batch) key ranges and sample silently-wrong neighbors
            raise ValueError(
                f"index covers {index.num_batches} batches, stream has "
                f"{steps}")

    src = _padded(stream.src, steps, b, -1).astype(np.int32)
    dst = _padded(stream.dst, steps, b, -1).astype(np.int32)
    t = _padded(stream.t.astype(np.float32), steps, b, 0.0)
    eidx = _padded(stream.eidx, steps, b, -1).astype(np.int32)
    neg = rng.choice(neg_pool, size=(steps, b)).astype(np.int32)
    valid = _padded(np.ones(n_edges, dtype=bool), steps, b, False)

    batches = {"src": src, "dst": dst, "neg": neg,
               "t": t, "eidx": eidx, "valid": valid}
    if stream.labels is not None:
        batches["labels"] = _padded(stream.labels, steps, b, -1)

    if plan == "device":
        return batches, index.final_snapshot()

    # neighbors as of each row's own batch boundary (strictly-before-batch)
    batch_of = np.broadcast_to(np.arange(steps)[:, None], (steps, b))
    n_l = cfg.n_layers
    for role, ids in (("src", src), ("dst", dst), ("neg", neg)):
        alive = (ids >= 0) & valid
        clean = np.where(alive, ids, 0)
        if n_l == 1:
            nb, nt, ne = index.sample(clean.ravel(), batch_of.ravel())
            nb = nb.reshape(steps, b, k)
            nt = nt.reshape(steps, b, k)
            ne = ne.reshape(steps, b, k)
            nb[~alive] = -1
            ne[~alive] = -1
        else:
            # (steps, L, B, K) grids: layer l gets the (L-1-l)-th most
            # recent K-window, as the device sampler lays them out
            grids = [index.sample(clean.ravel(), batch_of.ravel(),
                                  window=w)
                     for w in range(n_l - 1, -1, -1)]
            nb = np.stack([g[0].reshape(steps, b, k) for g in grids], 1)
            nt = np.stack([g[1].reshape(steps, b, k) for g in grids], 1)
            ne = np.stack([g[2].reshape(steps, b, k) for g in grids], 1)
            dead = ~alive[:, None, :, None]
            nb = np.where(dead, -1, nb)
            ne = np.where(dead, -1, ne)
        batches[f"nbr_{role}"] = nb.astype(np.int32)
        batches[f"nbrt_{role}"] = nt.astype(np.float32)
        batches[f"nbre_{role}"] = ne.astype(np.int32)

    return batches, index.final_snapshot()


def concat_batch_programs(programs: list[dict]) -> tuple[dict, np.ndarray]:
    """Concatenate per-device (steps_k, ...) batch programs into ONE flat
    grid plus per-device row offsets (PAC's transfer-minimal layout: device
    k reads row ``offsets[k] + s % steps_k`` at lockstep step s).

    Returns ``(flat, offsets)`` with ``offsets`` int32 (N_dev,).
    """
    lengths = np.array([len(p["src"]) for p in programs], dtype=np.int64)
    offsets = np.concatenate(
        [[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    flat = {k: np.concatenate([p[k] for p in programs])
            for k in programs[0]}
    return flat, offsets


def pad_batch_programs(programs: list[dict], rows_cap: int) -> dict:
    """Stack per-device (rows_k, ...) batch programs into one zero-padded
    (N_held, rows_cap, ...) grid: PAC's row-range-sharded layout, where
    each device owns its own leading row, so a rank stages only its own
    devices' rows. ``rows_cap`` is the global ``max_k n_batches_k``; the
    padding rows are zeros and never read (device k reads row
    ``s % n_batches_k``).
    """
    out = {}
    for key in programs[0]:
        parts = []
        for p in programs:
            v = np.asarray(p[key])
            if len(v) > rows_cap:
                raise ValueError(
                    f"batch program has {len(v)} rows > rows_cap={rows_cap}")
            pad = [(0, rows_cap - len(v))] + [(0, 0)] * (v.ndim - 1)
            parts.append(np.pad(v, pad))
        out[key] = np.stack(parts)
    return out


def build_batches(
    stream: LocalStream,
    cfg,
    rng: np.random.Generator,
    history: Optional[NeighborSnapshot] = None,
    neg_pool: Optional[np.ndarray] = None,
    *,
    return_history: bool = False,
):
    """Chronological fixed-shape batches with pre-sampled neighbors, as a
    list of per-batch numpy dicts matching ``models.step_loss`` (the
    host plan of ``build_batch_program``, unstacked).

    With ``return_history=True`` also returns the post-stream
    ``NeighborSnapshot`` for continuing into a later stream.
    """
    stacked, final = build_batch_program(stream, cfg, rng, history,
                                         neg_pool)
    batches = unstack_batches(stacked)
    return (batches, final) if return_history else batches


def stack_batches(batches: list[dict]) -> dict:
    """Stack per-step batch dicts into (steps, ...) arrays."""
    keys = batches[0].keys()
    return {k: np.stack([b[k] for b in batches]) for k in keys}


def unstack_batches(stacked: dict) -> list[dict]:
    """Inverse of ``stack_batches``: (steps, ...) arrays -> a list of
    per-step dicts."""
    steps = len(next(iter(stacked.values())))
    return [{k: v[s] for k, v in stacked.items()} for s in range(steps)]
