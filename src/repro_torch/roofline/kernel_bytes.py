"""Analytic per-step HBM-byte models of SPEED's kernels: fused vs unfused
pipelines, as ``repro/roofline/kernel_bytes.py`` (a copy: the port imports
nothing of the JAX package).

Companion to the step cost counter (``op_cost.py``): that one counts what
a step dispatches; this one models what each kernel *must* move, so the
fused kernels (``repro_torch.kernels``) can be compared against an
unfused pipeline and against the oracle-VJP backward (which replays the
unfused forward) without a device attached.

Modeling conventions (documented per op below):

  * one read per operand a kernel consumes, one write per tensor it
    produces; on-chip reuse inside a fused kernel is free;
  * the unfused pipelines are modeled at kernel-fusion granularity:
    matmuls / einsums materialize their outputs, the elementwise chains
    between them are assumed perfectly fused (generous to the unfused
    side);
  * the oracle-VJP backward replays the unfused forward (its residuals are
    the inputs) and materializes the gate / attention cotangents, like
    autograd over ``ref.py``;
  * scatters are modeled in place (donated buffers inside the epoch):
    read + write of the touched rows only.  The O(N) terms charged to the
    unfused flush are the aggregation *tables* it genuinely materializes.

Every model returns an ``OpBytes`` with an itemized ``reads`` / ``writes``
dict so benchmark CSVs can show where the bytes go.

Lane padding (``lanes=True``): the JAX package's Pallas wrappers pad every
contraction / lane dim to a multiple of 128 lanes (and the attention K
axis to 8 sublanes) for the TPU's MXU. On the card the port's kernels run
unpadded (``repro_torch/kernels/ops.py``), so ``lanes=False``, the
default, is what they move; ``lanes=True`` is kept for parity with the
JAX functions and models the padded TPU launches.
"""

from __future__ import annotations

import dataclasses

__all__ = ["OpBytes", "gru_bytes", "attn_bytes", "flush_bytes",
           "sample_bytes", "epoch_plan_bytes", "step_pipeline_bytes",
           "pac_sync_bytes", "pac_staging_bytes",
           "lane_pad", "sublane_pad"]

F32 = 4
MASK = 1       # bool
LANES = 128    # f32 lane count of the TPU layout — last-dim tile
SUBLANES = 8   # f32 sublane count — second-to-last-dim tile


def lane_pad(n: int) -> int:
    """Round ``n`` up to the 128-lane tile of the JAX package's padding."""
    return -(-int(n) // LANES) * LANES


def sublane_pad(n: int) -> int:
    """Round ``n`` up to the 8-sublane tile (attention K axis)."""
    return -(-int(n) // SUBLANES) * SUBLANES


@dataclasses.dataclass(frozen=True)
class OpBytes:
    op: str
    direction: str          # "fwd" | "bwd"
    pipeline: str           # "fused" | "unfused" | "oracle"
    reads: dict
    writes: dict

    @property
    def read_bytes(self) -> int:
        return int(sum(self.reads.values()))

    @property
    def write_bytes(self) -> int:
        return int(sum(self.writes.values()))

    @property
    def total(self) -> int:
        return self.read_bytes + self.write_bytes


def _merge(*dicts):
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


# ------------------------------------------------------------------- GRU

def gru_bytes(b, d_in, d_h, *, direction="fwd", fused=True,
              lanes=False, itemsize=F32) -> OpBytes:
    """h' = GRU(x, h) over (b, d_in) x (b, d_h) rows.

    unfused fwd: two gate matmuls materialize gx/gh (b, 3*d_h) in HBM, a
    fused elementwise kernel re-reads them plus h.  oracle bwd: replays
    that forward, materializes the r/z/n/nh residuals and the dgx/dgh gate
    cotangents, then runs 4 matmuls over them.  fused bwd: recomputes the
    gates on chip — one read per operand, one write per gradient.

    ``lanes=True`` models the JAX package's lane-padded launch: d_in and
    d_h rounded up to 128 (every gate block padded, so gx/gh are 3 *
    lane_pad(d_h) wide).
    """
    if lanes:
        d_in, d_h = lane_pad(d_in), lane_pad(d_h)
    x, h = b * d_in * itemsize, b * d_h * itemsize
    wx, wh = d_in * 3 * d_h * itemsize, d_h * 3 * d_h * itemsize
    bias = 2 * 3 * d_h * itemsize
    gates = b * 3 * d_h * itemsize          # one of gx / gh / dgx / dgh
    operands = {"x": x, "h": h, "wx": wx, "wh": wh, "bias": bias}

    if direction == "fwd":
        if fused:
            return OpBytes("gru", "fwd", "fused", operands, {"out": h})
        return OpBytes(
            "gru", "fwd", "unfused",
            _merge(operands, {"gx_gh_reread": 2 * gates, "h_reread": h}),
            {"gx_gh": 2 * gates, "out": h})

    grads = {"dx": x, "dh": h, "dwx": wx, "dwh": wh, "dbias": bias}
    if fused:
        return OpBytes("gru", "bwd", "fused",
                       _merge(operands, {"g": h}), grads)
    # oracle-VJP: forward replay + residual/cotangent round-trips
    replay_r = _merge(operands, {"gx_gh_reread": 2 * gates, "h_reread": h})
    replay_w = {"gx_gh": 2 * gates, "rznn_residuals": 4 * h}
    bwd_r = {"g": h, "rznn_residuals": 4 * h, "h_bwd": h,
             "dgx_dgh_reread": 2 * 2 * gates,      # dx/dwx + dh/dwh matmuls
             "x_bwd": x, "wx_bwd": wx, "wh_bwd": wh}
    bwd_w = {"dgx_dgh": 2 * gates}
    return OpBytes("gru", "bwd", "oracle",
                   _merge(replay_r, bwd_r),
                   _merge(replay_w, bwd_w, grads))


# ------------------------------------------------------- temporal attention

def attn_bytes(b, k, h, d, *, direction="fwd", fused=True,
               lanes=False, itemsize=F32) -> OpBytes:
    """Masked neighbor attention over q (b,h,d), k/v (b,k,h,d), mask (b,k).

    unfused fwd: QK^T materializes scores (b,h,k), softmax+zero-fix
    re-reads/rewrites them, AV re-reads.  oracle bwd: replays that, then
    materializes datt/ds cotangents for the dq/dk/dv einsums.  fused bwd:
    softmax recomputed on chip — one pass per operand/gradient.

    ``lanes=True`` models the JAX package's lane-padded launch: head dim
    d rounded up to 128 lanes, neighbor axis k to 8 sublanes (padded
    slots carry mask=False but still ride the DMA).
    """
    if lanes:
        k, d = sublane_pad(k), lane_pad(d)
    q = b * h * d * itemsize
    kv = b * k * h * d * itemsize
    mask = b * k * MASK
    sc = b * h * k * itemsize               # one scores-shaped tensor
    operands = {"q": q, "k": kv, "v": kv, "mask": mask}

    if direction == "fwd":
        if fused:
            return OpBytes("temporal_attn", "fwd", "fused",
                           operands, {"out": q})
        return OpBytes(
            "temporal_attn", "fwd", "unfused",
            _merge(operands, {"scores_reread": sc, "att_reread": sc}),
            {"scores": sc, "att": sc, "out": q})

    grads = {"dq": q, "dk": kv, "dv": kv}
    if fused:
        return OpBytes("temporal_attn", "bwd", "fused",
                       _merge(operands, {"g": q}), grads)
    replay_r = _merge(operands, {"scores_reread": sc, "att_reread": sc})
    replay_w = {"scores": sc, "att": sc}
    bwd_r = {"g": 2 * q,                    # datt einsum + dv einsum
             "v_bwd": kv, "att_bwd": 2 * sc,
             "datt": sc, "ds_reread": 2 * sc,    # dq + dk einsums
             "k_bwd": kv, "q_bwd": q}
    bwd_w = {"datt": sc, "ds": sc}
    return OpBytes("temporal_attn", "bwd", "oracle",
                   _merge(replay_r, bwd_r),
                   _merge(replay_w, bwd_w, grads))


# ------------------------------------------------------------ message flush

def flush_bytes(n_nodes, rows, d_msg, d_mem, *, direction="fwd", fused=True,
                lanes=False, itemsize=F32) -> OpBytes:
    """The flush_pending message pipeline: segment-mean over ``rows``
    (=2B) pending messages, GRU update, scatter of mem/last.

    ``lanes=True`` pads ONLY the d_msg side (message columns + wx gate
    rows) to 128 lanes, as the JAX package does: the memory table is
    aliased in place, so d_mem stays raw — padding it would force an O(N)
    copy and defeat the kernel's O(rows)-traffic point.

    unfused fwd: materializes the (N+1, d_msg) scatter-add sums table and
    the (N+1,) counts, divides over the FULL table (read+write), gathers
    back, then runs the unfused GRU on the touched rows — O(N) traffic for
    O(rows) work.  fused fwd: one fused launch touching only the ``rows``
    gathered memory rows (+ weights); no tables.  bwd is the oracle VJP in
    both pipelines (it replays the unfused forward and emits a full-table
    memory cotangent) — the fused win in the backward comes from the GRU /
    attention kernels, not the flush.
    """
    if lanes:
        d_msg = lane_pad(d_msg)
    msg = rows * d_msg * itemsize
    memrows = rows * d_mem * itemsize
    ids = rows * 4
    ts = rows * itemsize
    tbl = (n_nodes + 1) * d_msg * itemsize      # sums / mbar table
    cnt = (n_nodes + 1) * itemsize
    wx = d_msg * 3 * d_mem * itemsize
    wh = d_mem * 3 * d_mem * itemsize
    bias = 2 * 3 * d_mem * itemsize
    weights = {"wx": wx, "wh": wh, "bias": bias}

    if direction == "fwd":
        if fused:
            return OpBytes(
                "flush", "fwd", "fused",
                _merge({"msg": msg, "ids": 3 * ids, "ts": ts,
                        "mem_rows": memrows, "last_rows": ts}, weights),
                {"mem_rows": memrows, "last_rows": ts, "mbar": msg})
        gru_u = gru_bytes(rows, d_msg, d_mem, fused=False,
                          itemsize=itemsize)
        return OpBytes(
            "flush", "fwd", "unfused",
            _merge({"msg": msg, "ids": ids, "ts": ts,
                    "sums_tbl_scatter": msg, "cnt_scatter": ts,
                    "sums_cnt_tbl_div": tbl + cnt,
                    "mbar_tbl_gather": msg,
                    "mem_rows": memrows, "last_rows": ts},
                   {k: v for k, v in gru_u.reads.items()
                    if k not in ("x", "h")}),
            _merge({"sums_tbl_zeros": tbl, "cnt_zeros": cnt,
                    "mbar_tbl": tbl,
                    "mem_rows": memrows, "last_rows": ts, "mbar": msg},
                   {k: v for k, v in gru_u.writes.items() if k != "out"}))

    # oracle VJP either way: unfused forward replay + cotangent tables
    fwd_u = flush_bytes(n_nodes, rows, d_msg, d_mem,
                        direction="fwd", fused=False, itemsize=itemsize)
    gru_b = gru_bytes(rows, d_msg, d_mem, direction="bwd", fused=False,
                      itemsize=itemsize)
    return OpBytes(
        "flush", "bwd", "oracle",
        _merge(fwd_u.reads, {"g_mem": (n_nodes + 1) * d_mem * itemsize,
                             "g_mbar": msg},
               {k: v for k, v in gru_b.reads.items() if k not in ("x", "h")}),
        _merge({"dmsg": msg, "dmem_tbl": (n_nodes + 1) * d_mem * itemsize,
                "dsums_tbl": tbl, "dmbar": 2 * msg},
               {k: v for k, v in gru_b.writes.items()
                if k not in ("dx", "dh")}))


# ------------------------------------------------------- neighbor sampling

I32 = 4


def sample_bytes(rows, k, total_events, *, itemsize=F32) -> OpBytes:
    """One fused temporal-neighbor-sample launch over ``rows`` (=3B) query
    nodes against a ``total_events``-event T-CSR (``kernels.neighbor_sample``).

    The kernel is gather-bound, not compute-bound: per row it runs a
    ceil(log2(total)) binary search over the batch-key array (one 4-byte
    HBM probe per iteration — the DMA engine moves a full transfer lane,
    but the *demanded* bytes are one int32) and then three K-wide window
    DMAs (ids / times / edge rows).  start/stop/key arrive via scalar
    prefetch.  Writes are the three (rows, K) output grids.
    """
    iters = max(1, int(total_events).bit_length())
    reads = {
        "start_stop_key_prefetch": 3 * rows * I32,
        "bisect_probes": rows * iters * I32,
        "nbr_window": rows * k * I32,
        "t_window": rows * k * itemsize,
        "eidx_window": rows * k * I32,
    }
    writes = {
        "ids": rows * k * I32,
        "times": rows * k * itemsize,
        "eidx": rows * k * I32,
    }
    return OpBytes("neighbor_sample", "fwd", "fused", reads, writes)


def epoch_plan_bytes(steps, batch, k, num_nodes, total_events, *,
                     itemsize=F32) -> dict:
    """Per-epoch host->device staging (H2D) bytes: ``plan="host"`` vs
    ``plan="device"`` (``batching.build_batch_program``).

    Both plans ship the raw edge records — per grid row: src/dst/neg/eidx
    int32, t f32, valid bool (21 B).  The host plan additionally stages
    nine pre-sampled neighbor grids (3 roles x (ids + times + edge rows) x
    K = 12K B/row, re-shipped EVERY epoch).  The device plan instead
    stages the stream's T-CSR once — (N+1) int32 indptr plus four
    K-front-padded event columns (ids/times/edge rows/batch keys, 16 B per
    event) — and the scanned step re-samples on device (``sample_bytes``,
    HBM-local traffic, not H2D).

    Returns ``{"host", "device", "host_detail", "device_detail",
    "sample"}`` — totals in bytes, itemized dicts, and the per-step
    on-device sampling ``OpBytes`` the device plan trades the grid H2D
    for.
    """
    rows = steps * batch
    records = rows * (4 * I32 + itemsize + MASK)
    grids = rows * 3 * k * (2 * I32 + itemsize)
    tcsr = (num_nodes + 1) * I32 + (total_events + k) * (3 * I32 + itemsize)
    host = {"records": records, "neighbor_grids": grids}
    device = {"records": records, "tcsr": tcsr}
    return {
        "host": int(sum(host.values())),
        "device": int(sum(device.values())),
        "host_detail": host,
        "device_detail": device,
        "sample": sample_bytes(3 * batch, k, total_events + k,
                               itemsize=itemsize),
    }


# ----------------------------------------------------------- PAC plumbing

def pac_sync_bytes(n_shared, d_mem, n_devices, n_hosts=1, *,
                   mode="latest", itemsize=F32) -> dict:
    """Per-device link bytes of PAC's shared-node memory sync epilogue
    (``distributed.sync_shared_memory``), with the cross-host share.

    ``"latest"`` (the paper's rule) all-gathers only the (S,) last-update
    timestamps — each device receives the other ``N-1`` replicas' rows —
    then combines the (S, d) ``mem``/``mem2`` rows with a winner-masked
    ``psum`` (ring all-reduce: ``2(N-1)/N`` traversals of the tensor per
    device).  ``"mean"`` psums all three tensors instead.  On a mesh whose
    "part" axis spans ``n_hosts`` processes with contiguous per-host
    ranks (``launch.mesh.make_tig_mesh``), ``n_hosts`` of the ring's
    ``N`` hops cross host boundaries, so that fraction of the traffic
    crosses hosts instead of staying on the links inside one.

    Returns ``{"per_device", "cross_host", "dcn_fraction", "detail"}`` —
    bytes per device, the slice of them crossing hosts, and the itemized
    collectives.
    """
    assert mode in ("latest", "mean"), mode
    s, d, n = int(n_shared), int(d_mem), int(n_devices)
    ring = 2 * (n - 1) / max(n, 1)     # reduce-scatter + all-gather
    if mode == "latest":
        detail = {
            "gather_ts": (n - 1) * s * itemsize,
            "psum_mem": int(ring * s * d * itemsize),
            "psum_mem2": int(ring * s * d * itemsize),
        }
    else:
        detail = {
            "psum_mem": int(ring * s * d * itemsize),
            "psum_mem2": int(ring * s * d * itemsize),
            "psum_ts": int(ring * s * itemsize),
        }
    per_device = int(sum(detail.values()))
    dcn_fraction = (n_hosts / n) if (n_hosts > 1 and n > 0) else 0.0
    return {
        "per_device": per_device,
        "cross_host": int(per_device * dcn_fraction),
        "dcn_fraction": dcn_fraction,
        "detail": detail,
    }


def pac_staging_bytes(real_batches, events_per_device, row_bytes, *,
                      event_bytes=3 * I32 + F32, n_hosts=1) -> dict:
    """Per-host staged H2D bytes of the PAC batch plane: replicated flat
    grid vs the row-range-sharded layout (``plan_epoch(layout=...)``).

    ``real_batches`` / ``events_per_device`` are per-device row and T-CSR
    event counts; ``row_bytes`` is one grid row's bytes (one batch).  The
    replicated layout ships EVERY device the full flat buffer, so a host
    with ``n_local`` devices stages ``n_local * (sum rows + sum events)``;
    the sharded layout pads each device to the global caps (a shard_map
    uniform-block requirement) but ships each device only its OWN rows:
    ``sum_local (max rows + max events)``.  Devices split contiguously
    across ``n_hosts`` (the ``make_tig_mesh`` ordering).

    Returns per-host lists plus totals; sharded is strictly below
    replicated whenever a host has >1 device elsewhere to pay for, i.e.
    for every multi-device mesh with at least one real batch per device.
    """
    rows = [int(r) for r in real_batches]
    events = [int(e) for e in events_per_device]
    assert len(rows) == len(events) and rows, (rows, events)
    flat = sum(rows) * row_bytes + sum(events) * event_bytes
    rows_cap, ev_cap = max(rows), max(events)
    per_dev_sharded = rows_cap * row_bytes + ev_cap * event_bytes
    n_dev, rem = divmod(len(rows), n_hosts)
    groups = [n_dev + (1 if h < rem else 0) for h in range(n_hosts)]
    replicated = [int(n_local * flat) for n_local in groups]
    sharded = [int(n_local * per_dev_sharded) for n_local in groups]
    return {
        "replicated": replicated,
        "sharded": sharded,
        "total_replicated": int(sum(replicated)),
        "total_sharded": int(sum(sharded)),
        "per_device_replicated": int(flat),
        "per_device_sharded": int(per_dev_sharded),
    }


# --------------------------------------------------------------- whole step

def step_pipeline_bytes(n_nodes, batch, d_msg, d_mem, k_neighbors, n_heads,
                        *, n_layers=1, lanes=False, itemsize=F32) -> dict:
    """Modeled HBM bytes for the kernelized portion of one training step
    (flush pipeline + the 3B-row embedding attention), fwd + bwd, fused vs
    unfused.  Returns {"fused": bytes, "unfused": bytes, "detail": [...]}.

    ``n_layers``: the stacked temporal-attention fold runs one attention
    launch per layer over the same 3B rows (the scanned layer block), so
    the attention fwd+bwd parts repeat per layer — the flush runs once
    regardless.  ``lanes=True`` models the lane-padded launches (see the
    per-op models).  ``detail`` holds one OpBytes per modeled launch:
    2 flush + 2 * n_layers attention entries per pipeline (8 at defaults).
    """
    head_d = d_mem // n_heads
    out = {}
    detail = []
    for pipeline in ("fused", "unfused"):
        fused = pipeline == "fused"
        parts = [
            flush_bytes(n_nodes, 2 * batch, d_msg, d_mem,
                        direction="fwd", fused=fused, lanes=lanes,
                        itemsize=itemsize),
            flush_bytes(n_nodes, 2 * batch, d_msg, d_mem,
                        direction="bwd", fused=fused, lanes=lanes,
                        itemsize=itemsize),
        ]
        for _ in range(n_layers):
            parts += [
                attn_bytes(3 * batch, k_neighbors, n_heads, head_d,
                           direction="fwd", fused=fused, lanes=lanes,
                           itemsize=itemsize),
                attn_bytes(3 * batch, k_neighbors, n_heads, head_d,
                           direction="bwd", fused=fused, lanes=lanes,
                           itemsize=itemsize),
            ]
        out[pipeline] = sum(p.total for p in parts)
        detail.extend(parts)
    out["detail"] = detail
    return out
