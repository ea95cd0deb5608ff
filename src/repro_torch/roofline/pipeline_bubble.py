"""Epoch-boundary pipeline-bubble model: serial vs overlapped boundaries,
as ``repro/roofline/pipeline_bubble.py`` (a copy: the port imports nothing
of the JAX package).

PAC's per-epoch device work is one scanned program, but three more things
happen at every epoch boundary:

  * **plan** — host-side shuffle-combine + localization + batch grids
    (``plan_epoch``), pure CPU wall-time;
  * **stage** — host->device transfer of the plan (the staged tensors'
    copies to the card), modeled from staged bytes over the H2D link;
  * **sync** — the Alg.2 shared-node memory epilogue's cross-host
    collectives, modeled from ``kernel_bytes.pac_sync_bytes`` over the
    link between hosts;
  * **fetch** — the per-epoch device->host loss read (an all-gather +
    copy over several ranks).

Three boundary disciplines are modeled, matching the trainers:

  * ``serial`` — everything in line: plan + stage + sync + fetch per
    epoch (``prefetch=False`` + ``epoch_boundary="serial"``);
  * ``prefetch`` — plan+stage hidden behind the scan on the worker
    thread: only the *spill* — the part of
    plan+stage longer than the scan — plus sync + fetch stays exposed;
  * ``overlapped`` — the async boundary (``epoch_boundary="overlap"``):
    sync is dispatched as a separate program the main thread never
    blocks on and the loss read is an async copy collected after the
    loop, so per-epoch only the spill and the dispatch overhead remain;
    one full sync+fetch drain is paid once, at the end of training,
    amortized as ``(sync + fetch) / epochs`` per epoch.

All quantities are per-epoch *boundary* seconds — scan time itself is
identical across disciplines and excluded (it enters only through the
spill term).
"""

from __future__ import annotations

__all__ = ["boundary_component_seconds", "pipeline_bubble"]


def boundary_component_seconds(*, sync_bytes: float, staging_bytes: float,
                               plan_s: float, dcn_gbps: float = 1.25,
                               h2d_gbps: float = 8.0) -> dict:
    """Convert boundary byte counts into per-component seconds.

    ``sync_bytes`` is the cross-host slice of the sync epilogue
    (``pac_sync_bytes(...)["cross_host"]`` summed over local devices),
    ``staging_bytes`` the per-host staged plan bytes
    (``pac_staging_bytes`` / ``EpochPlan.plan_bytes``), ``plan_s`` the
    measured host planning wall-time.  Link rates are GB/s (1e9).
    """
    if dcn_gbps <= 0 or h2d_gbps <= 0:
        raise ValueError(f"link rates must be positive, got "
                         f"dcn_gbps={dcn_gbps}, h2d_gbps={h2d_gbps}")
    return {
        "plan_s": float(plan_s),
        "stage_s": float(staging_bytes) / (h2d_gbps * 1e9),
        "sync_s": float(sync_bytes) / (dcn_gbps * 1e9),
    }


def pipeline_bubble(*, plan_s: float, stage_s: float, sync_s: float,
                    fetch_s: float, scan_s: float, epochs: int,
                    dispatch_s: float = 0.0) -> dict:
    """Per-epoch boundary-bubble seconds for the three disciplines.

    ``scan_s`` is the per-epoch device scan time (what the worker thread
    can hide plan+stage behind); ``dispatch_s`` is the per-epoch Python/
    launch overhead of issuing the extra sync program and the async
    loss copy (measure it — on a CPU test rig it is not negligible
    against simulated link times).  ``epochs`` amortizes the single
    end-of-training drain the overlapped discipline still pays.

    Returns the three per-epoch bubbles plus the spill term and the
    speedup ratios (``inf``-guarded for degenerate zero bubbles).
    """
    if epochs < 1:
        raise ValueError(f"epochs={epochs}: expected >= 1")
    for name, v in (("plan_s", plan_s), ("stage_s", stage_s),
                    ("sync_s", sync_s), ("fetch_s", fetch_s),
                    ("scan_s", scan_s), ("dispatch_s", dispatch_s)):
        if v < 0:
            raise ValueError(f"{name}={v}: expected >= 0")
    # the part of host planning + staging that does NOT fit behind the
    # scan — exposed in every discipline that prefetches
    spill = max(0.0, plan_s + stage_s - scan_s)
    serial = plan_s + stage_s + sync_s + fetch_s
    prefetch = spill + sync_s + fetch_s
    overlapped = spill + dispatch_s + (sync_s + fetch_s) / epochs
    return {
        "spill_s": spill,
        "serial_s": serial,
        "prefetch_s": prefetch,
        "overlapped_s": overlapped,
        "speedup_vs_serial": serial / overlapped if overlapped > 0
        else float("inf"),
        "speedup_vs_prefetch": prefetch / overlapped if overlapped > 0
        else float("inf"),
    }
