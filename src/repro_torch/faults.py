"""Deterministic fault injection for the elastic PAC subsystem, as
``repro/faults.py``: the same grammar, sites, counters and draws, so one
``REPRO_FAULTS`` string fails the port where it fails the JAX package.

Training code calls ``FaultInjector.fire(site, **ctx)`` at named injection
points; which (if any) of those calls actually fail is decided by a spec
string, usually the ``REPRO_FAULTS`` environment variable, so the
two-process CPU-cluster test can kill process 1 mid-epoch without
patching any code path. A spec either pins an exact epoch / call index,
or draws from a seeded per-spec generator keyed on the call count.

Spec grammar (``;``-separated specs, ``,``-separated ``key=value`` args)::

    host_kill@epoch=1                 # SIGKILL self at the epoch-1 site
    staging_oom@at=2                  # MemoryError on the 2nd staging call
    prefetch_worker@epoch=0;sync_fail@epoch=1
    sync_fail@prob=0.5,seed=7         # seeded Bernoulli per call
    host_kill@epoch=1,rank=1          # only fire in process 1

Sites that ``tig.distributed.pac_train`` fires (unknown sites are legal:
a spec simply never matches until some code fires it):

  * ``host_kill``       — top of each PAC epoch (action ``kill``: SIGKILL)
  * ``staging_oom``     — once per epoch where its plan is staged, on the
                          main thread just before the epoch program runs
                          (action ``oom``); ``at=n`` is the n-th epoch run
  * ``prefetch_worker`` — inside the prefetcher's build callback
  * ``sync_fail``       — before the shared-node memory sync

A ``prob < 1`` draw seeds on ``hash(site)``, which Python salts per
process (as the JAX package does): it repeats within one process, not
across processes.

This module also owns the classification side of fault tolerance:
``HostLossError`` is what ``pac_train`` raises when a failure over a mesh
of several ranks looks like a lost peer, and ``is_host_loss`` is the
textual classifier that maps raw collective exceptions (gloo, NCCL, the
TCP store) onto it.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Optional

__all__ = [
    "InjectedFault",
    "HostLossError",
    "is_host_loss",
    "FaultSpec",
    "parse_faults",
    "FaultInjector",
    "FAULTS_ENV",
]

FAULTS_ENV = "REPRO_FAULTS"
_RANK_ENV = "REPRO_PAC_ORIG_RANK"

# default action per site; any spec can override with action=...
_SITE_ACTIONS = {
    "host_kill": "kill",
    "staging_oom": "oom",
}
_ACTIONS = ("raise", "oom", "kill")


class InjectedFault(RuntimeError):
    """A deterministic injected failure (``action="raise"`` sites)."""

    def __init__(self, site: str, ctx: dict):
        super().__init__(f"injected fault at {site!r} ({ctx})")
        self.site = site
        self.ctx = ctx


class HostLossError(RuntimeError):
    """A peer process is gone (or unreachable): the multi-process run
    cannot continue with the current world and must be re-formed over the
    survivors (``launch.pac_cluster`` exits ``EXIT_PEER_LOST`` on this)."""


# substrings (lowercased) that mark a collective/distributed-plane failure
# rather than a local bug. The JAX package's: transport errors, the
# coordination service's liveness machinery, socket-level breakage ...
_DIST_MARKERS = (
    "gloo",
    "connection reset",
    "connection closed",
    "connection refused",
    "broken pipe",
    "socket",
    "unavailable",
    "deadline exceeded",
    "heartbeat",
    "coordination service",
    "peer",
    "distributed runtime",
    "barrier",
    "timed out",
) + (
    # ... and what torch.distributed raises when a peer is lost: gloo's
    # transport ("Read error [host]:port: ..."), the c10d wrappers of
    # backend and store errors, a collective past its timeout (the NCCL
    # watchdog's wording), a peer that exited under NCCL, and an aborted
    # communicator
    "read error",
    "distbackenderror",
    "distnetworkerror",
    "collective operation timeout",
    "before timing out",
    "ncclremoteerror",
    "remote process exited",
    "communicator was aborted",
)

# NCCL's local errors: c10d raises them as DistBackendError too, but they
# are this process's own (a wrong call, a bad argument, a CUDA failure)
_LOCAL_MARKERS = (
    "ncclinvalidusage",
    "ncclinvalidargument",
    "ncclunhandledcudaerror",
)


def is_host_loss(exc: BaseException) -> bool:
    """True when ``exc`` (or its cause chain) looks like a lost or
    unreachable peer rather than a local error. Purely textual: gloo,
    NCCL and the TCP store surface these as generic ``RuntimeError`` /
    ``DistBackendError`` strings. A link of the chain that names one of
    NCCL's local errors does not count, whatever else it says."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, HostLossError):
            return True
        text = f"{type(exc).__name__}: {exc}".lower()
        if not any(m in text for m in _LOCAL_MARKERS) \
                and any(m in text for m in _DIST_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


@dataclasses.dataclass
class FaultSpec:
    """One armed failure: fires at most once, at a deterministic point."""

    site: str
    epoch: Optional[int] = None   # fire only when ctx["epoch"] == epoch
    at: Optional[int] = None      # fire only on the Nth call (1-based)
    rank: Optional[int] = None    # fire only in this (original) process
    prob: float = 1.0             # seeded Bernoulli per matching call
    seed: int = 0
    action: str = ""              # "" -> site default ("raise" otherwise)
    fired: bool = False

    def resolved_action(self) -> str:
        act = self.action or _SITE_ACTIONS.get(self.site, "raise")
        if act not in _ACTIONS:
            raise ValueError(f"unknown fault action {act!r} (expected one "
                             f"of {_ACTIONS})")
        return act


def parse_faults(text: str) -> list[FaultSpec]:
    """Parse the ``site@k=v,k=v;site2@...`` grammar into specs."""
    specs = []
    for chunk in (text or "").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        site, _, argstr = chunk.partition("@")
        kw: dict = {}
        for pair in filter(None, (p.strip() for p in argstr.split(","))):
            key, _, val = pair.partition("=")
            if key in ("epoch", "at", "rank", "seed"):
                kw[key] = int(val)
            elif key == "prob":
                kw[key] = float(val)
            elif key == "action":
                kw[key] = val
            else:
                raise ValueError(f"unknown fault spec arg {key!r} in "
                                 f"{chunk!r}")
        spec = FaultSpec(site=site.strip(), **kw)
        spec.resolved_action()      # validate eagerly
        specs.append(spec)
    return specs


class FaultInjector:
    """Holds armed ``FaultSpec``s and fires them at matching call sites.

    An injector with no specs is inert (``fire`` is a cheap no-op), so
    trainers can call ``FaultInjector.from_env()`` unconditionally.
    ``process_index`` scopes rank-filtered specs; when ``None`` it is
    resolved lazily from ``REPRO_PAC_ORIG_RANK`` (set by the elastic
    launcher, which re-ranks survivors), then from the rank of an
    initialized ``torch.distributed`` group, else 0.
    """

    def __init__(self, specs=(), process_index: Optional[int] = None):
        self.specs = list(specs)
        self._rank = process_index
        self._counts: dict[str, int] = {}

    @classmethod
    def parse(cls, text: str, process_index: Optional[int] = None
              ) -> "FaultInjector":
        return cls(parse_faults(text), process_index=process_index)

    @classmethod
    def from_env(cls, env_var: str = FAULTS_ENV) -> "FaultInjector":
        return cls.parse(os.environ.get(env_var, ""))

    @property
    def armed(self) -> bool:
        return any(not s.fired for s in self.specs)

    def _process_index(self) -> int:
        if self._rank is None:
            env = os.environ.get(_RANK_ENV)
            if env is not None:
                self._rank = int(env)
            else:
                import torch.distributed as dist

                self._rank = dist.get_rank() if (
                    dist.is_available() and dist.is_initialized()) else 0
        return self._rank

    def _draw(self, spec: FaultSpec, count: int) -> bool:
        if spec.prob >= 1.0:
            return True
        import numpy as np
        rng = np.random.default_rng(
            np.random.SeedSequence([spec.seed, hash(spec.site) & 0x7FFFFFFF,
                                    count]))
        return bool(rng.random() < spec.prob)

    def fire(self, site: str, **ctx) -> None:
        """Raise/kill if an armed spec matches this call; no-op otherwise."""
        if not self.specs:
            return
        count = self._counts.get(site, 0) + 1
        self._counts[site] = count
        for spec in self.specs:
            if spec.fired or spec.site != site:
                continue
            if spec.epoch is not None and ctx.get("epoch") != spec.epoch:
                continue
            if spec.at is not None and count != spec.at:
                continue
            if spec.rank is not None and self._process_index() != spec.rank:
                continue
            if not self._draw(spec, count):
                continue
            spec.fired = True
            self._trip(spec, site, dict(ctx, call=count))

    def _trip(self, spec: FaultSpec, site: str, ctx: dict) -> None:
        action = spec.resolved_action()
        if action == "kill":
            # simulated host loss: die like a preempted/OOM-killed host —
            # no exception propagation, no cleanup, no exit handlers
            print(f"FAULT_INJECTED: {site} {ctx} -> SIGKILL", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        if action == "oom":
            raise MemoryError(f"injected staging OOM at {site!r} ({ctx})")
        raise InjectedFault(site, ctx)
