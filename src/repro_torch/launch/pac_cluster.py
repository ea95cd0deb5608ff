"""Multi-process PAC launcher, as ``repro/launch/pac_cluster.py``: one
process (rank) a card, the ranks joined by ``torch.distributed``.

Every rank runs the same program: it plans only its own partitions' rows
(``pac_train`` over ``launch.mesh.make_tig_mesh``), runs their union step
with the gradients all-reduced every lockstep step, and the shared-node
memory sync crosses the ranks at each epoch boundary. Rank 0 binds the
coordinator address; every rank is started with it:

    # card 0                                   # card 1
    python -m repro_torch.launch.pac_cluster \\
        --num-processes 2 --process-id 0 \\      ... --process-id 1 \\
        --coordinator 10.0.0.1:12321 --local-devices 1

``--local-devices`` is the number of partition slots a rank holds (P =
processes x local devices; the JAX package's devices of the "part"
axis). The default backend is NCCL on the card, which raises without
one; ``--device cpu`` selects gloo on the CPU (one intra-op thread, so
the ranks agree bit for bit), which is how the tests run two ranks on
one machine. Several machines: start each rank with ``LOCAL_RANK`` (its
card) and ``LOCAL_WORLD_SIZE`` (the ranks on its machine) set.
``--out`` writes losses, params (``param_i`` in ``tree_leaves`` order),
the synced memories and the protocol's metrics to an ``.npz`` with the
JAX package's keys.

A rank plans the sharded layout (its own rows) always.

Elastic mode (``--elastic --run-dir DIR``) splits each invocation into a
SUPERVISOR and a re-execed WORKER subprocess (a process group cannot
shrink in place, so recovery needs a fresh process):

  * the worker heartbeats ``DIR/hb_<rank>`` and a watchdog kills it with
    ``EXIT_PEER_LOST`` when a peer's heartbeat goes stale (a gloo or
    NCCL collective with a dead peer may block until ``--timeout``);
  * ``init_process_group`` runs under bounded retries with exponential
    backoff and jitter (``--cluster-retries`` / ``--backoff``), logging
    every attempt; exhaustion exits ``EXIT_UNAVAILABLE``;
  * a worker killed by SIGKILL is treated as a PERMANENTLY lost host
    (simulated preemption): its supervisor marks ``DIR/lost_<rank>`` and
    exits 0;
  * surviving supervisors wait one heartbeat window (refreshing their own
    heartbeat), re-read the survivor set and relaunch workers over a
    re-ranked world on a fresh coordinator port (``base_port +
    attempt``) with ``--resume``: params and AdamW state come back from
    the newest atomic checkpoint in ``DIR/ckpt`` and training continues
    at the next epoch. The partition slots P (processes x
    ``--local-devices``) stay fixed: the survivors take over the lost
    rank's slots, so every epoch plans as before. ``--max-restarts``
    bounds the cycles; exhaustion exits ``EXIT_RETRIES_EXHAUSTED``.

``--run-dir`` without ``--elastic`` checkpoints into ``DIR/ckpt`` every
``--ckpt-every`` epochs, and ``--resume`` restores from there. A worker
writes ``DIR/done_<rank>`` when it finishes cleanly.

Deterministic faults are injected through the ``REPRO_FAULTS``
environment variable (``repro_torch.faults``), e.g.
``REPRO_FAULTS=host_kill@epoch=1,rank=1`` SIGKILLs original rank 1 at the
top of epoch 1; the surviving rank re-forms a one-process world and
finishes the run.
"""

from __future__ import annotations

import argparse
import datetime
import os
import random
import signal
import subprocess
import sys
import threading
import time

EXIT_UNAVAILABLE = 17        # the cluster cannot form at all
EXIT_RETRIES_EXHAUSTED = 18  # elastic restart budget spent
EXIT_PEER_LOST = 23          # a peer died mid-run; supervisor may re-form

_WORKER_ENV = "REPRO_PAC_WORKER"
_RANK_ENV = "REPRO_PAC_ORIG_RANK"


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="pac_cluster",
        description="multi-process PAC training launcher (one per card)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", default="127.0.0.1:12321",
                    help="host:port every process can reach (process 0 "
                         "binds it)")
    ap.add_argument("--local-devices", type=int, default=2,
                    help="partition slots each process holds (the "
                         "partitions it trains as one union step)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda': one card a process, NCCL (raises "
                         "without a card); 'cpu': gloo on the CPU")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--parts", type=int, default=8,
                    help="SEP partitions; > total slots exercises the "
                         "shuffle-combine resync every epoch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-mode", default="latest",
                    choices=["latest", "mean"])
    ap.add_argument("--epoch-boundary", default="overlap",
                    choices=["overlap", "serial"],
                    help="'overlap' runs the shared-node memory sync and "
                         "the loss reads beside the next epoch; 'serial' "
                         "is the bitwise oracle")
    ap.add_argument("--eval-warm", default="memory",
                    choices=["memory", "replay", "restart"],
                    help="where the eval protocol's warm memory comes "
                         "from: PAC's synced memories, a train-split "
                         "replay, or the TIGER-style restarter head")
    ap.add_argument("--out", default="",
                    help="write losses/params/memory/metrics to this .npz")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds any collective (and the rendezvous) may "
                         "wait for the other ranks before it fails")
    # --- fault tolerance ---------------------------------------------
    ap.add_argument("--elastic", action="store_true",
                    help="supervise a re-execed worker: on host loss, "
                         "re-form the world over the survivors and resume "
                         "from the latest checkpoint")
    ap.add_argument("--run-dir", default="",
                    help="shared scratch dir for heartbeats, loss markers "
                         "and checkpoints (required with --elastic)")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint {params, opt_state, states} every "
                         "this many epochs (0 = off; needs --run-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="restore from the newest checkpoint in "
                         "run-dir/ckpt before training")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="elastic re-formation cycles before giving up")
    ap.add_argument("--cluster-retries", type=int, default=3,
                    help="init_process_group attempts")
    ap.add_argument("--backoff", type=float, default=0.5,
                    help="base of the exponential retry backoff, seconds")
    ap.add_argument("--heartbeat-interval", type=float, default=0.25)
    ap.add_argument("--heartbeat-timeout", type=float, default=10.0,
                    help="a peer whose heartbeat is older than this is "
                         "declared lost")
    # internal (set by the supervisor on re-exec)
    ap.add_argument("--orig-rank", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--peers", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


# --- run-dir markers ---------------------------------------------------

def _hb(run_dir, rank):
    return os.path.join(run_dir, f"hb_{rank}")


def _done(run_dir, rank):
    return os.path.join(run_dir, f"done_{rank}")


def _lost(run_dir, rank):
    return os.path.join(run_dir, f"lost_{rank}")


def _touch(path):
    with open(path, "w") as f:
        f.write(f"{time.time()}\n")


def _age(path) -> float:
    try:
        return time.time() - os.path.getmtime(path)
    except OSError:
        return float("inf")


# --- supervisor --------------------------------------------------------

def _supervise(args) -> int:
    """Run (and re-run) the worker subprocess for ONE original rank.

    Every host runs one supervisor; they coordinate purely through the
    shared ``--run-dir`` (heartbeat freshness + ``lost_<rank>`` markers)
    and the deterministic port schedule ``base_port + attempt``: no
    control plane of their own, so a supervisor survives anything short
    of its host dying (which is the case it exists to report)."""
    if not args.run_dir:
        print("ELASTIC: --elastic requires --run-dir", flush=True)
        return 2
    os.makedirs(args.run_dir, exist_ok=True)
    host, _, port_s = args.coordinator.rpartition(":")
    base_port = int(port_s)
    rank = args.process_id
    world = list(range(args.num_processes))
    # keep the number of partition slots (and with it every epoch plan)
    # fixed as the world shrinks: survivors take over the lost rank's
    # slots, so a recovered run follows the undisturbed run's schedule
    total_slots = args.num_processes * args.local_devices
    _touch(_hb(args.run_dir, rank))

    for attempt in range(args.max_restarts + 1):
        slot = world.index(rank)
        cmd = [
            sys.executable, "-m", "repro_torch.launch.pac_cluster",
            "--num-processes", str(len(world)),
            "--process-id", str(slot),
            "--coordinator", f"{host}:{base_port + attempt}",
            "--local-devices", str(total_slots // len(world)),
            "--device", args.device,
            "--epochs", str(args.epochs),
            "--parts", str(args.parts),
            "--seed", str(args.seed),
            "--sync-mode", args.sync_mode,
            "--epoch-boundary", args.epoch_boundary,
            "--eval-warm", args.eval_warm,
            "--timeout", str(args.timeout),
            "--run-dir", args.run_dir,
            "--ckpt-every", str(args.ckpt_every),
            "--cluster-retries", str(args.cluster_retries),
            "--backoff", str(args.backoff),
            "--heartbeat-interval", str(args.heartbeat_interval),
            "--heartbeat-timeout", str(args.heartbeat_timeout),
            "--orig-rank", str(rank),
            "--peers", ",".join(map(str, world)),
        ]
        if args.out:
            cmd += ["--out", args.out]
        if args.resume or attempt > 0:
            cmd.append("--resume")
        env = dict(os.environ)
        env[_WORKER_ENV] = "1"
        env[_RANK_ENV] = str(rank)
        print(f"ELASTIC: attempt {attempt}/{args.max_restarts}: rank "
              f"{rank} -> slot {slot} of world {world} on port "
              f"{base_port + attempt}", flush=True)
        rc = subprocess.Popen(cmd, env=env).wait()

        if rc == 0:
            return 0
        if rc == EXIT_UNAVAILABLE:
            print("ELASTIC: worker reported the cluster unavailable",
                  flush=True)
            return EXIT_UNAVAILABLE
        if rc == -signal.SIGKILL:
            # simulated preemption / OOM-kill: THIS host is the lost one.
            # Mark it permanently dead and bow out cleanly; the survivors
            # re-form without us.
            _touch(_lost(args.run_dir, rank))
            try:
                os.remove(_hb(args.run_dir, rank))
            except OSError:
                pass
            print(f"ELASTIC: rank {rank} HOST_LOST (worker SIGKILLed)",
                  flush=True)
            return 0
        if rc > 0 and rc != EXIT_PEER_LOST:
            return rc  # a real worker bug: don't mask it with retries

        # EXIT_PEER_LOST (or a startup-skew signal): wait one full
        # heartbeat window, refreshing OUR heartbeat so the other
        # survivors keep counting us, then re-read the survivor set.
        delay = max(args.heartbeat_timeout + 2 * args.heartbeat_interval,
                    args.backoff * (2 ** attempt))
        delay += random.uniform(0, args.heartbeat_interval)
        print(f"ELASTIC: rank {rank} worker exited rc={rc}; re-forming "
              f"in {delay:.1f}s", flush=True)
        deadline = time.time() + delay
        while time.time() < deadline:
            _touch(_hb(args.run_dir, rank))
            time.sleep(min(args.heartbeat_interval,
                           max(0.0, deadline - time.time())))
        world = [r for r in world
                 if r == rank or (
                     not os.path.exists(_lost(args.run_dir, r))
                     and _age(_hb(args.run_dir, r)) <
                     args.heartbeat_timeout)]
        print(f"ELASTIC: survivors = {world}", flush=True)

    print(f"ELASTIC: rank {rank} RETRIES_EXHAUSTED after "
          f"{args.max_restarts + 1} attempts", flush=True)
    return EXIT_RETRIES_EXHAUSTED


# --- worker ------------------------------------------------------------

def _start_heartbeat(run_dir: str, rank: int, interval: float) -> None:
    _touch(_hb(run_dir, rank))

    def beat():
        while True:
            time.sleep(interval)
            try:
                _touch(_hb(run_dir, rank))
            except OSError:
                return

    threading.Thread(target=beat, daemon=True).start()


def _start_watchdog(run_dir: str, rank: int, peers: list[int],
                    interval: float, timeout: float) -> None:
    """Kill THIS worker (``EXIT_PEER_LOST``) when a peer stops
    heartbeating without a ``done`` marker: a SIGKILLed peer can leave the
    survivors blocked inside a gloo or NCCL collective until its timeout
    (``--timeout``, 300 s by default), so liveness has to come from
    outside the collective stack."""
    started = time.time()

    def watch():
        while True:
            time.sleep(interval)
            for p in peers:
                if p == rank or os.path.exists(_done(run_dir, p)) \
                        or os.path.exists(_lost(run_dir, p)):
                    continue
                age = _age(_hb(run_dir, p))
                if age > timeout and time.time() - started > timeout:
                    print(f"PEER_LOST: rank {p} heartbeat stale "
                          f"({age:.1f}s) — aborting rank {rank}",
                          flush=True)
                    os._exit(EXIT_PEER_LOST)

    threading.Thread(target=watch, daemon=True).start()


def _init_with_retry(args, backend: str) -> bool:
    """``torch.distributed.init_process_group`` over the coordinator's
    TCP store under bounded retries with exponential backoff and jitter;
    every attempt is logged. Returns False (after printing the
    ``CLUSTER_UNAVAILABLE`` marker) when the retry budget is spent. NCCL
    makes its communicator at the first collective, after
    ``make_tig_mesh`` has checked the ranks against the cards."""
    import torch.distributed as dist

    last = None
    for i in range(max(1, args.cluster_retries)):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{args.coordinator}",
                world_size=args.num_processes, rank=args.process_id,
                timeout=datetime.timedelta(seconds=args.timeout))
            return True
        except Exception as e:  # noqa: BLE001 — every failure retries
            last = e
            print(f"CLUSTER_ATTEMPT {i + 1}/{args.cluster_retries} "
                  f"failed: {type(e).__name__}: {e}", flush=True)
            if dist.is_initialized():
                dist.destroy_process_group()
            if i + 1 < max(1, args.cluster_retries):
                time.sleep(args.backoff * (2 ** i)
                           + random.uniform(0, args.backoff))
    print(f"CLUSTER_UNAVAILABLE: {type(last).__name__}: {last}",
          flush=True)
    return False


def _run(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    orig_rank = args.orig_rank if args.orig_rank >= 0 else args.process_id
    peers = [int(p) for p in args.peers.split(",") if p != ""]
    if args.run_dir:
        os.makedirs(args.run_dir, exist_ok=True)
        _start_heartbeat(args.run_dir, orig_rank, args.heartbeat_interval)
    if args.device == "cpu":
        # multi-threaded CPU reductions differ run to run; one thread
        # keeps every rank's (and every run's) arithmetic the same
        torch.set_num_threads(1)
    else:
        resolve_device("cuda")          # no card: raise, never fall back
    if not _init_with_retry(args, "gloo" if args.device == "cpu"
                            else "nccl"):
        return EXIT_UNAVAILABLE
    if args.run_dir and len(peers) > 1:
        _start_watchdog(args.run_dir, orig_rank, peers,
                        args.heartbeat_interval, args.heartbeat_timeout)

    from repro_torch.core import sep_partition
    from repro_torch.faults import HostLossError, is_host_loss
    from repro_torch.launch.mesh import local_part_ranks, make_tig_mesh
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.graph import chronological_split
    from repro_torch.tig.models import TIGConfig
    from repro_torch.tree import tree_leaves

    g = synthetic_tig("tiny", seed=args.seed)
    train_g = chronological_split(g)[0]
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, batch_size=50)
    part = sep_partition(train_g.src, train_g.dst, train_g.t,
                         g.num_nodes, args.parts, k=0.05)
    ckpt_dir = os.path.join(args.run_dir, "ckpt") if args.run_dir else None
    mesh = make_tig_mesh(args.num_processes * args.local_devices)
    try:
        res = pac_train(
            train_g, part, cfg, num_devices=mesh.num_parts,
            epochs=args.epochs, seed=args.seed, shuffle_parts=True,
            sync_mode=args.sync_mode, mesh=mesh, plan="device",
            epoch_boundary=args.epoch_boundary, eval_graph=g,
            eval_warm=args.eval_warm, ckpt_dir=ckpt_dir,
            ckpt_every=args.ckpt_every if ckpt_dir else 0,
            resume=args.resume and ckpt_dir is not None)
    except HostLossError as e:
        # the group is broken: leave it to the process's exit
        print(f"PEER_LOST: {e}", flush=True)
        return EXIT_PEER_LOST
    except Exception as e:  # noqa: BLE001 — classified below
        if args.num_processes > 1 and is_host_loss(e):
            print(f"PEER_LOST: {type(e).__name__}: {e}", flush=True)
            return EXIT_PEER_LOST
        dist.destroy_process_group()
        raise

    if args.out:
        payload = {}
        for e, losses in enumerate(res.losses):
            payload[f"loss_{e}"] = np.asarray(losses)
        # tree_leaves order is the JAX package's (sorted keys)
        for i, leaf in enumerate(tree_leaves(res.params)):
            payload[f"param_{i}"] = leaf.detach().cpu().numpy()
        for key in ("mem", "mem2", "last"):
            payload[f"state_{key}"] = \
                res.memory_states[key].detach().cpu().numpy()
        for key, val in sorted((res.metrics or {}).items()):
            payload[f"metric_{key}"] = np.asarray(val)
        np.savez(args.out, **payload)

    print(f"pac_cluster done: process {dist.get_rank()}"
          f"/{dist.get_world_size()}, partitions {mesh.num_parts} "
          f"(held {local_part_ranks(mesh).tolist()}), backend "
          f"{dist.get_backend()}", flush=True)
    if args.run_dir:
        _touch(_done(args.run_dir, orig_rank))
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = _parse(argv)
    if args.elastic and os.environ.get(_WORKER_ENV) != "1":
        return _supervise(args)
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
