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

Not ported yet (they raise): the elastic supervisor (``--elastic``), its
run directory with checkpoints and heartbeats (``--run-dir``),
``--resume`` and the overlapped epoch boundary. The JAX launcher's knobs
of those (``--ckpt-every``, ``--max-restarts``, ``--heartbeat-*``) are
not accepted until they are ported. A rank plans the sharded layout
(its own rows) always.
"""

from __future__ import annotations

import argparse
import datetime
import random
import sys
import time

EXIT_UNAVAILABLE = 17        # the cluster cannot form at all


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
    ap.add_argument("--epoch-boundary", default="serial",
                    choices=["serial"],
                    help="'serial' only: the overlapped boundary is not "
                         "ported yet")
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
    # --- fault tolerance (not ported yet) -----------------------------
    ap.add_argument("--elastic", action="store_true",
                    help="supervise a re-execed worker (not ported yet)")
    ap.add_argument("--run-dir", default="",
                    help="shared scratch dir for heartbeats and "
                         "checkpoints (not ported yet)")
    ap.add_argument("--resume", action="store_true",
                    help="restore from the newest checkpoint (not ported "
                         "yet)")
    ap.add_argument("--cluster-retries", type=int, default=3,
                    help="init_process_group attempts")
    ap.add_argument("--backoff", type=float, default=0.5,
                    help="base of the exponential retry backoff, seconds")
    return ap.parse_args(argv)


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

    for flag, on in (("--elastic", args.elastic), ("--run-dir",
                                                   args.run_dir),
                     ("--resume", args.resume)):
        if on:
            raise ValueError(f"{flag} (the elastic supervisor and PAC's "
                             f"checkpoints) is not ported to repro_torch "
                             f"yet")
    if args.device == "cpu":
        # multi-threaded CPU reductions differ run to run; one thread
        # keeps every rank's (and every run's) arithmetic the same
        torch.set_num_threads(1)
    else:
        resolve_device("cuda")          # no card: raise, never fall back
    if not _init_with_retry(args, "gloo" if args.device == "cpu"
                            else "nccl"):
        return EXIT_UNAVAILABLE

    from repro_torch.core import sep_partition
    from repro_torch.launch.mesh import local_part_ranks, make_tig_mesh
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.graph import chronological_split
    from repro_torch.tig.models import TIGConfig
    from repro_torch.tree import tree_leaves

    try:
        g = synthetic_tig("tiny", seed=args.seed)
        train_g = chronological_split(g)[0]
        cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                        dim_node=16, num_neighbors=4, batch_size=50)
        part = sep_partition(train_g.src, train_g.dst, train_g.t,
                             g.num_nodes, args.parts, k=0.05)
        mesh = make_tig_mesh(args.num_processes * args.local_devices)
        res = pac_train(
            train_g, part, cfg, num_devices=mesh.num_parts,
            epochs=args.epochs, seed=args.seed, shuffle_parts=True,
            sync_mode=args.sync_mode, mesh=mesh, plan="device",
            epoch_boundary=args.epoch_boundary, eval_graph=g,
            eval_warm=args.eval_warm)

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
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    return _run(_parse(argv))


if __name__ == "__main__":
    sys.exit(main())
