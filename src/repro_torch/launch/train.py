"""The training CLI, as ``repro/launch/train.py``: ``--arch speed-tig``
runs the paper's pipeline, synthetic TIG -> SEP partitioning -> PAC
training -> downstream evaluation (link prediction and node
classification), printed line for line as the JAX package prints it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch speed-tig \\
        --dataset small --devices 4 --parts 8 --topk 0.05 --epochs 3

``--device`` is ``cuda`` by default (raises without a card); ``--device
cpu`` runs the plain PyTorch versions. ``--shard-map`` runs PAC over a
one-process group (gloo on the CPU, NCCL on the card) through
``launch.mesh.make_tig_mesh``; several processes are
``launch.pac_cluster``'s. The JAX CLI's ``--grid-layout`` is not an
option (the port's ``pac_train`` plans the sharded layout over a mesh
and the replicated one without), nor are its LM flags (``--reduced``,
``--steps``, ``--seq``, ``--log-every``, ``--ckpt-dir``,
``--ckpt-every``): the LM pretraining of its other ``--arch`` values is
not ported yet, and they raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
import time

__all__ = ["main", "train_tig"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_tig(args) -> None:
    import torch.distributed as dist

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.core import partition_stats, sep_partition
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_tig_mesh
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.graph import chronological_split
    from repro_torch.tig.train import evaluate_params

    device = resolve_device(args.device)
    g = synthetic_tig(args.dataset, seed=args.seed)
    print(f"dataset: {g.stats()}")
    train_g = chronological_split(g)[0]

    t0 = time.perf_counter()
    part = sep_partition(train_g.src, train_g.dst, train_g.t,
                         g.num_nodes, args.parts, k=args.topk)
    print(f"SEP: {partition_stats(part)}")

    cfg = dataclasses.replace(
        TIG, dim=args.dim, dim_edge=g.dim_edge, dim_node=g.dim_node,
        dim_time=min(args.dim, 64), batch_size=args.batch,
        flavor=args.flavor)
    mesh = None
    if args.shard_map:
        dist.init_process_group(
            "gloo" if device.type == "cpu" else "nccl",
            init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
            rank=0)
        mesh = make_tig_mesh(args.devices)
    try:
        res = pac_train(train_g, part, cfg, num_devices=args.devices,
                        epochs=args.epochs, lr=args.lr, mesh=mesh,
                        device=device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    print(f"PAC: derived speedup {res.derived_speedup:.2f}x, "
          f"edges/device {res.edges_per_device.tolist()}, "
          f"losses {res.mean_loss_per_epoch().round(4).tolist()}")
    ev = evaluate_params(g, cfg, res.params, eval_node_class=True,
                         device=device)
    print(f"eval: {ev}")
    print(f"total {time.perf_counter() - t0:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="'cuda' (raises without a card) or 'cpu'")
    # TIG options
    ap.add_argument("--dataset", default="small")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--topk", type=float, default=0.05)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--flavor", default="tgn",
                    choices=["jodie", "dyrep", "tgn", "tige"])
    ap.add_argument("--shard-map", action="store_true",
                    help="PAC over a one-process group (make_tig_mesh); "
                         "several processes: launch.pac_cluster")
    ap.add_argument("--batch", type=int, default=100)
    args = ap.parse_args(argv)
    if args.arch != "speed-tig":
        raise ValueError(f"--arch {args.arch}: LM pretraining is not ported "
                         f"to repro_torch yet (only --arch speed-tig is)")
    train_tig(args)


if __name__ == "__main__":
    main()
