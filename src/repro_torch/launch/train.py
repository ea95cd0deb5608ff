"""The training CLI, as ``repro/launch/train.py``: ``--arch speed-tig``
runs the paper's pipeline, synthetic TIG -> SEP partitioning -> PAC
training -> downstream evaluation (link prediction and node
classification), printed line for line as the JAX package prints it;
any other ``--arch`` pretrains that language model on the synthetic
token corpus (``train_lm``: ``data.packed_batches``, AdamW with a linear
warm-up and cosine decay, ``models.make_train_step``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch speed-tig \\
        --dataset small --devices 4 --parts 8 --topk 0.05 --epochs 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 200 --batch 8 --seq 128

``--device`` is ``cuda`` by default (raises without a card); ``--device
cpu`` runs the plain PyTorch versions. ``--shard-map`` runs PAC over a
one-process group (gloo on the CPU, NCCL on the card) through
``launch.mesh.make_tig_mesh``; several processes are
``launch.pac_cluster``'s. The JAX CLI's ``--grid-layout`` is not an
option (the port's ``pac_train`` plans the sharded layout over a mesh
and the replicated one without). ``--lr`` and ``--batch`` default as in
the JAX package: 1e-3 and 100 for ``speed-tig``, 3e-3 and 8 for a
language model. On the card RWKV6 and hymba raise (their kernels have no
backward yet); the encoder-decoder raises on both devices, for its
batches need frames, which ``packed_batches`` does not make (nor does
the JAX package's).
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
import time

__all__ = ["main", "train_tig", "train_lm"]


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


def train_lm(args) -> None:
    """LM pretraining on the synthetic corpus, printed as the JAX
    package's ``train_lm`` prints it; checkpoints of the params every
    ``--ckpt-every`` steps and at the end with ``--ckpt-dir``."""
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.data import LMDataConfig, packed_batches
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.tree import tree_leaves

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.enc_dec:
        raise ValueError(
            f"--arch {args.arch}: LM pretraining of an encoder-decoder is "
            f"not ported to train_lm: its batches need frames, which "
            f"packed_batches does not make (nor does the JAX package's); "
            f"train it through models.make_train_step with a batch that "
            f"holds them")
    device = resolve_device(args.device)
    dcfg = LMDataConfig(vocab=cfg.vocab, seq_len=args.seq or 128,
                        global_batch=args.batch or 8, seed=args.seed)
    params = init_params(torch.Generator(device=device).manual_seed(
        args.seed), cfg, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{n_params/1e6:.2f}M params, seq={dcfg.seq_len}, "
          f"batch={dcfg.global_batch}")

    opt = adamw(lr=linear_warmup_cosine(args.lr, 20, args.steps),
                weight_decay=0.1, max_grad_norm=1.0)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, device=device)

    data = packed_batches(dcfg)
    t0 = time.perf_counter()
    tokens_seen = 0
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        tokens_seen += dcfg.global_batch * dcfg.seq_len
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"tok/s {tokens_seen/dt:,.0f}")
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step, params)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, params)
        print(f"saved final checkpoint to {args.ckpt_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test-sized config of an LM arch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=None)
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
    # LM options
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    args = ap.parse_args(argv)
    if args.arch == "speed-tig":
        args.lr = args.lr or 1e-3
        args.batch = args.batch or 100
        train_tig(args)
    else:
        args.lr = args.lr or 3e-3
        train_lm(args)


if __name__ == "__main__":
    main()
