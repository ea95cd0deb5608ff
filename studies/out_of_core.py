#!/usr/bin/env python3
"""Probes of the out-of-core slice on one NVIDIA GPU, beside
``chip_smoke.py`` phase 5c.

    python3 studies/out_of_core.py pac --src src --epochs 2
    python3 studies/out_of_core.py pac --src <another checkout>/src --epochs 1
    python3 studies/out_of_core.py head
    python3 studies/out_of_core.py memory --src src

``pac``: ``pac_train`` on ``synthetic_tig("wikipedia-s", scale=10)``'s
train split at the ``TIG`` widths, SEP parts (P 4, and P 2 with
``--epochs 2``), with prefetching off and on in turns (three rounds at
two epochs, four at one, after a warm-up run at one epoch); each run
prints its epoch seconds and the wait for each plan. ``--src`` points at
the ``src`` of the checkout to import (another commit's, to compare in
one call); a checkout whose ``pac_train`` has no ``prefetch`` runs with
its defaults.

``head``: ``train_single(eval_node_class=True)`` of a narrow TGN on
``tiny`` and ``small`` (labels: each edge's source parity; node
features that carry the label at separations 0, 0.25, 0.5, 1), on the
card and on the CPU from the same params: each run's AUROC, the
collected test embeddings' difference, the head trained on the same
embeddings on both, and on labels the embeddings carry (their first
coordinate above its median).

``memory``: ``train_single`` on ``tiny`` four times, then three epoch
programs made, called once and dropped; device memory allocated after
each (after ``gc.collect``), and the scoring programs' cached graphs.

Needs a card and the repository's ``src``; it imports no JAX.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time


def _narrow(tig_config, dim_edge: int):
    return tig_config(flavor="tgn", dim=16, dim_time=8, dim_edge=dim_edge,
                      dim_node=dim_edge, num_neighbors=4, n_heads=2,
                      batch_size=50)


def pac(epochs: int, src: str) -> None:
    import inspect

    import torch

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.core import sep_partition
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.graph import chronological_split

    g = synthetic_tig("wikipedia-s", scale=10.0)
    tr = chronological_split(g)[0]
    modes = [dict(prefetch=False), dict(prefetch=True)]
    if "prefetch" not in inspect.signature(pac_train).parameters:
        modes = [{}, {}]
    parts = (4, 2) if epochs > 1 else (4,)
    for p in parts:
        part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, p, k=0.05)
        if epochs == 1:
            pac_train(tr, part, TIG, num_devices=p, epochs=1, eval_graph=g)
        for _ in range(3 if epochs > 1 else 4):
            for kw in modes:
                t0 = time.perf_counter()
                r = pac_train(tr, part, TIG, num_devices=p, epochs=epochs,
                              eval_graph=g, **kw)
                torch.cuda.synchronize()
                print(f"{src} P {p} {epochs} epochs {kw}: epoch_seconds "
                      f"{[round(x, 4) for x in r.epoch_seconds]} plan "
                      f"{[round(x, 4) for x in r.plan_seconds]} wall "
                      f"{time.perf_counter() - t0:.3f}", flush=True)


def head() -> None:
    import numpy as np
    import torch

    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.models import TIGConfig, init_params, init_state
    from repro_torch.tig.protocol import (score_stream, split_views,
                                          train_classifier_head)
    from repro_torch.tig.train import epoch_rng, train_single

    def tree_to(t, dev):
        if isinstance(t, dict):
            return {k: tree_to(v, dev) for k, v in t.items()}
        return t.detach().to(dev, copy=True)

    for name in ("tiny", "small"):
        cfg = _narrow(TIGConfig, 16 if name == "tiny" else 32)
        p0 = init_params(torch.Generator().manual_seed(0), cfg)
        for sep in (0.0, 0.25, 0.5, 1.0):
            g = synthetic_tig(name)
            lab = np.arange(g.num_nodes) % 2
            g.labels = lab[g.src].astype(np.int64)
            if sep:
                g.node_feat = (np.random.default_rng(0).normal(
                    size=g.node_feat.shape) + sep * (2 * lab[:, None] - 1)
                ).astype(np.float32)
            runs = {dev: train_single(g, cfg, epochs=2, params=p0,
                                      eval_node_class=True, device=dev)
                    for dev in ("cuda", "cpu")}
            sp = split_views(g)
            prog, _ = build_batch_program(sp.test, cfg, epoch_rng(0, 0, 3),
                                          neg_pool=sp.neg_pool)
            res = {}
            for dev in ("cuda", "cpu"):
                tables = {k: torch.from_numpy(v).to(dev) for k, v in
                          make_tables(g.edge_feat, g.node_feat).items()}
                res[dev] = score_stream(
                    tree_to(runs["cpu"].params, dev), cfg,
                    init_state(cfg, g.num_nodes, dev), prog, tables,
                    collect_embeddings=True, device=dev)
            emb, labels = res["cpu"]["embeddings"], res["cpu"]["labels"]
            learnable = (emb[:, 0] > np.median(emb[:, 0])).astype(np.int64)
            same = [train_classifier_head(emb, labels, 2, device=dev)
                    for dev in ("cuda", "cpu")]
            carried = [train_classifier_head(emb, learnable, 2, device=dev)
                       for dev in ("cuda", "cpu")]
            auc = [runs[dev].node_auroc for dev in ("cuda", "cpu")]
            print(f"{name} sep {sep}: train_single node_auroc card "
                  f"{auc[0]:.6f} cpu {auc[1]:.6f} diff "
                  f"{abs(auc[0] - auc[1]):.2e}; emb diff "
                  f"{np.abs(res['cuda']['embeddings'] - emb).max():.2e}; "
                  f"head same emb {same[0]:.6f} {same[1]:.6f} diff "
                  f"{abs(same[0] - same[1]):.2e}; learnable labels "
                  f"{carried[0]:.6f} {carried[1]:.6f} diff "
                  f"{abs(carried[0] - carried[1]):.2e}", flush=True)


def memory(src: str) -> None:
    import torch

    from repro_torch.optim import adamw
    from repro_torch.tig import engine
    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.models import TIGConfig, init_params, init_state
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.train import epoch_rng, train_single

    g = synthetic_tig("tiny")
    cfg = _narrow(TIGConfig, 16)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)

    def allocated() -> str:
        gc.collect()
        torch.cuda.synchronize()
        return (f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB "
                f"allocated")

    for i in range(4):
        train_single(g, cfg, epochs=1, params=p0)
        graphs = {str(k[1:]): len(p.graphs)
                  for k, p in engine._EVAL_PROGRAMS.items()}
        print(f"{src} train_single {i}: {allocated()}, "
              f"{torch.cuda.memory_reserved() / 2**20:.1f} reserved, "
              f"scoring graphs {graphs}", flush=True)
    sp = split_views(g)
    prog, _ = build_batch_program(sp.train, cfg, epoch_rng(0, 0, 1),
                                  neg_pool=sp.neg_pool)
    for i in range(3):
        opt = adamw(lr=1e-3)
        fn = engine.make_train_epoch(cfg, opt)
        tables = {k: torch.from_numpy(v).cuda() for k, v in
                  make_tables(g.edge_feat, g.node_feat).items()}
        params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
        fn(params, opt.init(params), init_state(cfg, g.num_nodes, "cuda"),
           prog, tables)
        del fn, tables
        print(f"{src} epoch program {i}, called and dropped: "
              f"{allocated()}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("pac", "head", "memory"))
    ap.add_argument("--src", default="src",
                    help="the checkout's src directory to import")
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("out_of_core: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.build import build_all

    build_all()
    if args.probe == "pac":
        pac(args.epochs, args.src)
    elif args.probe == "head":
        head()
    else:
        memory(args.src)
    return 0


if __name__ == "__main__":
    sys.exit(main())
