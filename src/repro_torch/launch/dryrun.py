"""The dry run: cost every architecture's real program on one card with no
hardware, the counterpart of ``repro/launch/dryrun.py``.

For every (architecture x input shape) this builds the FULL param tree on
the ``meta`` device (shapes only, the counterpart of
``jax.eval_shape(init_params)``) and runs the real program once under the
step cost counter (``roofline.op_cost.OpCost``), with no allocation:

* ``train``: ``models.make_train_step`` with AdamW, ``remat`` on;
* ``prefill``: ``models.forward`` with the params cast to bf16, as the
  JAX dry run casts them;
* ``decode``: ``models.serve_step`` on an ``init_cache`` of the shape's
  length (``ENC_LEN_DECODE`` frames of encoder memory for seamless).

The kernels take their meta route (``kernels/meta.py``), which counts each
as its JAX counterpart. ``long_500k`` runs only where the config is
sub-quadratic (``ArchConfig.sub_quadratic``). One card: the batch is the JAX dry run's
share of one chip of 256, ``max(global_batch // 256, 1)`` (1 for every
shape), the report's mesh ``"h100x1"``. Beside the roofline report:

* ``state_bytes``: the params, plus their gradients and AdamW's two
  moments for ``train``, plus the cache for ``decode``;
* ``saved_bytes``: the distinct storages autograd saves for the backward
  (a ``saved_tensors_hooks`` tally; the state's own excluded). Under
  ``remat`` each layer's checkpoint holds its inputs outside that tally;
* ``fits_one_card``: their sum under 80 GiB less 2 GiB of headroom.

``speed-tig`` is one rank's PAC step (the first of 8 lockstep steps) at
the JAX dry run's per-chip sizes (``dryrun_speed_tig``: DGraphFin's
4,889,537 nodes and 4,300,999 edges over 256 partitions), on ``meta``:
every op of the step allows it. There is no process group on ``meta``,
so the gradient all-reduce over 256 ranks is counted where
``_PACEpoch._reduce`` makes it (the flat buffer's cat and split run, the
all-reduce is added as the counter would count it), and the epoch-end
shared-node sync comes from ``kernel_bytes.pac_sync_bytes``.

One JSON per combination goes under ``experiments/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k --no-save
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--batch N] [--no-save]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, get_config, list_archs
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.roofline.analysis import MESH, MODEL_FLOPS, roofline_report
from repro_torch.roofline.kernel_bytes import pac_sync_bytes
from repro_torch.roofline.op_cost import OpCost
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ENC_LEN_DECODE", "CARD_BYTES", "HEADROOM",
           "OUT_DIR", "default_batch", "input_batch", "dryrun_one",
           "train_state_bytes", "dryrun_speed_tig", "lm_state", "count_lm_train_step",
           "count_tig_step", "tig_step_inputs", "on_meta", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

ENC_LEN_DECODE = 4096       # fixed encoder memory for seamless decode
CARD_BYTES = 80 * 2 ** 30   # one H100's HBM
HEADROOM = 2 * 2 ** 30      # left for the allocator, workspaces, context
# the JAX dry run's chip count: its per-chip batch share is one card's
JAX_CHIPS = 256


def default_batch(shape) -> int:
    return max(shape.global_batch // JAX_CHIPS, 1)


def on_meta(tree):
    """A tensor tree's shapes and dtypes on the ``meta`` device (other
    leaves as they are)."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return torch.empty_like(x, device="meta")
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return x
    return one(tree)


def _storages(tree) -> set:
    return {x.untyped_storage()._cdata for x in tree_leaves(tree)}


class _SavedTally:
    """Bytes of the distinct storages autograd saves (``exclude``:
    storages not to count, the state's)."""

    def __init__(self, exclude: set):
        self.exclude, self.seen, self.bytes = set(exclude), set(), 0

    def pack(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.exclude and key not in self.seen:
            self.seen.add(key)
            self.bytes += st.nbytes()
        return t

    @staticmethod
    def unpack(t):
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        self.unpack)


def input_batch(cfg, kind: str, batch: int, seq: int, device="meta",
                enc_len: int = ENC_LEN_DECODE) -> dict:
    """The program's inputs, as the JAX dry run's ``input_specs``:
    tokens / targets (B, S) for ``train`` / ``prefill`` (seamless adds
    (B, S, d) frames; Qwen2-VL (B, F, d) patches, (B, 3, S) positions and
    S - F tokens); one token and its position (B,) for ``decode``."""
    i32, bf16 = torch.int32, torch.bfloat16

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind == "decode":
        return {"token": z((batch,), i32), "pos": z((batch,), i32)}
    out = {}
    if cfg.enc_dec:
        out["frames"] = z((batch, seq, cfg.d_model), bf16)
    if cfg.frontend == "vision":
        f = cfg.frontend_tokens
        out["patches"] = z((batch, f, cfg.d_model), bf16)
        out["positions3"] = z((batch, 3, seq), i32)
        seq -= f
    out["tokens"] = z((batch, seq), i32)
    out["targets"] = z((batch, seq), i32)
    return out


def lm_state(cfg, device="meta") -> dict:
    """The FULL float32 param tree of ``cfg`` (on ``meta``: shapes only,
    nothing drawn)."""
    return M.init_params(torch.Generator(), cfg, device=device)


def _train_opt():
    return adamw(lr=1e-4)


def train_state_bytes(cfg) -> int:
    """Bytes of training ``cfg`` on one card with AdamW: its float32
    params, their gradients and the two moments, 16 a param."""
    return 4 * _bytes(lm_state(cfg))


def count_lm_train_step(cfg, params, opt, opt_state, batch, device):
    """One ``make_train_step`` step of ``cfg`` on ``device`` under the
    counter, with the saved tensors tallied. Returns (OpCost, saved
    bytes)."""
    tally = _SavedTally(_storages(params) | _storages(opt_state))
    step = M.make_train_step(cfg, opt, device=device)
    with OpCost() as cost, tally.hooks():
        step(params, opt_state, batch)
    return cost, tally.bytes


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _run_lm(cfg, kind: str, batch: int, seq: int) -> tuple:
    """(cost, state bytes, saved bytes, model FLOPs, tokens) of one
    program of ``cfg`` on ``meta``."""
    params = lm_state(cfg)
    n_active = cfg.active_param_count()
    if kind == "train":
        opt = _train_opt()
        opt_state = opt.init(params)
        cost, saved = count_lm_train_step(
            cfg, params, opt, opt_state, input_batch(cfg, kind, batch, seq),
            "meta")
        return cost, 4 * _bytes(params), saved, MODEL_FLOPS(
            n_active, batch * seq, "train"), batch * seq
    params = tree_map(lambda x: x.to(torch.bfloat16), params)
    if kind == "prefill":
        with torch.no_grad(), OpCost() as cost:
            M.forward(params, input_batch(cfg, kind, batch, seq), cfg,
                      device="meta")
        return cost, _bytes(params), 0, MODEL_FLOPS(
            n_active, batch * seq, "infer"), batch * seq
    cache = M.init_cache(cfg, batch, seq, device="meta",
                         enc_len=ENC_LEN_DECODE if cfg.enc_dec else 0)
    with torch.no_grad(), OpCost() as cost:
        M.serve_step(params, cache, input_batch(cfg, kind, batch, seq), cfg,
                     device="meta")
    return cost, _bytes(params) + _bytes(cache), 0, MODEL_FLOPS(
        n_active, batch, "infer"), batch


def _finish(out: dict, cost: OpCost, name: str, save: bool,
            verbose: bool) -> dict:
    out["kernels"] = {k: list(v) for k, v in cost.kernels.items()}
    out["status"] = "ok"
    if verbose:
        gib = 2 ** 30
        print(f"[{out['arch']} x {out['shape']} x {MESH}] counted in "
              f"{out['seconds']:.1f} s: flops {out['hlo_flops']:.4e} bytes "
              f"{out['hlo_bytes']:.4e} coll {out['collective_bytes']:.4e}; "
              f"terms compute {out['compute_s'] * 1e3:.3f} ms memory "
              f"{out['memory_s'] * 1e3:.3f} ms collective "
              f"{out['collective_s'] * 1e3:.3f} ms -> {out['dominant']}-"
              f"bound; useful {out['useful_ratio']:.2f}; state "
              f"{out['state_bytes'] / gib:.1f} GiB + saved "
              f"{out['saved_bytes'] / gib:.1f} GiB -> "
              f"{'fits' if out['fits_one_card'] else 'does not fit'} one "
              f"card")
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        with open(OUT_DIR / f"{name}.json", "w") as f:
            json.dump(out, f, indent=1)
    return out


def dryrun_one(arch: str, shape_name: str, *, batch=None, seq=None,
               layers=None, dtype=None, save: bool = True,
               verbose: bool = True) -> dict:
    """The dry run of one (arch, shape): the report's fields, the memory
    fields and the kernel scopes' counts. ``seq`` / ``layers`` /
    ``dtype`` replace the shape's length, the config's depth and its
    compute dtype (the card's training paths: a depth cut, float32)."""
    if arch == "speed-tig":
        return dryrun_speed_tig(save=save, verbose=verbose)
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": shape_name,
                "status": "skipped (full attention)"}
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    b = default_batch(shape) if batch is None else batch
    s = shape.seq_len if seq is None else seq
    t0 = time.perf_counter()
    cost, state, saved, mflops, tokens = _run_lm(cfg, shape.kind, b, s)
    report = roofline_report(
        cost, arch=arch, shape=shape_name, model_flops=mflops,
        dtype=cfg.dtype,
        peak_memory=float(state + saved),
        note=f"batch={b} seq={s} layers={cfg.n_layers} dtype={cfg.dtype} "
             f"kind={shape.kind} remat={cfg.remat} on meta")
    out = report.to_json() | {
        "seconds": time.perf_counter() - t0, "batch": b, "seq": s,
        "layers": cfg.n_layers, "dtype": cfg.dtype, "tokens": tokens,
        "state_bytes": state, "saved_bytes": saved,
        "fits_one_card": state + saved < CARD_BYTES - HEADROOM}
    suffix = "" if layers is None else f"_l{layers}"
    suffix += "" if dtype is None else f"_{dtype}"
    return _finish(out, cost, f"{arch}_{shape_name}{suffix}_{MESH}", save,
                   verbose)


# ------------------------------------------------------------- speed-tig

def tig_step_inputs(g, cfg, device, seed: int = 0) -> dict:
    """The first training step of ``train_single(g, cfg)`` with the device
    plan: its (1, B) program, the feature tables, the staged train
    T-CSR, params from ``seed``, AdamW (clip 1.0) and fresh state."""
    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.models import init_params, init_state
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.sampler import ChronoNeighborIndex
    from repro_torch.tig.train import _stage_tcsr, epoch_rng

    splits = split_views(g)
    tr = splits.train
    index = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes,
                                cfg.num_neighbors, cfg.batch_size)
    prog, _ = build_batch_program(tr, cfg, epoch_rng(seed, 0, 1),
                                  neg_pool=splits.neg_pool, index=index,
                                  plan="device")
    opt = adamw(lr=1e-3, max_grad_norm=1.0)
    params = init_params(torch.Generator().manual_seed(seed), cfg, device)
    return {"opt": opt, "params": params, "opt_state": opt.init(params),
            "state": init_state(cfg, g.num_nodes, device),
            "batches": {k: v[:1] for k, v in prog.items()},
            "tables": {k: torch.from_numpy(v).to(device) for k, v in
                       make_tables(g.edge_feat, g.node_feat).items()},
            "tcsr": _stage_tcsr(index, cfg, device)}


def count_tig_step(cfg, inputs: dict, device) -> OpCost:
    """One eager step of the TIG epoch engine (``engine._Epoch.step``,
    what ``train_single``'s captured graph replays) on ``device`` under
    the counter. ``inputs`` as ``tig_step_inputs`` makes them (on
    ``meta``: ``on_meta`` of them, the numpy program as it is)."""
    from repro_torch.tig import engine

    epoch = engine._Epoch(cfg, inputs["opt"], inputs["params"],
                          inputs["opt_state"], inputs["state"],
                          inputs["batches"], inputs["tables"], None,
                          torch.device(device))
    # the T-CSR is set after construction: ``check_depth`` reads its
    # front pad, a value, and the caller's export has the model's depth
    engine.check_depth(None if torch.device(device).type == "meta"
                       else inputs["tcsr"], cfg)
    epoch.tcsr = inputs["tcsr"]
    with OpCost() as cost:
        epoch.step()
    return cost


def dryrun_speed_tig(*, n_parts: int = JAX_CHIPS, save: bool = True,
                     verbose: bool = True) -> dict:
    """One rank's PAC step at ``dryrun_speed_tig``'s per-chip sizes, on
    ``meta`` (see the module's docstring)."""
    from repro_torch.configs.speed_tig import TIG
    from repro_torch.tig import distributed
    from repro_torch.tig.models import init_params

    cfg = TIG
    capacity = 4_889_537 // n_parts + 1
    steps = 8
    b, k = cfg.batch_size, cfg.num_neighbors
    n_edges = 4_300_999
    e_cap = n_edges // n_parts + n_parts
    ev_cap = 2 * e_cap + k * cfg.n_layers
    n_shared = int(0.01 * 4_889_537)
    z = np.zeros
    batches = {"src": z((steps, b), np.int32), "dst": z((steps, b), np.int32),
               "neg": z((steps, b), np.int32), "t": z((steps, b), np.float32),
               "eidx": z((steps, b), np.int32),
               "valid": np.ones((steps, b), bool)}
    union = {"parts": 1, "capacity": capacity, "steps": steps,
             "batches": batches, "offsets": z((1,), np.int32),
             "n_batches": np.full((1,), steps, np.int32),
             "host_replay": False, "tcsr": None,
             "nfeat": torch.empty((capacity + 1, cfg.dim_node),
                                  device="meta"),
             "efeat": torch.empty((e_cap + 1, cfg.dim_edge), device="meta")}
    opt = adamw(lr=1e-4, max_grad_norm=1.0)
    params = on_meta(init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu"))

    class RankStep(distributed._PACEpoch):
        """One rank of ``n_parts``: its gradient all-reduce counted at
        ``_reduce`` (the flat buffer's cat and split run; the all-reduce
        is added as the counter counts one)."""

        def _reduce(self, grads):
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.cost.add_collective("all-reduce", flat)
            return [x.view(g.shape) for x, g in
                    zip(flat.split([g.numel() for g in grads]), grads)]

    t0 = time.perf_counter()
    ep = RankStep(cfg, opt, params, opt.init(params), union,
                  torch.device("meta"))
    ep.tcsr = {"indptr": torch.empty((capacity + 1,), dtype=torch.int32,
                                     device="meta")} | {
        key: torch.empty((ev_cap,), dtype=dt, device="meta")
        for key, dt in (("nbr", torch.int32), ("t", torch.float32),
                        ("eidx", torch.int32), ("bat", torch.int32))}
    with OpCost() as cost:
        ep.cost = cost
        ep.step()
    sync = pac_sync_bytes(n_shared, cfg.dim, n_parts)
    state = _bytes(ep.params) * 2 + _bytes(ep.opt_state) + _bytes(
        ep.state) + _bytes(ep.backup) + _bytes(ep.tables) + _bytes(
        ep.tcsr) + _bytes(ep.batches)
    report = roofline_report(
        cost, arch="speed-tig", shape="pac_step", model_flops=0.0,
        dtype="float32", peak_memory=float(state),
        note=f"one rank of {n_parts}: PAC step 1 of {steps} lockstep steps, "
             f"batch {b}, capacity {capacity} nodes, {e_cap} edges, "
             f"{ev_cap} T-CSR events, {n_shared} shared nodes; the gradient "
             f"all-reduce counted at _PACEpoch._reduce, on meta")
    out = report.to_json() | {
        "seconds": time.perf_counter() - t0, "capacity": capacity,
        "e_cap": e_cap, "ev_cap": ev_cap, "steps": steps,
        "n_shared": n_shared, "state_bytes": state, "saved_bytes": 0,
        "fits_one_card": state < CARD_BYTES - HEADROOM,
        "sync_bytes_per_epoch": sync["per_device"]}
    return _finish(out, cost, f"speed-tig_pac_step_{MESH}", save, verbose)


# ------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Cost every architecture's program on one card, on the "
                    "meta device (no allocation).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences a step (default: the JAX dry run's "
                         "share of one chip, 1)")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() + ["speed-tig"] if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    combos = []
    for a in archs:
        if a == "speed-tig":
            combos.append((a, "pac_step"))
            continue
        combos += [(a, s) for s in shapes]

    failures = []
    for a, s in combos:
        try:
            r = dryrun_one(a, s, batch=args.batch, save=not args.no_save)
            if r.get("status", "").startswith("skip"):
                print(f"[{a} x {s}] {r['status']}")
        except Exception as e:     # report every combination, then fail
            failures.append((a, s, repr(e)))
            print(f"[{a} x {s}] FAILED: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures")
        return 1
    print("\nall dry runs OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
