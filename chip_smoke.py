#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card (name, power limit) and turn TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and count
     the flash library's wgmma (``HGMMA``) instructions in its SASS;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (``neighbor_sample`` exactly, the others to
     1e-5), and time kernel, plain version, and, for the attention forward
     and backward, ``F.scaled_dot_product_attention`` (for the backward
     its backward alone, from one forward graph) as a yardstick the port
     never calls; ``neighbor_sample`` also (bitwise, one launch a call,
     two calls equal) with the batch index as a device scalar, over a
     depth-2 export with per-row batch indices and windows and empty
     segments at K 1 / 32 / 64, on segments at its search's round
     boundaries, and in the roles form (the step's src ++ dst ++ neg)
     with invalid and padded rows, where a faulty plain version (the key
     batch_of + 2) must fail the path's check; the attention kernels
     also at ATTN_SHAPES (K 1 / 32,
     K 64 x H 4 x D 128 in slices, H 3 x D 7 staged by cp.async, B 1,
     B 37), each with exact zeros for rows without a neighbor, one launch
     a call and two calls bitwise equal, and a faulty plain version (one
     row's last valid slot dropped) must fail the path's check; the flush,
     which writes ``mem`` / ``last`` in place, at the path's pending ids,
     a heavy-duplicate and an all-padding set with its in-place contract
     (returned tensors are the inputs, untouched rows bitwise unchanged,
     dump rows zero), a faulty plain version without the segment mean
     that must fail, and its backward (``flush_bwd_rows``) against
     autograd of ``flush_ref`` (1e-5 of each grad's largest magnitude),
     timed beside it;
  4. small-input agreement: one ``train_single`` epoch of a narrow TGN on
     the ``tiny`` graph, on the card and on the CPU (plain versions), from
     the same initial params;
  5. the TIG path: ``train_single(synthetic_tig("wikipedia-s",
     scale=10), TIG, epochs=1)`` — TGN at the paper's widths, ~525 train
     steps, then val and test scoring, each step a replay of its
     program's captured CUDA graph — with every kernel's launch count
     read around it, on the device: one launch of each forward kernel a
     step, of each backward one a train step (the flush's backward
     launches ``fused_gru_bwd``), and epoch seconds split into planning
     and the device epoch; then the graphed programs against the eager
     step from the same inputs (the path's first 40 train steps: losses
     to 1e-4, params and state printed, two graphed calls, launches a
     call; the val stream: logits to 1e-4, AP to 1e-3), with a control
     whose step counter never advances that must fail; then where a
     train step's time goes, graphed and eager (unprofiled wall, host
     and device time per step, idle share, ops per step, kernels);
 5b. SEP and PAC: the SEP partitioner on the train split for 4 and 2
     parts, timed, with RF, EC and edges per part; a small ``pac_train``
     (2 parts of ``tiny``, 2 epochs) on the card against the CPU; then the
     PAC paths at the paper's widths, ``pac_train(train split, SEP parts,
     TIG, num_devices=P, epochs=1, eval_graph=g)`` for P 4 and 2 — each
     lockstep step one step over the union of the P partitions (P x B
     rows), a replay of its captured CUDA graph — with launches counted
     from zero around each and held to the steps, epoch seconds
     (planning and device apart), AP (val above 0.7) and peak memory,
     printed beside ``train_single``'s; the graphed PAC epoch against the
     eager loop over the whole P 4 epoch (wrap-around and Alg.2 backups
     included), bitwise, and a second graphed call bitwise, with a control
     that must fail (every device read and sampled at the shared step s in
     place of s % n_batches[k]); the kernels at a PAC step's shapes (the
     roles-form sampling with a per-row batch index bitwise, the flush at
     2PB rows with its backward timed, both attention kernels at 3PB
     rows); and where a PAC step's time goes at P 4 and 2 (40 graphed
     steps, profiled);
  5c. the out-of-core data plane: phase 5's stream written as 10 shards
     of 16,384 rows, ``train_sharded(protocol=True)`` against
     ``train_single`` from the same params over two epochs (losses
     bitwise equal, its metrics those of ``evaluate_params``, prefetch on
     and off bitwise, a control with one shard's edge rows shifted by a
     row that must fail); the out-of-core path at Reddit's size,
     ``synthetic_tig("reddit-s", scale=10)`` as 3 shards of 262,144
     rows, ``train_sharded(protocol=True, eval_node_class=True)`` for two
     epochs with launches counted from zero and held to its steps, epoch
     seconds and the wait for each plan, shard writing, T-CSR build and
     staging seconds, the val curve, test AP, node AUROC and peak memory;
     ``pac_train`` at P 4 from the train split as shards, scored on the
     full stream's shards, bitwise equal to phase 5b's in-memory run, and
     again with node classification; ``train_single(eval_node_class=True)``
     on ``tiny`` on the card against the CPU (embeddings, the head on the
     same embeddings, each run's AUROC);
  5d. two attention layers at the paper's widths:
     ``train_single(wikipedia-s x10, replace(TIG, n_layers=2),
     epochs=1)`` with val and test scoring, launches counted from zero
     and held exactly (one nodes-form sampling launch a step over the
     two windows' 1,200 rows, two launches of each attention kernel a
     step); the sampling kernel at those rows bitwise against
     ``sample_ref`` (the batch index an int and a device scalar) and
     through ``sample_batch_neighbors`` (one launch, its window-0 layer
     the one-layer grids); the graphed program against the eager step
     over 40 train steps and the val stream as in phase 5, with a
     control that must fail (every layer sampled at window 0); 40
     profiled graphed and eager steps, the gathers' backward share at one
     layer and at two; ``pac_train`` at P 4 and two layers, launches held
     to its steps; ``train_sharded`` at two layers on phase 5c's 10
     shards, losses bitwise ``train_single``'s; card against CPU on
     ``tiny`` at two layers;
  5e. TIGER's restarter from phase 5's trained params:
     ``collect_bank`` and ``fit_restarter`` timed apart;
     ``run_protocol(warm="restart")`` against ``warm="state"`` with the
     replayed memory (val / test AP and AUROC within 0.05, launches
     counted); ``restart_memory``'s seconds beside the replay warm-up's
     (host plan + device replay); the bundle saved and loaded,
     ``restart_memory`` bitwise after; ``pac_train(eval_warm="restart")``
     at P 4;
  5f. PAC over a mesh of ranks on an NCCL world of one rank in this
     process (the machine has one card, and NCCL refuses two ranks on
     one): ``pac_train(train split, SEP P 4, TIG, num_devices=4, epochs=1,
     mesh=make_tig_mesh(4), eval_graph=g)`` with the sharded layout, from
     phase 5b's params, launches counted from zero; losses, params,
     post-sync memories and metrics bitwise phase 5b's P 4 run, launches
     equal to its; 40 lockstep steps of the mesh's graphed program, the
     gradient all-reduce called in the eager warm-up and the capture only
     (replayed with the graph), its NCCL kernels a replayed step (1) and
     step / busy ms beside phase 5b's; epoch seconds beside 5b's; the
     planning bytes and seconds of each rank's ``local_ranks=[k]`` plan
     against the full plan, the bytes one device receives in the
     replicated and the sharded layout; ``python -m
     repro_torch.launch.pac_cluster`` as a subprocess (one NCCL rank on
     ``tiny``), exit 0 and its npz bitwise the same run in process with
     ``mesh=None``;
  6. the WKV kernels (``ops.rwkv6`` takes the chunked kernel for S >= 64
     and the sequential one below) against their plain versions at the
     RWKV6 path's shapes (decode S 1 with a state, a ragged S 100 with a
     state, prompt scoring S 2048), each timed beside its plain version
     and the other kernel at the same shape; two calls at S 2048 must
     agree bitwise; at strong decays (|log w| * 64 far above 80, S 320 and
     a ragged S 330, with a state) the chunked kernel against the token
     scan, where the plain TPU-form chunked version must fail;
  7. small-input agreement: REDUCED RWKV6 in float32, ``forward`` logits
     and 8 greedy ``generate`` tokens on the card against the CPU;
  8. the RWKV6 path at full width: RWKV6-1.6B (24 layers, d_model 2048,
     random params from a seed) ``forward`` on (4, 2048) tokens, with where
     its time goes, then ``generate`` with batch 4, prompt 32, gen 32,
     greedy — launch counts read around each — and where a decode step's
     time goes;
  9. the GRU kernels (forward, and backward with all six grads) against
     their plain versions at TGN's updater shape (400, 616, 172), the
     backward benchmark's (512, 176, 128), a ragged (37, 24, 16), odd
     widths (53, 37, 13) and one row (1, 616, 172), timed beside
     ``torch.gru_cell`` and its autograd as a yardstick; two backward
     calls must agree bitwise, the backward's device launches per call
     are counted, and a control (the plain version on inputs rounded to
     tf32, one tensor-core pass) must fail the same checks;
 10. the ``ops.gru`` path: forward and backward through autograd at the
     first two shapes, launch counts read around it;
 11. the flash attention kernel against its plain version at the
     StarCoder2-3B forward's shape (B 2, S 8192, 24 / 2 heads, D 128,
     bf16, window 4096; the plain version a batch row and 4 heads at a
     time), where faulty versions of the plain one (P in float8, a key
     tile dropped at the kernel's tiles) must fail the same check and two
     calls must agree bitwise, and at a small ragged float32 shape
     without a window, timed beside
     ``F.scaled_dot_product_attention`` with the same mask;
 12. small-input agreement: REDUCED StarCoder2 in float32, ``forward``
     logits and 16 greedy ``generate`` tokens after a 56-token prompt (the
     ring buffer of the window of 64 wraps) on the card against the CPU;
 13. the StarCoder2 path at full width: StarCoder2-3B (30 layers, d_model
     3072, random params from a seed) ``forward`` on (2, 8192) tokens,
     with where its time goes, then ``generate`` with batch 4, prompt 32,
     gen 32, greedy — launch counts read around each — and where a decode
     step's time goes.
The line before the last holds the card's name and power limit, the one
before that the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5            # kernel vs plain version, float32 sums in another order
WKV_REL = 1e-5        # WKV: of the largest |plain| (float32, another order)
GRU_REL = 1e-5        # GRU grads: of the largest |plain| (sums over rows)
BF16_UNIT = 2.0 ** -7     # one bfloat16 unit, relative: two roundings
# bf16 flash: |kernel - plain (float32)| <= 2^-8 |plain| (the one rounding
# of the output) + FLASH_P_REL |P| |V| (float32 sums in another order and P
# kept to 2^-17 as hi + lo bf16 parts; the P V error of a relative error d
# in every weight is at most d |P| |V|)
FLASH_P_REL = 2.0 ** -14
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # H100 SXM, dense TF32 on the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM, dense bf16 on the tensor cores
TPU_KERNELS = {               # the TPU kernel each CUDA kernel replaces
    "neighbor_sample": "src/repro/kernels/neighbor_sample.py:52",
    "fused_flush": "src/repro/kernels/fused_flush.py:53",
    "temporal_attn": "src/repro/kernels/temporal_attn.py:40",
    "temporal_attn_bwd": "src/repro/kernels/temporal_attn.py:84",
    "rwkv6": "src/repro/kernels/rwkv6_scan.py:39",
    "rwkv6_seq": "src/repro/kernels/rwkv6_scan.py:39",
    "fused_gru": "src/repro/kernels/fused_gru.py:33",
    "fused_gru_bwd": "src/repro/kernels/fused_gru.py:75",
    "flash_attention": "src/repro/kernels/flash_attention.py:30",
}
TIG_PATH = ("neighbor_sample", "fused_flush", "temporal_attn",
            "temporal_attn_bwd", "fused_gru_bwd")  # the flush's backward
WKV_SHAPES = (        # (label, B, H, S, initial state): the RWKV6 path's
    ("decode", 4, 32, 1, True),          # serve_step at batch 4
    ("ragged", 4, 32, 100, True),        # a ragged prompt, with a state
    ("prompt", 4, 32, 2048, False),      # forward on (4, 2048) tokens
)
WKV_STRONG = (        # strong decays, w = exp(-exp(N(1.5, 0.5))), a state
    ("strong", 4, 32, 320),
    ("strong ragged", 4, 32, 330),
)
GRU_SHAPES = (        # (label, rows, d_in, d_h)
    ("tgn", 400, 616, 172),        # TGN's updater: 2 x batch 200, msg 616
    ("bench", 512, 176, 128),      # benchmarks/kernel_backward.py:128
    ("ragged", 37, 24, 16),        # rows not a multiple of the 32-row tile
    ("odd", 53, 37, 13),           # row strides not 16-byte multiples
    ("one row", 1, 616, 172),
)
SAMPLE_K = (1, 32, 64)   # neighbor_sample beside the path's K 10
ATTN_SHAPES = (       # (label, B, K, H, D) beside the TGN path's (600, 10, 2, 86)
    ("K 1", 600, 1, 2, 86),
    ("K 32", 600, 32, 2, 86),
    ("K 64 H 4 D 128, in slices", 64, 64, 4, 128),   # k, v: 256 KB a row
    ("H 3 D 7, cp.async staging", 100, 10, 3, 7),    # H * D not 4k
    ("B 1", 1, 10, 2, 86),
    ("B 37", 37, 10, 2, 86),
)
# StarCoder2-3B forward on (2, 8192) tokens: (B, S, H, Hkv, D, window)
FLASH_PATH = (2, 8192, 24, 2, 128, 4096)
GRAPH_STEPS = 40      # train steps of phase 5's graph checks, profile
SHARD_PARITY_EDGES = 16_384   # phase 5c's shards of phase 5's stream: 10,
                              # none a multiple of the batch
PAC_PARTS = (4, 2)    # SEP parts (= devices) of phase 5b's PAC paths
PAC_SEP_K = 0.05      # SEP's top-k hub fraction (paper §III-B default)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def sass_count(lib: Path, opcode: str):
    """How many ``opcode`` instructions the SASS of a built library holds
    (``cuobjdump -sass``), or None where the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return sum(line.split()[1].startswith(opcode) for line in
               sass.splitlines() if line.strip().startswith("/*")
               and len(line.split()) > 1)


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per call of ``fn()`` over back-to-back calls, from CUDA events:
    the device's time if it is kept busy, the host's if not."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_spans(fn, attempts: int = 6) -> tuple[list, float]:
    """Run ``fn()`` under ``torch.profiler``; returns the device activity
    as sorted (start us, end us, name) spans, and the host wall time in ms
    from the first call to the last device completion. A profiled run that
    recorded no device activity at all (on the card, mid-script, after
    earlier rounds had recorded; up to 15 times in one run of this script,
    most in phase 9) is run again after a pause, up to ``attempts``
    times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        time.sleep(0.1 * attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            return spans, wall
        print(f"torch.profiler recorded no device activity; running the "
              f"round again", file=sys.stderr)
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{attempts} attempts")


def device_ms(fn, iters: int = 20, rounds: int = 5,
              warmup: int = 5) -> float:
    """Device time per call of ``fn()``: the median over ``rounds``
    profiled rounds of ``iters`` calls each of the round's summed kernel
    and copy durations (``torch.profiler``) over ``iters``. A round is
    summed whole, not cut into calls, because the ops of one call cannot
    be told from the next's: a library call may launch a varying number
    of them, and the profiler may miss one. A round the profiler records
    nothing of is left out; if it records no round, the time comes from
    CUDA events over back-to-back calls (``call_ms``), said on stderr."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()

    per_round = []
    for _ in range(rounds):
        try:
            spans, _ = device_spans(run)
        except RuntimeError as err:
            print(f"{err}; round left out", file=sys.stderr)
            continue
        per_round.append(sum(e - s for s, e, _ in spans) / iters)
    if not per_round:
        print("device time from CUDA events (back to back): the profiler "
              "recorded no round", file=sys.stderr)
        return call_ms(fn, iters=iters, warmup=0)
    return statistics.median(per_round) / 1e3


def timings(fn, heavy: bool = False) -> dict:
    """Device and back-to-back time per call; ``heavy`` calls (tens of ms)
    are timed over fewer of them."""
    if heavy:
        return {"ms": device_ms(fn, iters=1, rounds=3, warmup=1),
                "call_ms": call_ms(fn, iters=2, warmup=1)}
    return {"ms": device_ms(fn), "call_ms": call_ms(fn)}


def bound(nbytes: float, flops: float,
          flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flop_rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def reset_counts(torch, kernels) -> None:
    """Zero every kernel's launch count and the peak-memory statistic,
    right before a path is driven."""
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()


def print_kernel(r: dict) -> None:
    print(f"kernel {r['name']}"
          + (f" {r['label']} ({r['at']}, {r['out_dtype']} out)"
             if "label" in r else "")
          + f": max_abs_err {r['max_abs_err']:.3g}; "
          f"device {r['kernel']['ms'] * 1e3:.2f} us per call (median "
          f"of 5 rounds), "
          f"{r['kernel']['call_ms'] * 1e3:.2f} us back to back; plain "
          f"{r['plain']['ms'] * 1e3:.2f} / "
          f"{r['plain']['call_ms'] * 1e3:.2f} us; bound "
          f"{r['bound'][0] * 1e3:.3f} us by {r['bound'][1]}"
          + ("" if r["library_ms"] is None
             else f"; library {r['library_ms'] * 1e3:.2f} us"))


def path_batch(torch, dev, g, cfg):
    """The main path's T-CSR on the card (at the model's depth), a batch
    mid-epoch ``s`` and its 3B queried nodes (src, dst, neg; padding as
    node 0), as the TIG path stages and samples them."""
    import numpy as np

    from repro_torch.tig.batching import build_batch_program
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.sampler import ChronoNeighborIndex
    from repro_torch.tig.train import epoch_rng

    tr = split_views(g).train
    index = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes,
                                cfg.num_neighbors, cfg.batch_size)
    tcsr = {k: torch.from_numpy(v).to(dev)
            for k, v in index.device_export(depth=cfg.n_layers).items()}
    prog, _ = build_batch_program(tr, cfg, epoch_rng(0, 0, 1),
                                  index=index, plan="device")
    s = prog["src"].shape[0] // 2             # a batch mid-epoch
    valid = np.tile(prog["valid"][s], 3)
    ids3 = np.concatenate([prog[r][s] for r in ("src", "dst", "neg")])
    nodes = torch.from_numpy(np.where(valid & (ids3 >= 0), ids3, 0)
                             .astype(np.int32)).to(dev)
    return tcsr, prog, s, nodes


def sample_exact(torch, label, run, want) -> tuple:
    """Hold a sampling call to its plain version's outputs ``want``: one
    launch a call, two calls bitwise equal, bitwise equal to ``want``.
    Returns the outputs."""
    from repro_torch.kernels.build import KERNELS

    kern = KERNELS["neighbor_sample"]
    before = kern.launches
    got = run()
    again = run()
    torch.cuda.synchronize()
    if kern.launches != before + 2:
        raise AssertionError(f"neighbor_sample {label}: "
                             f"{kern.launches - before} launches in 2 calls")
    for x, y, z in zip(got, again, want):
        if not torch.equal(x, y):
            raise AssertionError(f"neighbor_sample {label}: two calls "
                                 f"differ")
        if not torch.equal(x, z):
            raise AssertionError(f"neighbor_sample {label} differs from "
                                 f"its plain version (max abs diff "
                                 f"{max_err([x], [z])})")
    return got


def hub_tcsr(torch, dev, lengths, pad, seed=0):
    """A T-CSR whose node i has ``lengths[i]`` events, keys sorted in runs
    of about 60 (a hub's events per batch), front-padded by ``pad``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bat = [np.zeros(pad, np.int64)] + [
        np.sort(rng.integers(1, 2 + n // 60, n)) for n in lengths]
    total = pad + int(sum(lengths))
    ex = {"indptr": pad + np.concatenate([[0], np.cumsum(lengths)]),
          "nbr": rng.integers(0, 1000, total), "t": rng.random(total),
          "eidx": np.arange(total), "bat": np.concatenate(bat)}
    return {key: torch.from_numpy(v.astype(
        np.float32 if key == "t" else np.int32)).to(dev)
        for key, v in ex.items()}


def sample_checks(torch, dev, g, cfg, tcsr, prog, s, nodes):
    """Phase 3's sampling checks, each bitwise against ``sample_ref`` /
    ``sample_roles_ref`` with one launch a call and two calls equal: the
    path's batch (the scalar batch index as an int and as a device
    scalar); an export of the path's stream at depth 2 with per-row batch
    indices (0 to past the last) and windows 0 / 1 at K 10 and SAMPLE_K,
    with nodes of empty segments; segments on each side of the search's
    round boundaries ((TPR + 1)^r +- 1 events); the roles form at the
    path's batch with invalid slots and -1 ids put in, and at the
    planner's padded last batch. A faulty plain version (the key
    ``batch_of + 2``: the batch's own events leak in) must fail the path's
    check. Returns the path's record and its outputs."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.neighbor_sample import (ROW_THREADS,
                                                     neighbor_sample_fwd,
                                                     sample_roles_fwd)
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.sampler import ChronoNeighborIndex

    k, rows = cfg.num_neighbors, nodes.shape[0]
    ts = ("indptr", "nbr", "t", "eidx", "bat")
    targs = (*(tcsr[x] for x in ts), nodes, s, k)
    want = ref.sample_ref(*targs)
    got = sample_exact(torch, "path", lambda: neighbor_sample_fwd(*targs),
                       want)
    sample_exact(torch, "path, device-scalar batch index",
                 lambda: neighbor_sample_fwd(*targs[:6], torch.tensor(
                     s, dtype=torch.int32, device=dev), k), want)
    faulty = ref.sample_ref(*targs[:6], s + 1, k)
    if all(torch.equal(x, y) for x, y in zip(got, faulty)):
        raise AssertionError("the faulty plain version (key batch_of + 2) "
                             "passes the path's check")
    n_leak = int((got[2] != faulty[2]).any(1).sum())
    print(f"neighbor_sample: exact at the path ({rows} rows, K {k}), "
          f"with a device-scalar batch index too; the faulty key "
          f"batch_of + 2 changes {n_leak} of {rows} rows")

    rng = np.random.default_rng(0)
    tr = split_views(g).train
    deep = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes,
                               max(SAMPLE_K), cfg.batch_size)
    dtc = {x: torch.from_numpy(v).to(dev)
           for x, v in deep.device_export(depth=2).items()}
    empty = np.flatnonzero(np.diff(dtc["indptr"].cpu().numpy()) == 0)[:50]
    q_nodes = np.concatenate([nodes.cpu().numpy(), empty,
                              nodes.cpu().numpy()[:100]])
    q_batch = rng.integers(0, deep.num_batches + 2, len(q_nodes))
    q_batch[-100:-50], q_batch[-50:] = 0, deep.num_batches + 1
    q_win = rng.integers(0, 2, len(q_nodes))
    qa = [torch.from_numpy(x.astype(np.int32)).to(dev)
          for x in (q_nodes, q_batch, q_win)]
    for kk in sorted({k, *SAMPLE_K}):
        a = (*(dtc[x] for x in ts), qa[0], qa[1], kk, qa[2])
        sample_exact(torch, f"per-row, K {kk}",
                     lambda: neighbor_sample_fwd(*a), ref.sample_ref(*a))
    print(f"neighbor_sample: exact over the depth-2 export at K "
          f"{sorted({k, *SAMPLE_K})}: {len(q_nodes)} rows, per-row batch "
          f"indices 0..{deep.num_batches + 1} and windows 0 / 1, "
          f"{len(empty)} nodes of empty segments")

    p = ROW_THREADS + 1
    lengths = sorted({0, 1, ROW_THREADS} | {
        p ** r + d for r in range(1, 5) if p ** r <= 1 << 22
        for d in (-1, 0, 1)})
    htc = hub_tcsr(torch, dev, lengths, pad=4 * k)
    top = 3 + max(lengths) // 60
    h_nodes = np.repeat(np.arange(len(lengths)), 64)
    h_batch = np.concatenate([np.r_[0, top, rng.integers(0, top, 62)]
                              for _ in lengths])
    a = (*(htc[x] for x in ts), *(torch.from_numpy(x.astype(np.int32)).to(
        dev) for x in (h_nodes, h_batch)), k)
    sample_exact(torch, "round boundaries", lambda: neighbor_sample_fwd(*a),
                 ref.sample_ref(*a))
    print(f"neighbor_sample: exact on segments of {lengths} events, 64 "
          f"batch indices each")

    raw = {x: torch.from_numpy(prog[x][s].copy()).to(dev)
           for x in ("src", "dst", "neg", "valid")}
    a = (*(tcsr[x] for x in ts), *raw.values(), s, k)
    roles = timings(lambda: sample_roles_fwd(*a))      # the path's call
    raw["valid"][::7] = False
    raw["src"][3::11] = -1
    last = {x: torch.from_numpy(prog[x][-1].copy()).to(dev) for x in raw}
    n_steps = prog["src"].shape[0]
    for label, bt, at in (("roles, path batch", raw, s),
                          ("roles, padded last batch", last, n_steps - 1)):
        a = (*(tcsr[x] for x in ts), bt["src"], bt["dst"], bt["neg"],
             bt["valid"], at, k)
        sample_exact(torch, label, lambda: sample_roles_fwd(*a),
                     ref.sample_roles_ref(*a))
    print(f"neighbor_sample: roles form exact at the path batch with "
          f"{int((~raw['valid']).sum())} invalid slots and "
          f"{int((raw['src'] < 0).sum())} -1 ids put in, and at the padded "
          f"last batch; {roles['ms'] * 1e3:.2f} us per call at the path "
          f"batch as it is")

    seg = np.diff(tcsr["indptr"].cpu().numpy())[nodes.cpu().numpy()]
    probes = np.ceil(np.log2(seg + 1.0)).sum()
    n_valid = int((got[0] >= 0).sum())
    nbytes = rows * 4 + rows * 8 + probes * 4 + n_valid * 12 + rows * k * 12
    rec = dict(name="neighbor_sample", max_abs_err=max_err(got, want),
               kernel=timings(lambda: neighbor_sample_fwd(*targs)),
               plain=timings(lambda: ref.sample_ref(*targs)),
               bound=bound(float(nbytes), 0.0), library_ms=None,
               extra={"roles_ms": roles["ms"]})
    return rec, got


def kernel_checks(torch, dev, g, cfg):
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns one record per kernel."""
    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    tcsr, prog, s, nodes = path_batch(torch, dev, g, cfg)
    d, h = cfg.dim, cfg.n_heads
    n_dump = g.num_nodes

    # --- neighbor_sample: exact, at the path and at SAMPLE_K, per-row
    # batch indices and windows, the round boundaries and the roles form
    rec, got = sample_checks(torch, dev, g, cfg, tcsr, prog, s, nodes)
    recs = [rec]
    mask = got[0] >= 0                                    # (3B, K)

    # --- fused_flush: pending rows of this batch (src ++ dst, duplicates)
    ids = np.concatenate([prog["src"][s], prog["dst"][s]])
    ids = np.where(np.tile(prog["valid"][s], 2), ids, n_dump)
    recs.append(flush_checks(torch, dev, ids, np.tile(prog["t"][s], 2),
                             n_dump, d, cfg.msg_dim, randn))
    # --- temporal attention at (3B, H, D / H) with the sampled mask
    recs += attn_checks(torch, dev, randn, mask, h, d // h)
    return recs


def attn_case(torch, dev, randn, b, kn, h, d, seed):
    """Inputs for an attention check: q, k, v, g from ``randn``; a mask
    like the sampler's (each row's valid slots a suffix of its K) with an
    eighth of the rows empty, one row full and one row not a suffix (a
    single row: full)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, kn + 1, b) if b > 2 else np.full(b, kn)
    cnt[:b // 8] = 0
    m = np.arange(kn)[None, :] >= (kn - cnt)[:, None]
    if b > 2:
        m[b // 8] = True
        m[b // 8 + 1] = rng.uniform(size=kn) < 0.5
    mask = torch.from_numpy(m).to(dev)
    return (randn(b, h, d), randn(b, kn, h, d), randn(b, kn, h, d),
            randn(b, h, d), mask)


def attn_check(torch, label, q, k, v, g, mask) -> tuple[float, float]:
    """Both attention kernels against the plain version and its autograd
    (TOL), one launch each, exact zeros for rows without a neighbor and
    for masked slots' dk / dv, and two calls bitwise equal. Returns the
    forward's and the backward's largest error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import KERNELS
    from repro_torch.kernels.temporal_attn import (temporal_attn_bwd,
                                                    temporal_attn_fwd)

    before = [KERNELS[n].launches for n in ("temporal_attn",
                                            "temporal_attn_bwd")]
    out = temporal_attn_fwd(q, k, v, mask)
    got = temporal_attn_bwd(g, q, k, v, mask)
    after = [KERNELS[n].launches for n in ("temporal_attn",
                                           "temporal_attn_bwd")]
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.temporal_attention_ref(*xs, mask)
    want_g = torch.autograd.grad(want, xs, g)
    err = (max_err([out], [want.detach()]), max_err(got, want_g))
    none = ~mask.any(-1)
    zeros = all(not bool(x[none].any()) for x in (out, *got)) and all(
        not bool(x[~mask].any()) for x in got[1:])
    again = [temporal_attn_fwd(q, k, v, mask), *temporal_attn_bwd(
        g, q, k, v, mask)]
    same = all(torch.equal(x, y) for x, y in zip([out, *got], again))
    print(f"temporal_attn {label} (B {q.shape[0]}, K {k.shape[1]}, H "
          f"{q.shape[1]}, D {q.shape[2]}): max abs err {err[0]:.3g} "
          f"forward, {err[1]:.3g} backward (TOL "
          f"{TOL}); zeros {zeros}; bitwise repeatable {same}; launches "
          f"{[y - x for x, y in zip(before, after)]}")
    if not (max(err) <= TOL and zeros and same
            and after == [x + 1 for x in before]):
        raise AssertionError(f"temporal attention kernels fail at {label}")
    return err


def attn_checks(torch, dev, randn, mask, h, dh) -> list:
    """Phase 3's attention: both kernels at the path's shape (3B rows, the
    sampled mask) and at ATTN_SHAPES; a control (the plain version with one
    row's last valid slot dropped) must fail the path's check; each kernel
    timed beside its plain version and SDPA on the rows with a neighbor
    (the backward: SDPA's backward alone, from one forward graph)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.temporal_attn import (temporal_attn_bwd,
                                                    temporal_attn_fwd)

    rows, k = mask.shape
    q, kk, vv, gout = (randn(rows, h, dh), randn(rows, k, h, dh),
                       randn(rows, k, h, dh), randn(rows, h, dh))
    aargs = (q, kk, vv, mask)
    err = attn_check(torch, "path", q, kk, vv, gout, mask)
    errs = {"path": err}
    for i, (label, b, kn, hh, d) in enumerate(ATTN_SHAPES):
        errs[label] = attn_check(torch, label, *attn_case(
            torch, dev, randn, b, kn, hh, d, seed=i))
    # control: a row's last valid slot dropped (a slot never staged)
    row = int(mask.sum(-1).argmax())
    faulty = mask.clone()
    faulty[row, int(mask[row].nonzero()[-1])] = False
    xs = [x.clone().requires_grad_() for x in (q, kk, vv)]
    ys = [x.clone().requires_grad_() for x in (q, kk, vv)]
    want = ref.temporal_attention_ref(*xs, mask)
    bad = ref.temporal_attention_ref(*ys, faulty)
    ctrl = max_err([bad.detach(), *torch.autograd.grad(bad, ys, gout)],
                   [want.detach(), *torch.autograd.grad(want, xs, gout)])
    print(f"temporal_attn control (row {row}'s last valid slot dropped): "
          f"{ctrl:.3g}, {ctrl / TOL:.3g} x TOL; the path's mask: "
          f"{int(mask.sum())} of {mask.numel()} slots valid, "
          f"{int((~mask.any(-1)).sum())} of {rows} rows without any")
    if ctrl <= TOL:
        raise AssertionError("the attention check passes a dropped slot")

    # the bytes the function needs: q (and g), the mask, k and v of the
    # valid slots; out (dq, dk, dv) written whole
    slots = int(mask.sum()) * h
    row_b, slot_b = h * dh * 4, dh * 4
    io = 2 * rows * row_b + mask.numel() + 2 * slots * slot_b
    io_bwd = (3 * rows * row_b + mask.numel() + 2 * slots * slot_b
              + 2 * kk.numel() * 4)
    # yardstick: SDPA over the rows with a neighbor, (B', H, 1, D)
    live = mask.any(-1)
    sq = q[live][:, :, None, :]
    sk = kk[live].transpose(1, 2).contiguous()
    sv = vv[live].transpose(1, 2).contiguous()
    sm = mask[live][:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = dict(
        name="temporal_attn", max_abs_err=err[0],
        kernel=timings(lambda: temporal_attn_fwd(*aargs)),
        plain=timings(lambda: ref.temporal_attention_ref(*aargs)),
        bound=bound(io, 4 * dh * slots),
        library_ms=device_ms(lambda: sdpa(sq, sk, sv, attn_mask=sm)),
        extra=dict(errs=errs, control_err=ctrl))

    def plain_bwd():
        torch.autograd.grad(ref.temporal_attention_ref(*xs, mask), xs, gout)

    # SDPA's backward alone: one forward graph on the same live rows and
    # mask, its backward timed; forward + backward on a line of its own
    lq, lk, lv = (x.clone().requires_grad_() for x in (sq, sk, sv))
    lg = gout[live][:, :, None, :]
    lout = sdpa(lq, lk, lv, attn_mask=sm)
    lib_both = device_ms(lambda: torch.autograd.grad(
        sdpa(lq, lk, lv, attn_mask=sm), (lq, lk, lv), lg))
    print(f"temporal_attn_bwd yardstick: SDPA forward + backward "
          f"{lib_both * 1e3:.2f} us")
    bwd = dict(
        name="temporal_attn_bwd", max_abs_err=err[1],
        kernel=timings(lambda: temporal_attn_bwd(gout, *aargs)),
        plain=timings(plain_bwd), bound=bound(io_bwd, 8 * dh * slots),
        library_ms=device_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), lg, retain_graph=True)),
        extra=dict(library_fwd_bwd_ms=lib_both))
    return [fwd, bwd]


def flush_no_mean(torch, ids, msg, ts, mem, last, wx, wh, bx, bh):
    """A faulty flush for the control: each row's ``mbar`` is its own
    message, not the mean over the rows of its id."""
    from repro_torch.kernels import ref

    mbar = torch.where((ids < mem.shape[0] - 1)[:, None], msg, 0.0)
    s_new = ref.gru_ref(mbar, mem[ids.long()], wx, wh, bx, bh)
    return (ref.scatter_memory(mem, ids, s_new),
            ref.scatter_last(last, ids, ts), mbar)


def flush_forward_check(torch, label, fargs) -> tuple[float, list]:
    """The in-place flush kernel on its own copies of ``mem`` / ``last``
    against ``flush_ref`` on the inputs (TOL), and its in-place contract:
    the returned ``mem`` / ``last`` are the copies, rows not in ``ids``
    unchanged bitwise, the dump rows zero. Returns the max abs error and
    the kernel's outputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_flush import fused_flush_fwd

    ids, mem, last = fargs[0], fargs[3], fargs[4]
    n_dump = mem.shape[0] - 1
    mine = list(fargs)
    mine[3], mine[4] = mem.clone(), last.clone()
    got = fused_flush_fwd(*mine)
    want = ref.flush_ref(*fargs)
    torch.cuda.synchronize()
    err = max_err(got[:3], want)
    if err > TOL:
        raise AssertionError(f"fused_flush {label} differs from flush_ref "
                             f"by {err}")
    keep = torch.ones(n_dump + 1, dtype=torch.bool, device=mem.device)
    keep[ids.long()] = False
    keep[n_dump] = False                  # cleared, checked below
    if not (got[0] is mine[3] and got[1] is mine[4]
            and torch.equal(got[0][keep], mem[keep])
            and torch.equal(got[1][keep], last[keep])
            and not bool(got[0][n_dump].any())
            and float(got[1][n_dump]) == 0.0):
        raise AssertionError(f"fused_flush {label}: the in-place contract "
                             f"does not hold")
    return err, got


def flush_checks(torch, dev, ids_np, ts_np, n_dump, d, dm, randn) -> dict:
    """Phase 3's flush: the in-place forward at the path's pending ids, a
    heavy-duplicate set and an all-padding set; a faulty plain version
    (no aggregation) must fail the path's check; the gradients of
    ``FusedFlush`` against autograd of ``flush_ref`` (GRU_REL of each
    one's largest magnitude); the forward and the backward
    (``flush_bwd_rows``) timed beside their plain versions."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_flush import (FusedFlush, flush_bwd_rows,
                                                 fused_flush_fwd)

    rows = ids_np.shape[0]
    ts = torch.from_numpy(ts_np).to(dev)
    mem = randn(n_dump + 1, d, scale=0.5)
    last = torch.clamp(ts.min() - randn(n_dump + 1).abs(), min=0.0)
    mem[n_dump], last[n_dump] = 1.0, 1.0      # stale: the flush clears them
    msg = randn(rows, dm)
    weights = (randn(dm, 3 * d, scale=dm ** -0.5),
               randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1),
               randn(3 * d, scale=0.1))
    rng = np.random.default_rng(0)
    id_sets = {
        "path": ids_np,
        "heavy duplicates": np.where(rng.uniform(size=rows) < 0.9,
                                     rng.integers(0, 5, rows), n_dump),
        "all padding": np.full(rows, n_dump),
    }
    errs = {}
    for label, ids_set in id_sets.items():
        ids = torch.from_numpy(ids_set.astype(np.int32)).to(dev)
        errs[label], _ = flush_forward_check(
            torch, label, (ids, msg, ts, mem, last, *weights))
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    fargs = (ids, msg, ts, mem, last, *weights)
    ctrl = max_err(flush_no_mean(torch, *fargs), ref.flush_ref(*fargs))
    print(f"fused_flush: max abs err {errs} (TOL {TOL}); control (mbar "
          f"without aggregation) {ctrl:.3g}, {ctrl / TOL:.3g} x TOL")
    if ctrl <= TOL:
        raise AssertionError("the flush check passes a flush without the "
                             "segment mean")

    # gradients, each side on its own copies of mem / last
    diff = (1, 5, 6, 7, 8)
    g_mem, g_mbar = randn(n_dump + 1, d), randn(rows, dm)
    a = [x.clone().requires_grad_(i in diff) for i, x in enumerate(fargs)]
    out = FusedFlush.apply(*a)
    got_g = torch.autograd.grad((out[0], out[2]), [a[i] for i in diff],
                                (g_mem, g_mbar))
    b = [x.clone().requires_grad_(i in diff) for i, x in enumerate(fargs)]
    out_b = ref.flush_ref(*b)
    want_g = torch.autograd.grad((out_b[0], out_b[2]), [b[i] for i in diff],
                                 (g_mem, g_mbar), retain_graph=True)
    rel = [float((x - w).abs().max()) / max(1.0, float(w.abs().max()))
           for x, w in zip(got_g, want_g)]
    print(f"fused_flush backward: error / max(1, max |plain|) per grad "
          f"(msg, wx, wh, bx, bh): {[f'{r:.3g}' for r in rel]} (limit "
          f"{GRU_REL})")
    if max(rel) > GRU_REL:
        raise AssertionError(f"the flush gradients differ from autograd "
                             f"of flush_ref: {rel}")

    kargs = list(fargs)
    kargs[3], kargs[4] = mem.clone(), last.clone()
    _m, _l, mbar, h_g, orow = fused_flush_fwd(*kargs)
    first = int((orow >= 0).sum())
    # the function's work: the pending rows, the weights, the touched rows
    # of mem / last read and written, mbar written; the products of the
    # first occurrences, 3xTF32
    nbytes = (rows * (4 + dm * 4 + 4) + (dm + d + 2) * 3 * d * 4
              + first * (d + 1) * 4 * 2 + rows * dm * 4)
    flops = first * 2 * (dm + d) * 3 * d
    # backward: gather the first rows' cotangents, recompute the gates,
    # d_mbar = dgx wx^T, dwx, dwh and the bias sums on the tensor cores
    # (3xTF32), then d_msg = A (d_mbar + g_mbar) in float32 over A's
    # nonzeros (cnt^2 for an id on cnt rows)
    _, cnt = np.unique(ids_np[ids_np < n_dump], return_counts=True)
    b_bytes = (first * d * 4 + rows * (2 * dm + d) * 4 + rows * 4 * 2
               + 2 * (dm + d + 2) * 3 * d * 4 + rows * dm * 4)
    b_ops_ms = (3 * (2 * flops + first * 2 * dm * 3 * d) / TF32_FLOP_PER_S
                + 2.0 * float((cnt ** 2).sum()) * dm / FP32_FLOP_PER_S) * 1e3
    b_bytes_ms = b_bytes / HBM_BYTES_PER_S * 1e3
    b_bound = ((b_bytes_ms, "bytes") if b_bytes_ms >= b_ops_ms
               else (b_ops_ms, "operations"))

    def kernel_bwd():
        flush_bwd_rows(g_mem, g_mbar, ids, mbar, h_g, orow, *weights,
                       n_dump=n_dump)

    def plain_bwd():
        torch.autograd.grad((out_b[0], out_b[2]), [b[i] for i in diff],
                            (g_mem, g_mbar), retain_graph=True)

    bwd, bwd_plain = timings(kernel_bwd), timings(plain_bwd)
    try:
        spans, _ = device_spans(lambda: [kernel_bwd() for _ in range(10)])
    except RuntimeError as err:     # a breakdown for the record, no check
        print(f"fused_flush backward: no breakdown ({err})")
        spans = []
    by_name: dict = {}
    for s0, e0, name in spans:
        key = name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("<")[0].split("(")[0][:48]
        by_name[key] = by_name.get(key, 0.0) + (e0 - s0) / 10
    print(f"fused_flush backward: {len(spans) / 10:.1f} device ops per "
          f"call; us per call by kernel: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(by_name.items(),
                                               key=lambda kv: -kv[1])))
    print(f"fused_flush backward (flush_bwd_rows, R {rows}, {first} first "
          f"occurrences): device {bwd['ms'] * 1e3:.2f} us per call, "
          f"{bwd['call_ms'] * 1e3:.2f} us back to back; autograd of "
          f"flush_ref {bwd_plain['ms'] * 1e3:.2f} / "
          f"{bwd_plain['call_ms'] * 1e3:.2f} us; bound "
          f"{b_bound[0] * 1e3:.3f} us by {b_bound[1]}")
    return dict(name="fused_flush", max_abs_err=max(errs.values()),
                kernel=timings(lambda: fused_flush_fwd(*kargs)),
                plain=timings(lambda: ref.flush_ref(*fargs)),
                bound=bound(nbytes, 3 * flops, TF32_FLOP_PER_S),
                library_ms=None,
                extra=dict(bwd_ms=bwd["ms"], bwd_call_ms=bwd["call_ms"],
                           bwd_plain_ms=bwd_plain["ms"],
                           bwd_bound_ms=b_bound[0], bwd_bound_by=b_bound[1],
                           bwd_max_rel_err=max(rel)))


def path_epochs(torch, g, cfg, steps: int = GRAPH_STEPS) -> dict:
    """The main path's first ``steps`` train batches and its whole val
    stream, device-planned as ``train_single`` plans epoch 0, each with
    its T-CSR staged on the card (at the model's depth); tables; params
    from seed 0; a fresh state (``state()``)."""
    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.models import init_params, init_state
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.sampler import ChronoNeighborIndex
    from repro_torch.tig.train import epoch_rng

    dev = torch.device("cuda")
    sp = split_views(g)
    out = {"params": init_params(torch.Generator().manual_seed(0), cfg, dev),
           "state": lambda: init_state(cfg, g.num_nodes, dev),
           "tables": {k: torch.from_numpy(v).to(dev) for k, v in
                      make_tables(g.edge_feat, g.node_feat).items()}}
    hist = None
    for i, (name, view) in enumerate((("train", sp.train), ("val", sp.val))):
        index = ChronoNeighborIndex(view.src, view.dst, view.t, view.eidx,
                                    g.num_nodes, cfg.num_neighbors,
                                    cfg.batch_size, history=hist)
        prog, hist = build_batch_program(view, cfg, epoch_rng(0, 0, i + 1),
                                         neg_pool=sp.neg_pool, index=index,
                                         plan="device")
        if name == "train":
            prog = {k: v[:steps] for k, v in prog.items()}
        out[name] = prog
        out[f"{name}_tcsr"] = {k: torch.from_numpy(v).to(dev) for k, v in
                               index.device_export(
                                   depth=cfg.n_layers).items()}
    return out


def leaves(tree) -> list:
    """The tensors of nested dicts (keys sorted), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_diff(a, b) -> float:
    """Largest |a - b| over the leaves of two tensor trees."""
    return max_err(leaves(a), leaves(b))


def graph_checks(torch, kernels, p: dict, cfg) -> dict:
    """Phase 5, after the path: the graphed programs
    (``make_train_epoch``, one captured step replayed a batch) against
    the eager step (``scan_train_epoch``) on the path's first train steps
    and its val stream, from the same inputs; two graphed calls (the
    second only replays); device launches per call; and a control
    program whose step counter never advances (every step replays batch
    0), which must fail the same check."""
    import numpy as np

    from repro_torch.optim import adamw
    from repro_torch.tig import engine
    from repro_torch.tig.evaluation import link_prediction_metrics

    opt = adamw(1e-3, max_grad_norm=1.0)
    steps = p["train"]["src"].shape[0]

    def inputs():
        return (p["params"], opt.init(p["params"]), p["state"](), p["train"],
                p["tables"])

    def counted(run):
        for kern in kernels.values():
            kern.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {n: kernels[n].launches for n in TIG_PATH}

    eager, n_eager = counted(lambda: engine.scan_train_epoch(
        *inputs(), cfg=cfg, opt=opt, tcsr=p["train_tcsr"]))
    fn = engine.make_train_epoch(cfg, opt)
    first, n_first = counted(lambda: fn(*inputs(), tcsr=p["train_tcsr"]))
    second, n_second = counted(lambda: fn(*inputs(), tcsr=p["train_tcsr"]))
    (epoch,) = fn.graphs.values()
    d_loss = max_err([first[3]], [eager[3]])
    d_params = tree_diff(first[0], eager[0])
    d_state = tree_diff(first[2], eager[2])
    d_repeat = tree_diff(first, second)
    print(f"graphed vs eager, {steps} train steps of the path: max |loss "
          f"diff| {d_loss:.3g}, params {d_params:.3g}, state "
          f"{d_state:.3g}; two graphed calls "
          + ("bitwise equal" if d_repeat == 0.0 else
             f"differ by {d_repeat:.3g}")
          + f"; launches a call eager {n_eager}, graphed {n_first} / "
          f"{n_second} (per replay {epoch.per_replay})")
    if not d_loss <= 1e-4:
        raise AssertionError(f"graphed and eager losses differ by {d_loss}")
    if not n_eager == n_first == n_second or any(
            n_eager[n] != steps * per_step(n, cfg) for n in TIG_PATH):
        raise AssertionError(f"launches differ: eager {n_eager}, graphed "
                             f"{n_first}, {n_second}")

    valid = np.asarray(p["val"]["valid"]).reshape(-1)

    def ap(aux):
        return link_prediction_metrics(
            *(aux[k].cpu().numpy().reshape(-1)[valid]
              for k in ("pos_logit", "neg_logit")))["ap"]

    vargs = (eager[0], eager[2], p["val"], p["tables"])
    e_state, e_aux = engine.scan_eval_stream(*vargs, cfg=cfg,
                                             tcsr=p["val_tcsr"])
    g_state, g_aux = engine.make_eval_epoch(cfg)(*vargs, tcsr=p["val_tcsr"])
    d_logit = max_err(list(g_aux.values()), list(e_aux.values()))
    d_ap = abs(ap(g_aux) - ap(e_aux))
    print(f"graphed vs eager, the val stream ({p['val']['src'].shape[0]} "
          f"steps): max |logit diff| {d_logit:.3g}, AP {ap(g_aux):.6f} vs "
          f"{ap(e_aux):.6f}, state {tree_diff(g_state, e_state):.3g}")
    if not (d_logit <= 1e-4 and d_ap <= 1e-3):
        raise AssertionError(f"graphed and eager scoring differ: logits "
                             f"{d_logit}, AP {d_ap}")

    advance = engine._advance
    engine._advance = lambda counter: None
    try:
        stuck = engine.make_train_epoch(cfg, opt)(*inputs(),
                                                  tcsr=p["train_tcsr"])
    finally:
        engine._advance = advance
    d_stuck = max_err([stuck[3]], [eager[3]])
    print(f"control, a stuck step counter (batch 0 every step): max |loss "
          f"diff| {d_stuck:.3g}")
    if d_stuck <= 1e-4:
        raise AssertionError("the stuck-counter control passed the check")
    return dict(d_loss=d_loss, d_params=d_params, d_state=d_state,
                d_repeat=d_repeat, d_logit=d_logit, d_ap=d_ap,
                eager_loss=eager[3])


def per_step(name: str, cfg) -> int:
    """Launches of a TIG kernel a step: one of each, but the attention
    kernels launch once a layer."""
    return cfg.n_layers if name.startswith("temporal_attn") else 1


def profile_train_steps(torch, p: dict, cfg) -> dict:
    """The end of phase 5, where a train step's time goes: the path's
    first train steps, warm, through the graphed program and through the
    eager loop, timed unprofiled in turns (eager, graphed, graphed,
    eager) and then each under ``torch.profiler`` (device activity
    only): host and device time per step, device busy and idle share,
    the device time by kernel."""
    from repro_torch.optim import adamw
    from repro_torch.tig.engine import make_train_epoch, scan_train_epoch

    opt = adamw(1e-3, max_grad_norm=1.0)
    steps = p["train"]["src"].shape[0]
    fn = make_train_epoch(cfg, opt)

    def inputs():
        return (p["params"], opt.init(p["params"]), p["state"](), p["train"],
                p["tables"])

    runs = {"graphed": lambda: fn(*inputs(), tcsr=p["train_tcsr"]),
            "eager": lambda: scan_train_epoch(*inputs(), cfg=cfg, opt=opt,
                                              tcsr=p["train_tcsr"])}
    walls: dict = {label: [] for label in runs}
    for label in ("eager", "graphed", "graphed", "eager"):
        runs[label]()                   # warm (the first graphed captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label]()
        torch.cuda.synchronize()
        walls[label].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for label, run in runs.items():
        out[label] = print_profile(f"{steps} train steps, {label}", run,
                                   steps, min(walls[label]))
        print(f"  unprofiled ms/step over the two timed runs: "
              + " / ".join(f"{w / steps:.3f}" for w in walls[label]))
    g = out["graphed"]
    print(f"graphed step: unprofiled wall {g['wall']:.3f} ms = "
          f"{g['wall'] / g['busy']:.2f}x its device busy {g['busy']:.3f} "
          f"ms (eager: {out['eager']['wall'] / out['eager']['busy']:.2f}x)")
    return out


def print_profile(label: str, run, steps: int, plain_wall: float) -> dict:
    """Run ``run()`` (``steps`` steps, ``plain_wall`` ms unprofiled) under
    ``torch.profiler``; print the host time per step (unprofiled wall less
    device busy), the device busy and idle share of the profiled wall and
    the device time by kernel name. Returns the per-step wall, busy and
    ops."""
    spans, wall = device_spans(run)
    busy, end = 0.0, -math.inf
    by_name: dict = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        key = name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("<")[0].split("(")[0][:60]
        tot, n = by_name.get(key, (0.0, 0))
        by_name[key] = (tot + e - s, n + 1)
    busy /= 1e3
    print(f"profile: {label}, {plain_wall / steps:.3f} ms/step "
          f"unprofiled, {wall / steps:.3f} ms/step profiled; host "
          f"{(plain_wall - busy) / steps:.3f} ms/step (unprofiled wall "
          f"less device busy); device busy {busy / steps:.3f} ms/step "
          f"({busy / wall:.1%} of the profiled wall, idle "
          f"{1 - busy / wall:.1%}); {len(spans) / steps:.0f} device "
          f"ops/step")
    for key, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:12]:
        print(f"  {tot / 1e3 / steps:8.4f} ms/step  {n // steps:4d}x  {key}")
    return {"wall": plain_wall / steps, "busy": busy / steps,
            "ops": len(spans) / steps,
            "counts": {k: n / steps for k, (_, n) in by_name.items()},
            "kernels": {k: tot / 1e3 / steps for k, (tot, _) in
                        by_name.items()}}


def pac_partitions(g) -> tuple:
    """Phase 5b's partitioner: SEP on the train split for each of
    PAC_PARTS, timed, with its partition statistics (RF, EC, edges and
    nodes per part, shared nodes, Thm.1's RF bound)."""
    from repro_torch.core import (partition_stats, replication_factor,
                                  sep_partition, thm1_rf_bound)
    from repro_torch.tig.graph import chronological_split

    train_g = chronological_split(g)[0]
    parts = {}
    for p in PAC_PARTS:
        t0 = time.perf_counter()
        part = sep_partition(train_g.src, train_g.dst, train_g.t,
                             g.num_nodes, p, k=PAC_SEP_K)
        secs = time.perf_counter() - t0
        st = partition_stats(part)
        print(f"SEP {p} parts (k {PAC_SEP_K}) on the train split "
              f"({train_g.num_edges} edges): {secs:.3f} s on the host; RF "
              f"{st.replication_factor:.4f} over placed nodes, "
              f"{replication_factor(part, 'all'):.4f} over all (Thm.1 "
              f"bound {thm1_rf_bound(PAC_SEP_K, p):.2f}), EC "
              f"{st.edge_cut:.4f}, "
              f"edges per part {part.edge_counts().tolist()}, nodes per "
              f"part {part.node_counts().tolist()}, {st.num_shared} shared")
        parts[p] = part
    return train_g, parts


def pac_path(torch, kernels, g, train_g, part, cfg) -> dict:
    """One PAC path: ``pac_train(train_g, part, cfg, num_devices=P,
    epochs=1, eval_graph=g)`` with the launch counts set to 0 right
    before and read right after; epoch seconds (planning and the device
    epoch apart), AP, peak memory; the launches must be those the steps
    imply: one of each forward kernel a lockstep step and a scoring step
    of val and test (host-planned: no sampling), one of each backward a
    lockstep step."""
    import numpy as np

    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.protocol import split_views

    p = part.num_parts
    reset_counts(torch, kernels)
    t0 = time.perf_counter()
    res = pac_train(train_g, part, cfg, num_devices=p, epochs=1,
                    eval_graph=g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kernels[n].launches for n in TIG_PATH}
    peak = torch.cuda.max_memory_allocated() / 2**20
    ep, m = res.plan, res.metrics
    device_s = [e - q for e, q in zip(res.epoch_seconds, res.plan_seconds)]
    print(f"PAC path, P {p}: pac_train TGN (dim {cfg.dim}, "
          f"{cfg.n_layers} attention layer(s), batch "
          f"{cfg.batch_size}) on {p} SEP parts, one epoch of {ep.steps} "
          f"lockstep steps over {p} x {cfg.batch_size} rows: mean loss "
          f"{res.mean_loss_per_epoch().tolist()}, val_ap {m['val_ap']:.6f}, "
          f"test_ap {m['test_ap']:.6f}, test_ap_inductive "
          f"{m['test_ap_inductive']:.6f}; epoch_seconds "
          f"{res.epoch_seconds} (plan {res.plan_seconds}, device epoch "
          f"and sync {device_s}), wall with scoring {wall:.3f} s, peak "
          f"{peak:.1f} MiB")
    print(f"  plan: cap {ep.capacity}, e_cap {ep.edge_capacity}, n_batches "
          f"{ep.n_batches.tolist()}, edges per device "
          f"{ep.edges_per_device.tolist()}, derived_speedup "
          f"{res.derived_speedup:.4f}, {ep.plan_bytes() / 2**20:.1f} MiB of "
          f"grid and T-CSR")
    print(f"  kernels launched on the PAC path, P {p}: {launches}")
    sp = split_views(g)
    scored = sum(-(-len(v.src) // cfg.batch_size) for v in sp.views[1:])
    want = {n: (ep.steps if n != "fused_flush" and n != "temporal_attn"
                else ep.steps + scored) * per_step(n, cfg)
            for n in TIG_PATH}
    if launches != want:
        raise AssertionError(f"launches on the PAC path {launches}, "
                             f"expected {want}")
    losses = np.concatenate([x.ravel() for x in res.losses])
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite PAC loss at P {p}")
    if not (0.7 < m["val_ap"] <= 1.0 and 0.6 < m["test_ap"] <= 1.0):
        raise AssertionError(f"PAC AP too low at P {p}: {m['val_ap']}, "
                             f"{m['test_ap']}")
    return dict(res=res, launches=launches, wall=wall, peak=peak)


def pac_union(g, train_g, part, cfg, steps=None) -> tuple:
    """Epoch 0's plan of a PAC path (device-planned, as ``pac_train``
    draws it; ``steps`` cuts it to that many lockstep steps) and its
    union."""
    from repro_torch.tig.distributed import plan_epoch, union_plan
    from repro_torch.tig.protocol import time_scale_of
    from repro_torch.tig.train import epoch_rng

    ep = plan_epoch(train_g, part.node_lists(), part.shared_nodes, cfg,
                    epoch_rng(0, 0, 11), steps_override=steps,
                    time_scale=time_scale_of(train_g.t), plan="device")
    return ep, union_plan(ep, cfg)


def pac_graph_checks(torch, kernels, ep, union, cfg) -> dict:
    """The graphed PAC epoch (``make_pac_epoch``: one captured step,
    replayed) against the eager loop (``scan_pac_epoch``) over a whole
    epoch at P parts, wrap-around and cycle backups included, from the
    same inputs: losses, params and states bitwise; a second graphed call
    bitwise equal to the first; each TIG kernel launched once a lockstep
    step in each call. Then a control must fail: every device reads and
    samples at the shared step s (its row ``(offsets[k] + s) mod rows``)
    in place of ``s % n_batches[k]``."""
    from repro_torch.optim import adamw
    from repro_torch.tig import distributed as td
    from repro_torch.tig.models import init_params

    opt = adamw(1e-3, max_grad_norm=1.0)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    steps, p = ep.steps, union["parts"]

    def counted(run):
        for kern in kernels.values():
            kern.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {n: kernels[n].launches for n in TIG_PATH}

    eager, n_eager = counted(lambda: td.scan_pac_epoch(
        params, opt.init(params), union, cfg=cfg, opt=opt))
    fn = td.make_pac_epoch(cfg, opt)
    first, n_first = counted(lambda: fn(params, opt.init(params), union))
    second, n_second = counted(lambda: fn(params, opt.init(params), union))
    (epoch,) = fn.graphs.values()
    d_loss = max_err([first[3]], [eager[3]])
    d_all = tree_diff(first, eager)
    d_repeat = tree_diff(first, second)
    wraps = int((ep.n_batches < steps).sum())
    print(f"PAC graphed vs eager, P {p}, the whole epoch ({steps} lockstep "
          f"steps, {wraps} devices wrap round): max |loss diff| "
          f"{d_loss:.3g}, all outputs {d_all:.3g}; two graphed calls "
          + ("bitwise equal" if d_repeat == 0.0 else
             f"differ by {d_repeat:.3g}")
          + f"; launches a call eager {n_eager}, graphed {n_first} / "
          f"{n_second} (per replay {epoch.per_replay})")
    if d_all != 0.0 or d_repeat != 0.0:
        raise AssertionError(f"graphed and eager PAC epochs differ: "
                             f"{d_all}, repeat {d_repeat}")
    if not n_eager == n_first == n_second or any(
            n_eager[n] != steps for n in TIG_PATH):
        raise AssertionError(f"PAC launches differ: eager {n_eager}, "
                             f"graphed {n_first}, {n_second}")

    class SharedIndex(td._PACEpoch):
        def _batch_index(self, s):
            rows = (self.offsets + s) % self.batches["src"].shape[0]
            return s.expand(self.parts), rows.long()

    ctrl = SharedIndex(cfg, opt, params, opt.init(params), union,
                       torch.device("cuda"))
    ctrl.run_eager()
    d_ctrl = max_err([ctrl.result(copy=False)[3]], [eager[3]])
    print(f"control, the shared step s for every device in place of "
          f"s % n_batches[k]: max |loss diff| {d_ctrl:.3g}")
    if d_ctrl <= 1e-4:
        raise AssertionError("the shared-index control passed the check")
    return dict(d_loss=d_loss, d_repeat=d_repeat, d_ctrl=d_ctrl)


def pac_profile(torch, union, cfg) -> dict:
    """Where a PAC step's time goes: GRAPH_STEPS lockstep steps through
    the graphed program, warm, unprofiled then under ``torch.profiler``
    (host and device time per step, idle share, ops, kernels)."""
    from repro_torch.optim import adamw
    from repro_torch.tig.distributed import make_pac_epoch
    from repro_torch.tig.models import init_params

    opt = adamw(1e-3, max_grad_norm=1.0)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    fn = make_pac_epoch(cfg, opt)

    def run():
        return fn(params, opt.init(params), union)

    walls = []
    for _ in range(3):
        run()                            # the first captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    steps = union["steps"]
    out = print_profile(f"{steps} PAC steps, P {union['parts']}, graphed",
                        run, steps, min(walls))
    print(f"  unprofiled ms/step over the timed runs: "
          + " / ".join(f"{w / steps:.3f}" for w in walls))
    return out


def pac_kernel_checks(torch, dev, ep, union, cfg) -> dict:
    """The TIG kernels at a PAC step's shapes (P x B rows), each against
    its plain version on the card: the roles-form sampling with a per-row
    batch index (a step where a device has wrapped round) bitwise, one
    launch a call, two calls equal; the flush at the step's 2PB pending
    rows (``flush_checks``: forward, gradients, and the backward's time,
    whose R x R product grows as P^2); both attention kernels at its 3PB
    rows with the sampled mask."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.neighbor_sample import sample_roles_fwd
    from repro_torch.kernels.temporal_attn import (temporal_attn_bwd,
                                                    temporal_attn_fwd)

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    p, cap, b, k = union["parts"], union["capacity"], cfg.batch_size, \
        cfg.num_neighbors
    s = int(ep.n_batches.min())            # a device has wrapped round
    at = s % ep.n_batches
    rows = ep.offsets + at
    bt = {x: union["batches"][x][rows].reshape(-1)
          for x in ("src", "dst", "neg", "valid", "t")}
    tcsr = {x: torch.from_numpy(v).to(dev)
            for x, v in union["tcsr"].items()}
    ts = ("indptr", "nbr", "t", "eidx", "bat")
    raw = {x: torch.from_numpy(np.ascontiguousarray(bt[x])).to(dev)
           for x in ("src", "dst", "neg", "valid")}
    batch_of = torch.from_numpy(np.tile(np.repeat(at, b), 3).astype(
        np.int32)).to(dev)
    a = (*(tcsr[x] for x in ts), *raw.values(), batch_of, k)
    got = sample_exact(torch, f"roles, PAC step {s}, per-row batch index",
                       lambda: sample_roles_fwd(*a),
                       ref.sample_roles_ref(*a))
    roles = timings(lambda: sample_roles_fwd(*a))
    print(f"neighbor_sample: roles form exact at PAC step {s} (P {p}, "
          f"{3 * p * b} rows, batch indices {at.tolist()}); "
          f"{roles['ms'] * 1e3:.2f} us per call")

    n_dump = p * cap
    ids = np.concatenate([bt["src"], bt["dst"]])
    ids = np.where(np.tile(bt["valid"], 2) & (ids >= 0), ids, n_dump)
    flush = flush_checks(torch, dev, ids, np.tile(bt["t"], 2), n_dump,
                         cfg.dim, cfg.msg_dim, randn)
    mask = got[0] >= 0
    h, dh = cfg.n_heads, cfg.dim // cfg.n_heads
    q, kk, vv, gout = (randn(3 * p * b, h, dh), randn(3 * p * b, k, h, dh),
                       randn(3 * p * b, k, h, dh), randn(3 * p * b, h, dh))
    attn_check(torch, f"PAC P {p}", q, kk, vv, gout, mask)
    fwd = timings(lambda: temporal_attn_fwd(q, kk, vv, mask))
    bwd = timings(lambda: temporal_attn_bwd(gout, q, kk, vv, mask))
    print(f"temporal_attn at PAC P {p} ({3 * p * b} rows): forward "
          f"{fwd['ms'] * 1e3:.2f} us, backward {bwd['ms'] * 1e3:.2f} us "
          f"per call")
    return {"neighbor_sample": {"pac_roles_ms": roles["ms"]},
            "fused_flush": {"pac_ms": flush["kernel"]["ms"],
                            "pac_bwd_ms": flush["extra"]["bwd_ms"],
                            "pac_rows": int(ids.shape[0])},
            "temporal_attn": {"pac_ms": fwd["ms"]},
            "temporal_attn_bwd": {"pac_ms": bwd["ms"]}}


def pac_small_agreement(torch) -> None:
    """Phase 5b's small run: ``pac_train`` on 2 SEP parts of ``tiny`` on
    2 devices, a narrow TGN, two epochs, on the card and on the CPU
    (plain versions) from the same params."""
    import numpy as np

    from repro_torch.core import sep_partition
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.graph import chronological_split
    from repro_torch.tig.models import TIGConfig, init_params

    g = synthetic_tig("tiny")
    tr = chronological_split(g)[0]
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 2, k=PAC_SEP_K)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    kw = dict(num_devices=2, epochs=2, eval_graph=g, params=p0)
    gpu = pac_train(tr, part, cfg, **kw)
    cpu = pac_train(tr, part, cfg, device="cpu", **kw)
    d_loss = max(float(np.abs(a - b).max())
                 for a, b in zip(gpu.losses, cpu.losses))
    d_mem = tree_diff({k: v.cpu() for k, v in gpu.memory_states.items()},
                      cpu.memory_states)
    d_ap = max(abs(gpu.metrics[k] - cpu.metrics[k])
               for k in ("val_ap", "test_ap"))
    print(f"PAC small agreement (card vs CPU, P 2, 2 epochs of "
          f"{gpu.plan.steps} steps): max |loss diff| {d_loss:.3g}, memory "
          f"{d_mem:.3g}, val_ap {gpu.metrics['val_ap']:.6f} vs "
          f"{cpu.metrics['val_ap']:.6f}, test_ap "
          f"{gpu.metrics['test_ap']:.6f} vs {cpu.metrics['test_ap']:.6f}")
    if not (d_loss <= 1e-4 and d_mem <= 1e-4 and d_ap <= 1e-3):
        raise AssertionError(f"PAC card and CPU disagree: loss {d_loss}, "
                             f"memory {d_mem}, AP {d_ap}")


def same_metrics(a: dict, b: dict) -> bool:
    """Two metric dicts equal key for key, bit for bit (NaN equals NaN)."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)


def write_shards(g, path: Path, shard_edges: int):
    """``g`` as ``tig-shards-v1`` under ``path``, timed."""
    from repro_torch.tig.stream import write_graph_shards

    t0 = time.perf_counter()
    sh = write_graph_shards(g, str(path), shard_edges=shard_edges)
    return sh, time.perf_counter() - t0


def sharded_parity(torch, g, tmp: Path) -> None:
    """Phase 5c (1): phase 5's stream as shards of SHARD_PARITY_EDGES rows
    (none a multiple of the batch), ``train_sharded(protocol=True)``
    against ``train_single`` from the same params over two epochs: the
    same plans, T-CSR and table bytes, so the per-epoch losses bitwise
    equal; its ``metrics`` equal ``evaluate_params`` of its params;
    prefetch on and off bitwise equal. A control must fail the loss
    check: the edge table staged with one shard's rows shifted by a row."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.tig.models import init_params
    from repro_torch.tig.train import (evaluate_params, train_sharded,
                                       train_single)

    sh, secs = write_shards(g, tmp / "parity", SHARD_PARITY_EDGES)
    print(f"shards: wikipedia-s x10 in {sh.num_shards} shards of "
          f"{SHARD_PARITY_EDGES} rows (sizes {sh.shard_edges}), written in "
          f"{secs:.3f} s")
    p0 = init_params(torch.Generator().manual_seed(0), TIG)
    kw = dict(epochs=2, params=p0)
    runs = {}
    print(f"  {torch.cuda.memory_allocated() / 2**20:.1f} MiB live before "
          f"the runs")
    for name, run in (
            ("train_sharded", lambda: train_sharded(sh, TIG, protocol=True,
                                                    **kw)),
            ("train_sharded, no prefetch", lambda: train_sharded(
                sh, TIG, protocol=True, prefetch=False, **kw)),
            ("train_single", lambda: train_single(g, TIG, **kw))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runs[name] = run()
        torch.cuda.synchronize()
        r = runs[name]
        print(f"  {name}: losses {r.losses}, epoch_seconds "
              f"{r.epoch_seconds} (waited for the plan "
              f"{r.plan_seconds}), wall {time.perf_counter() - t0:.3f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    shd, off, sgl = (runs[k] for k in ("train_sharded",
                                       "train_sharded, no prefetch",
                                       "train_single"))
    want = evaluate_params(g, TIG, shd.params)
    print(f"  train_sharded metrics {shd.metrics}; evaluate_params of its "
          f"params " + ("equal" if same_metrics(want, shd.metrics) else
                        f"{want}"))
    if shd.losses != sgl.losses:
        raise AssertionError(f"train_sharded losses {shd.losses} are not "
                             f"train_single's {sgl.losses}")
    if not same_metrics(want, shd.metrics):
        raise AssertionError("train_sharded metrics are not "
                             "evaluate_params'")
    if off.losses != shd.losses or not same_metrics(off.metrics,
                                                    shd.metrics):
        raise AssertionError("prefetch on and off differ")

    # the control: one shard's feature rows shifted down by one row
    lo, hi = sh.shard_offsets()[3:5]
    feat = g.edge_feat.copy()
    feat[lo:hi] = np.roll(feat[lo:hi], 1, axis=0)
    bad, _ = write_shards(dataclasses.replace(g, edge_feat=feat),
                          tmp / "shifted", SHARD_PARITY_EDGES)
    ctrl = train_sharded(bad, TIG, epochs=1, protocol=True, params=p0)
    d = abs(ctrl.losses[0] - sgl.losses[0])
    print(f"control, shard 3's edge rows shifted by one: loss "
          f"{ctrl.losses[0]} against {sgl.losses[0]} (|diff| {d:.3g})")
    if d == 0.0:
        raise AssertionError("the shifted-shard control passed the check")


def sharded_path(torch, kernels, tmp: Path) -> dict:
    """Phase 5c (2), the out-of-core path at Reddit's size (paper Tab.II:
    10,984 nodes, 672,447 edges, 172-d edge features, 2 classes):
    ``synthetic_tig("reddit-s", scale=10)`` as shards of the default
    262,144 rows, then ``train_sharded(protocol=True,
    eval_node_class=True)`` for two epochs, counts from zero around it.
    The launches must be those the steps imply: per epoch a train step
    and a val step (device-planned), then ``run_protocol``'s train, val
    and test scoring (host-planned: no sampling launch)."""
    from repro_torch.configs.speed_tig import TIG
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.stream import DEFAULT_SHARD_EDGES, ShardedStream
    from repro_torch.tig.train import train_sharded

    t0 = time.perf_counter()
    g = synthetic_tig("reddit-s", scale=10.0)
    gen = time.perf_counter() - t0
    sh, secs = write_shards(g, tmp / "reddit", DEFAULT_SHARD_EDGES)
    steps = [-(-len(v.src) // TIG.batch_size)
             for v in split_views(g).views]
    print(f"data: reddit-s x10, {g.num_nodes} nodes, {g.num_edges} edges, "
          f"generated in {gen:.3f} s; {sh.num_shards} shards "
          f"{sh.shard_edges}, "
          f"{sh.num_edges * sh.dim_edge * 4 / 1e6:.1f} MB of edge "
          f"features, written in {secs:.3f} s; split steps {steps}")
    del g
    epochs = 2
    reset_counts(torch, kernels)
    live = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    res = train_sharded(ShardedStream.open(sh.path), TIG, epochs=epochs,
                        protocol=True, eval_node_class=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kernels[n].launches for n in TIG_PATH}
    peak = torch.cuda.max_memory_allocated() / 2**20
    m = res.metrics
    print(f"out-of-core path: train_sharded TGN (dim {TIG.dim}, batch "
          f"{TIG.batch_size}) from {sh.num_shards} shards, {epochs} "
          f"epochs: losses {res.losses}; T-CSR from chunks "
          f"{res.setup_seconds['index']:.3f} s, edge table staged "
          f"{res.setup_seconds['stage']:.3f} s; per epoch seconds "
          f"{res.epoch_seconds}, waited for the plan {res.plan_seconds}; "
          f"val curve {res.val_curve} (best epoch {res.best_epoch}); "
          f"test_ap {m['test_ap']:.6f}, test_ap_inductive "
          f"{m['test_ap_inductive']:.6f}, val_ap {m['val_ap']:.6f}, "
          f"train_ap {m['train_ap']:.6f}, node_auroc "
          f"{m['node_auroc']:.6f}; wall {wall:.3f} s, peak {peak:.1f} MiB "
          f"({live:.1f} MiB live before the run)")
    print(f"  kernels launched on the out-of-core path: {launches}")
    train, val, test = steps
    scored = train + val + test
    want = {"neighbor_sample": epochs * (train + val),
            "fused_flush": epochs * (train + val) + scored,
            "temporal_attn": epochs * (train + val) + scored,
            "temporal_attn_bwd": epochs * train,
            "fused_gru_bwd": epochs * train}
    if launches != want:
        raise AssertionError(f"launches on the out-of-core path "
                             f"{launches}, expected {want}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    if not (0.6 < m["val_ap"] <= 1.0 and 0.6 < m["test_ap"] <= 1.0
            and 0.0 <= m["node_auroc"] <= 1.0):
        raise AssertionError(f"out-of-core metrics out of range: {m}")
    return dict(res=res, launches=launches, wall=wall, peak=peak)


def sharded_pac(torch, kernels, train_g, part, pac4, tmp: Path) -> dict:
    """Phase 5c (3): ``pac_train`` at P parts from the train split as
    shards, scored on the full stream's shards (phase 5c (1)'s), against
    phase 5b's in-memory run from the same params: losses and metrics
    bitwise; counts from zero around it. Then again with
    ``eval_node_class=True``, for the node AUROC."""
    import numpy as np

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.stream import ShardedStream

    sh_tr, _ = write_shards(train_g, tmp / "pac_train", SHARD_PARITY_EDGES)
    full = ShardedStream.open(str(tmp / "parity"))
    p = part.num_parts
    kw = dict(num_devices=p, epochs=1, eval_graph=full)
    reset_counts(torch, kernels)
    live = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    res = pac_train(sh_tr, part, TIG, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kernels[n].launches for n in TIG_PATH}
    peak = torch.cuda.max_memory_allocated() / 2**20
    mem = pac4["res"]
    same = (len(res.losses) == len(mem.losses) and all(
        np.array_equal(a, b) for a, b in zip(res.losses, mem.losses))
        and same_metrics(res.metrics, mem.metrics))
    print(f"PAC from shards, P {p}: {sh_tr.num_shards} train shards, "
          f"epoch_seconds {res.epoch_seconds} (waited for the plan "
          f"{res.plan_seconds}), val_ap {res.metrics['val_ap']:.6f}, "
          f"test_ap {res.metrics['test_ap']:.6f}; wall {wall:.3f} s, peak "
          f"{peak:.1f} MiB ({live:.1f} live before); against phase 5b's "
          f"in-memory run: "
          + ("losses and metrics bitwise equal" if same else "DIFFERENT"))
    print(f"  kernels launched on PAC from shards, P {p}: {launches}")
    if not same:
        raise AssertionError("PAC from shards differs from in-memory PAC")
    if launches != pac4["launches"]:
        raise AssertionError(f"PAC from shards launched {launches}, the "
                             f"in-memory run {pac4['launches']}")
    nc = pac_train(sh_tr, part, TIG, eval_node_class=True, **kw)
    torch.cuda.synchronize()
    print(f"  with eval_node_class: node_auroc "
          f"{nc.metrics['node_auroc']:.6f}, test_ap "
          f"{nc.metrics['test_ap']:.6f}")
    if not 0.0 <= nc.metrics["node_auroc"] <= 1.0:
        raise AssertionError(f"PAC node AUROC {nc.metrics['node_auroc']}")
    return dict(res=res, launches=launches, wall=wall, peak=peak)


def node_class_agreement(torch) -> None:
    """Phase 5c (4): ``train_single(eval_node_class=True)`` of a narrow TGN
    on ``tiny`` (labels: each edge's source parity), on the card against
    the CPU from the same params. The test split's collected embeddings,
    scored from the same params and memory on both, agree within 1e-4,
    and the head trained on the same embeddings gives AUROCs within 1e-4.
    The two runs' own AUROCs (each head on its own run's embeddings) agree
    within 1e-3 or one swapped pair of the head's test rows (1 / (n_pos
    n_neg): 1.4e-3 on ``tiny``, coarser than 1e-3)."""
    import numpy as np

    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.models import TIGConfig, init_params, init_state
    from repro_torch.tig.protocol import (score_stream, split_views,
                                          train_classifier_head)
    from repro_torch.tig.train import epoch_rng, train_single

    g = synthetic_tig("tiny")
    g.labels = (g.src % 2).astype(np.int64)
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    kw = dict(epochs=2, params=p0, eval_node_class=True)
    gpu = train_single(g, cfg, **kw)
    cpu = train_single(g, cfg, device="cpu", **kw)
    sp = split_views(g)
    prog, _ = build_batch_program(sp.test, cfg, epoch_rng(0, 0, 3),
                                  neg_pool=sp.neg_pool)
    res = {}
    for dev in ("cuda", "cpu"):
        tables = {k: torch.from_numpy(v).to(dev) for k, v in
                  make_tables(g.edge_feat, g.node_feat).items()}
        res[dev] = score_stream(
            tree_to(cpu.params, dev), cfg, init_state(cfg, g.num_nodes, dev),
            prog, tables, collect_embeddings=True, device=dev)
    emb, labels = res["cpu"]["embeddings"], res["cpu"]["labels"]
    d_emb = float(np.abs(res["cuda"]["embeddings"] - emb).max())
    head = {dev: train_classifier_head(emb, labels, 2, device=dev)
            for dev in ("cuda", "cpu")}
    d_head = abs(head["cuda"] - head["cpu"])
    test = labels[int(len(labels) * 0.7):]
    swap = 1.0 / max(int((test == 1).sum()) * int((test == 0).sum()), 1)
    d_auc = abs(gpu.node_auroc - cpu.node_auroc)
    print(f"node classification (card vs CPU, tiny, 2 epochs): collected "
          f"test embeddings {emb.shape}, max |diff| {d_emb:.3g}; the head "
          f"on the same embeddings {head['cuda']:.6f} vs "
          f"{head['cpu']:.6f}; each run's node_auroc {gpu.node_auroc:.6f} "
          f"vs {cpu.node_auroc:.6f} (one swapped pair: {swap:.3g})")
    if not (d_emb <= 1e-4 and d_head <= 1e-4
            and d_auc <= max(1e-3, swap) + 1e-12):
        raise AssertionError(f"node classification: card and CPU disagree "
                             f"(embeddings {d_emb}, head on the same "
                             f"embeddings {d_head}, runs' AUROC {d_auc})")


def tree_to(tree, dev):
    """A tensor tree copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


def small_agreement(torch, n_layers: int = 1):
    """Phase 4 (and phase 5d at two layers): the port on the card
    (kernels) against the port on the CPU (plain versions), one epoch of
    a narrow TGN on ``tiny``."""
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.models import TIGConfig, init_params
    from repro_torch.tig.train import train_single

    g = synthetic_tig("tiny")
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50,
                    n_layers=n_layers)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = train_single(g, cfg, epochs=1, params=p0, device="cuda")
    cpu = train_single(g, cfg, epochs=1, params=p0, device="cpu")
    # float32 sums in another order, compounded over 17 AdamW steps
    d_loss = abs(gpu.losses[0] - cpu.losses[0])
    d_ap = max(abs(gpu.val_ap - cpu.val_ap), abs(gpu.test_ap - cpu.test_ap))
    print(f"small agreement (card vs CPU, {n_layers} attention "
          f"layer(s)): loss {gpu.losses[0]:.6f} vs "
          f"{cpu.losses[0]:.6f}, val_ap {gpu.val_ap:.6f} vs "
          f"{cpu.val_ap:.6f}, test_ap {gpu.test_ap:.6f} vs "
          f"{cpu.test_ap:.6f}")
    if not (d_loss <= 1e-4 and d_ap <= 1e-3):
        raise AssertionError(f"card and CPU disagree: loss {d_loss}, "
                             f"ap {d_ap}")


def wkv_bound(b, h, s, in_elt, out_elt, with_state) -> tuple:
    """The least time of the WKV function on the card: its bytes (each
    input read once, o and the state written once) at the memory rate, or
    the chunked form's operations for this run's tokens at the rates its
    products use (bf16 wgmma for o = (Q rho) S_0 + A V and the state's
    update, six bfloat16 passes a float32 product, three where the B
    operand is a bf16 v; 3xTF32 for the cross-sub-chunk weights; float32
    for the diagonal blocks and the decay products), whichever is larger.
    Also returns the scan's count (5 float32 operations per state element
    per token), the bound recorded before the chunked kernel."""
    d, c, sub = 64, 64, 8
    nbytes = ((3 * in_elt + 4 + out_elt) * b * h * s * d + h * d * 4
              + (2 if with_state else 1) * b * h * d * d * 4)
    v_passes = 3 if in_elt == 2 else 6
    bf16 = tf32 = fp32 = 0.0
    for t0 in range(0, s, c):
        n = min(c, s - t0)
        subs = [min(sub, n - x) for x in range(0, n, sub)]
        within = sum(m * (m - 1) // 2 for m in subs)     # j < i, same sub
        cross = n * (n - 1) // 2 - within               # j < i, across
        bf16 += 2.0 * n * d * d * (6 + v_passes)        # o's inter, state
        bf16 += 2.0 * (n * (n + 1) // 2) * d * v_passes  # A V
        tf32 += 2.0 * cross * d * 3
        fp32 += 3.0 * within * d + 4.0 * n * d + 4.0 * n * d
    ops_ms = (bf16 / BF16_FLOP_PER_S + tf32 / TF32_FLOP_PER_S
              + fp32 / FP32_FLOP_PER_S) * 1e3 * b * h
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fn = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return fn, bound(nbytes, 5.0 * b * h * s * d * d)


def wkv_checks(torch, dev) -> list:
    """Phase 6: the WKV kernels (through ``ops.rwkv6``, as the model calls
    it: the chunked kernel for S >= 64, the sequential one below) against
    their plain versions at the RWKV6 path's shapes; r, k, v in bfloat16 as
    the model gives them, w, u and the state in float32, all in the model's
    (B, S, H, 64) layout, which the plain versions read as (B, H, S, 64)
    views. The plain version is the token scan for S 1 and S 100 (the
    branch ``rwkv6_chunked_ref`` takes there) and the chunked algebra for S
    2048: the scan's 2048 steps of small ops would take minutes to time.
    At each shape the other kernel is checked and timed too. Two calls at
    S 2048 must agree bitwise. Then strong decays (``WKV_STRONG``): the
    chunked kernel against the token scan and ``rwkv6_subchunk_ref``,
    where ``rwkv6_chunked_ref`` (the TPU form, exponents centred on half
    the chunk's log-decay) must fail the same check."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rwkv6_scan import (CHUNK, rwkv6_chunked_fwd,
                                                rwkv6_seq_fwd)

    gen = torch.Generator(device=dev).manual_seed(1)
    d = 64
    recs = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(b, h, s, with_state, strong=False):
        r, k, v = (randn(b, s, h, d).bfloat16() for _ in range(3))
        # decays in (~0.7, 1), the regime of trained RWKV models, or strong
        w = torch.exp(-torch.exp(randn(b, s, h, d) * 0.5
                                 + (1.5 if strong else -2.0)))
        u = randn(h, d) * 0.1
        state = randn(b, h, d, d) if with_state else None
        return (r, k, v, w, u), state

    def plain_of(fn):
        def plain(r, k, v, w, u, state):
            o, st = fn(*(x.transpose(1, 2) for x in (r, k, v, w)), u,
                       state=state, return_state=True)
            return o.transpose(1, 2), st
        return plain

    def check(label, got, want):
        """WKV_REL of the largest |plain| (plus one bf16 unit for a bf16
        o) on o and on the state; returns the max abs error."""
        got_o, got_s = got
        want_o, want_s = want
        go, wo = got_o.double(), want_o.double()
        atol = WKV_REL * max(1.0, float(wo.abs().max()))
        rtol = BF16_UNIT if got_o.dtype == torch.bfloat16 else 0.0
        s_err = float((got_s - want_s).abs().max())
        ok = (bool(torch.isfinite(go).all())
              and bool(((go - wo).abs() <= atol + rtol * wo.abs()).all())
              and s_err <= WKV_REL * max(1.0, float(want_s.abs().max())))
        return ok, max_err([got_o, got_s], [want_o, want_s])

    for label, b, h, s, with_state in WKV_SHAPES:
        args, state = inputs(b, h, s, with_state)
        plain = plain_of(ref.rwkv6_ref if s <= 64 or s % 64
                         else ref.rwkv6_chunked_ref)
        got = ops.rwkv6(*args, state=state)
        want = plain(*args, state)
        torch.cuda.synchronize()
        if got[0].dtype != want[0].dtype:
            raise AssertionError(f"rwkv6 {label}: output {got[0].dtype}, "
                                 f"plain {want[0].dtype}")
        ok, err = check(label, got, want)
        if not ok:
            raise AssertionError(f"rwkv6 {label} differs from its plain "
                                 f"version: max abs {err}")
        name, other = (("rwkv6_seq", rwkv6_chunked_fwd) if s < CHUNK
                       else ("rwkv6", rwkv6_seq_fwd))
        odt = got[0].dtype

        def alt(other=other, args=args, state=state, odt=odt):
            return other(*args, state, out_dtype=odt)

        ok_alt, err_alt = check(label, alt(), want)
        if not ok_alt:
            raise AssertionError(f"rwkv6 {label}: the other kernel differs "
                                 f"from the plain version by {err_alt}")
        if label == "prompt":
            again = ops.rwkv6(*args, state=state)
            if not (torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])):
                raise AssertionError("rwkv6 prompt: two calls differ")
            print("rwkv6 prompt: two calls bitwise equal")
        fn_bound, scan_bound = wkv_bound(b, h, s, 2, got[0].element_size(),
                                         with_state)
        alt_t = timings(alt)
        recs.append(dict(
            name=name, label=label, at=f"B {b}, H {h}, S {s}",
            max_abs_err=err, out_dtype=str(odt).split(".")[-1],
            kernel=timings(lambda: ops.rwkv6(*args, state=state)),
            plain=timings(lambda: plain(*args, state)),
            bound=fn_bound, library_ms=None,
            extra=dict(bound_scan_ms=scan_bound[0],
                       other_kernel="rwkv6" if name == "rwkv6_seq"
                       else "rwkv6_seq",
                       other_ms=alt_t["ms"], other_call_ms=alt_t["call_ms"],
                       other_max_abs_err=err_alt)))
        print(f"  rwkv6 {label}: {name} {recs[-1]['kernel']['ms'] * 1e3:.2f}"
              f" us, the other kernel {alt_t['ms'] * 1e3:.2f} us; scan's "
              f"bound {scan_bound[0] * 1e3:.3f} us")

    for label, b, h, s in WKV_STRONG:
        args, state = inputs(b, h, s, True, strong=True)
        lw = -torch.log(args[3].float())
        got = ops.rwkv6(*args, state=state)
        want = plain_of(ref.rwkv6_ref)(*args, state)
        alg = plain_of(ref.rwkv6_subchunk_ref)(*args, state)
        tpu = plain_of(ref.rwkv6_chunked_ref)(*args, state)
        torch.cuda.synchronize()
        ok, err = check(label, got, want)
        ok_alg, err_alg = check(label, alg, want)
        ok_tpu, err_tpu = check(label, (tpu[0].float(), tpu[1]), want)
        print(f"rwkv6 {label} (B {b}, H {h}, S {s}, median |log w| * 64 = "
              f"{float(lw.median()) * 64:.0f}): kernel max abs err {err:.3g}"
              f", rwkv6_subchunk_ref {err_alg:.3g}; control "
              f"rwkv6_chunked_ref (TPU form) finite "
              f"{bool(torch.isfinite(tpu[0]).all())}, passes {ok_tpu}")
        if not (ok and ok_alg):
            raise AssertionError(f"rwkv6 {label}: the kernel or the "
                                 f"sub-chunk algebra differs from the scan")
        if s % 64 == 0 and ok_tpu:
            raise AssertionError(f"rwkv6 {label}: the check passes the TPU "
                                 f"form at strong decays")
    return recs


def lm_small_agreement(torch, arch: str, prompt: int, gen: int) -> None:
    """Phases 7 and 12: a REDUCED LM in float32, the port on the card (its
    kernel) against the port on the CPU (the plain version), from the same
    params: forward logits on (2, 128) tokens to 1e-4 (float32 sums in
    another order), then ``gen`` greedy tokens after ``prompt`` prompt
    tokens, identical."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.serve import generate
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    p_cpu = model.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 128)))
    on_card = model.forward(p_gpu, {"tokens": tokens}, cfg)
    on_cpu = model.forward(p_cpu, {"tokens": tokens}, cfg, device="cpu")
    d_logit = float((on_card.cpu() - on_cpu).abs().max())
    a = generate(p_gpu, cfg, tokens[:, :prompt], gen)
    c = generate(p_cpu, cfg, tokens[:, :prompt], gen, device="cpu")
    print(f"small agreement {arch} REDUCED float32 (card vs CPU): forward "
          f"logits (2, 128) max abs diff {d_logit:.3g}; greedy tokens after "
          f"{prompt} prompt tokens {a.tokens.tolist()} vs "
          f"{c.tokens.tolist()}")
    if not (d_logit <= 1e-4 and np.array_equal(a.tokens, c.tokens)):
        raise AssertionError(f"{arch} on the card and on the CPU disagree")


def lm_path(torch, kernels, arch: str, batch: int, seq: int,
            fwd_per_layer: dict, gen_per_layer: dict) -> dict:
    """Phases 8 and 13: an LM at its published widths, random params from
    a seed: ``forward`` on (batch, seq) tokens and where its time goes,
    then ``generate`` (batch 4, prompt 32, gen 32, greedy), launch counts
    zeroed before and read after each: each kernel of ``fwd_per_layer``
    that many times per layer in ``forward``, each of ``gen_per_layer`` in
    ``generate``, no other kernel. Then a profile of decode steps. Returns
    every kernel's launches over both."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.serve import generate
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    heads = (f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of "
             f"{cfg.rwkv_head_dim}" if cfg.rwkv else
             f"{cfg.n_heads} / {cfg.n_kv_heads} heads of "
             f"{cfg.resolved_head_dim}, window {cfg.window}")
    print(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {heads}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params} params "
          f"(float32, {cfg.dtype} compute), init "
          f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev)
    logits = model.forward(params, {"tokens": tokens}, cfg)   # warm-up
    del logits
    torch.cuda.synchronize()

    reset_counts(torch, kernels)
    t0 = time.perf_counter()
    logits = model.forward(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = {n: k.launches for n, k in kernels.items()}
    fwd_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    finite = bool(torch.isfinite(logits).all())
    shape, dtype = tuple(logits.shape), logits.dtype
    del logits
    print(f"{arch} forward ({batch}, {seq}): {fwd_s:.4f} s "
          f"({batch * seq / fwd_s:.0f} tok/s), logits {shape} {dtype} "
          f"finite {finite}, peak {fwd_peak:.1f} MiB, launches "
          f"{fwd_launches}")
    print_profile(f"{arch} forward ({batch}, {seq})",
                  lambda: model.forward(params, {"tokens": tokens}, cfg), 1,
                  fwd_s * 1e3)

    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    reset_counts(torch, kernels)
    res = generate(params, cfg, prompts, 32)
    gen_launches = {n: k.launches for n, k in kernels.items()}
    gen_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"{arch} generate (batch 4, prompt 32, gen 32, greedy): "
          f"prefill {res.prefill_s:.4f} s, decode {res.decode_s:.4f} s "
          f"({4 * 32 / res.decode_s:.1f} tok/s, "
          f"{res.decode_s / 32 * 1e3:.3f} ms/step), peak {gen_peak:.1f} "
          f"MiB, launches {gen_launches}; first sequence "
          f"{res.tokens[0][:16].tolist()}")
    want_fwd = {n: cfg.n_layers * fwd_per_layer.get(n, 0) for n in kernels}
    want_gen = {n: cfg.n_layers * gen_per_layer.get(n, 0) for n in kernels}
    if not finite or shape != (batch, seq, cfg.vocab):
        raise AssertionError(f"forward logits {shape}, finite {finite}")
    if fwd_launches != want_fwd or gen_launches != want_gen:
        raise AssertionError(f"launches {fwd_launches} / {gen_launches}, "
                             f"expected {want_fwd} / {want_gen}")
    if res.tokens.shape != (4, 32) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"generated tokens {res.tokens}")

    # where a decode step's time goes: 8 warm serve_steps at batch 4
    cache = model.init_cache(cfg, 4, 64)
    tok = torch.from_numpy(prompts[:, 0]).to(dev)

    def run(steps=8):
        c = cache
        for t in range(steps):
            pos = torch.full((4,), t, dtype=torch.int64, device=dev)
            _, c = model.serve_step(params, c, {"token": tok, "pos": pos},
                                    cfg)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    print_profile(f"8 {arch} decode steps (batch 4)", run, 8,
                  (time.perf_counter() - t0) * 1e3)
    return {n: fwd_launches[n] + gen_launches[n] for n in kernels}


def gru_args(torch, gen, dev, rows, d_in, d_h):
    """GRU inputs at the given widths and a cotangent, from ``gen``."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return ((randn(rows, d_in), randn(rows, d_h),
             randn(d_in, 3 * d_h, scale=d_in ** -0.5),
             randn(d_h, 3 * d_h, scale=d_h ** -0.5),
             randn(3 * d_h, scale=0.1), randn(3 * d_h, scale=0.1)),
            randn(rows, d_h))


def gru_grads_off(got, want) -> list:
    """The names of the six grads that are not within GRU_REL of the
    largest |plain| of their own (at least GRU_REL)."""
    names = ("dx", "dh", "dwx", "dwh", "dbx", "dbh")
    return [name for name, a, w in zip(names, got, want)
            if a.shape != w.shape or float((a - w).abs().max())
            > GRU_REL * max(1.0, float(w.abs().max()))]


def check_gru_grads(label, got, want) -> float:
    """Raise unless every grad is within GRU_REL (``gru_grads_off``);
    returns the max abs error."""
    off = gru_grads_off(got, want)
    if off:
        raise AssertionError(f"fused_gru_bwd {label}: {off} differ from "
                             f"the plain backward")
    return max_err(got, want)


def tf32_round(torch, t):
    """Float32 rounded to tf32 (10 mantissa bits) to nearest, ties away
    from zero, on the bits: what one tensor-core pass reads."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def gru_tf32_control(torch, args, g, want, want_b) -> None:
    """The plain version on x, h, wx, wh rounded once to tf32 must fail
    both the forward's TOL and the grads' GRU_REL: the checks tell 3xTF32
    from a kernel that dropped the lo terms."""
    from repro_torch.kernels import ref

    x, h, wx, wh, bx, bh = args
    rounded = (*(tf32_round(torch, a) for a in (x, h, wx, wh)), bx, bh)
    err_f = max_err([ref.gru_ref(*rounded)], [want])
    got_b = ref.gru_bwd_ref(g, *rounded)
    off = gru_grads_off(got_b, want_b)
    print(f"  control (inputs rounded to tf32): forward max |err| "
          f"{err_f:.3g} ({err_f / TOL:.3g} of TOL), grads max |err| "
          f"{max_err(got_b, want_b):.3g}, off the limit: {off}")
    if err_f <= TOL or not off:
        raise AssertionError("the GRU checks pass a one-pass tf32 version")


def gru_checks(torch, dev) -> list:
    """Phase 9: the GRU kernels against their plain versions (``gru_ref``;
    autograd through it for the backward) at GRU_SHAPES; float32, TF32
    off. Two backward calls must agree bitwise. At TGN's shape, a one-pass
    tf32 control must fail the same checks, and the backward's device
    launches per call are counted from a profile. Yardstick:
    ``torch.gru_cell`` (the same [r|z|n] gates, r applied to W_hn h +
    b_hn) and its autograd. Bounds: the kernels run 3xTF32, three tf32
    products per float32 product, on the tensor cores."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_gru import fused_gru_bwd, fused_gru_fwd

    gen = torch.Generator(device=dev).manual_seed(2)
    recs = []
    for label, rows, d_in, d_h in GRU_SHAPES:
        args, g = gru_args(torch, gen, dev, rows, d_in, d_h)
        x, h, wx, wh, bx, bh = args
        out, want = fused_gru_fwd(*args), ref.gru_ref(*args)
        got_b = fused_gru_bwd(g, *args)
        want_b = ref.gru_bwd_ref(g, *args)
        torch.cuda.synchronize()
        err_f = max_err([out], [want])
        if err_f > TOL:
            raise AssertionError(f"fused_gru {label} differs from gru_ref "
                                 f"by {err_f}")
        err_b = check_gru_grads(label, got_b, want_b)
        again = fused_gru_bwd(g, *args)
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise AssertionError(f"fused_gru_bwd {label}: two calls differ")
        if label == "tgn":
            gru_tf32_control(torch, args, g, want, want_b)
            # distinct kernels, which a dropped profiler event cannot hide
            spans, _ = device_spans(
                lambda: [fused_gru_bwd(g, *args) for _ in range(10)])
            names = sorted({n.replace("(anonymous namespace)::", "")
                            .split("(")[0] for _, _, n in spans})
            print(f"fused_gru_bwd {label}: {len(names)} device launches per "
                  f"call (3 in the first version), {len(spans)} of 10 calls' "
                  f"recorded: {names}")
            if len(names) != 2 or len(spans) > 20:
                raise AssertionError(f"fused_gru_bwd runs {names} "
                                     f"({len(spans)} launches in 10 calls), "
                                     f"expected 2 kernels a call")
        lib_out = torch.gru_cell(x, h, wx.t(), wh.t(), bx, bh)
        print(f"torch.gru_cell {label} vs gru_ref: max abs diff "
              f"{max_err([lib_out], [want]):.3g}")
        xs = [a.clone().requires_grad_() for a in args]

        def lib_bwd():
            torch.autograd.grad(torch.gru_cell(
                xs[0], xs[1], xs[2].t(), xs[3].t(), xs[4], xs[5]), xs, g)

        at = f"B {rows}, d_in {d_in}, d_h {d_h}"
        io = 4.0 * sum(a.numel() for a in args)           # each input once
        flops = 2.0 * rows * (d_in + d_h) * 3 * d_h       # x wx and h wh
        recs.append(dict(
            name="fused_gru", label=label, at=at, out_dtype="float32",
            max_abs_err=err_f,
            kernel=timings(lambda: fused_gru_fwd(*args)),
            plain=timings(lambda: ref.gru_ref(*args)),
            bound=bound(io + 4.0 * h.numel(), 3 * flops, TF32_FLOP_PER_S),
            library_ms=device_ms(
                lambda: torch.gru_cell(x, h, wx.t(), wh.t(), bx, bh))))
        # the backward reads g and the inputs, writes one grad per input;
        # it recomputes the gates, then dx, dh, dwx, dwh and the bias sums
        recs.append(dict(
            name="fused_gru_bwd", label=label, at=at, out_dtype="float32",
            max_abs_err=err_b,
            kernel=timings(lambda: fused_gru_bwd(g, *args)),
            plain=timings(lambda: ref.gru_bwd_ref(g, *args)),
            bound=bound(2 * io + 4.0 * g.numel(),
                        3 * (3 * flops + 2.0 * 2 * rows * 3 * d_h),
                        TF32_FLOP_PER_S),
            library_ms=device_ms(lib_bwd)))
    return recs


def gru_path(torch, kernels) -> dict:
    """Phase 10: ``ops.gru`` forward and backward through autograd at
    TGN's updater shape and the backward benchmark's, launch counts zeroed
    before and read after; outputs checked against the plain versions."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = GRU_SHAPES[:2]
    cases = [gru_args(torch, gen, dev, *shape[1:]) for shape in shapes]
    reset_counts(torch, kernels)
    results = []
    for args, g in cases:
        xs = [a.clone().requires_grad_() for a in args]
        out = ops.gru(*xs)
        results.append((out.detach(), torch.autograd.grad(out, xs, g)))
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    for (label, *_), (args, g), (out, grads) in zip(shapes, cases, results):
        if max_err([out], [ref.gru_ref(*args)]) > TOL:
            raise AssertionError(f"ops.gru {label}: forward differs")
        check_gru_grads(label, grads, ref.gru_bwd_ref(g, *args))
    print(f"ops.gru path (forward + autograd backward at "
          f"{[s[1:] for s in shapes]}): launches {launches}")
    want = {n: len(shapes) if n in ("fused_gru", "fused_gru_bwd") else 0
            for n in kernels}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return launches


def causal_pairs(s: int, window) -> int:
    """(query, key) pairs that attend under a causal mask with an optional
    sliding window, per (batch row, head)."""
    w = window or s
    return sum(min(i + 1, w) for i in range(s))


def head_chunks(q, k, v, heads=4):
    """The model-layout q (B, S, H, D) and k, v (B, S, Hkv, D) one batch row
    and ``heads`` query heads at a time, in the plain version's (1, heads,
    S, D) with K and V repeated kv-major, so its (S, S) tables stay small;
    yields (b, head slice, q, k, v)."""
    group = q.shape[2] // k.shape[2]
    for b in range(q.shape[0]):
        for h0 in range(0, q.shape[2], heads):
            hs = slice(h0, min(h0 + heads, q.shape[2]))
            kv = [i // group for i in range(hs.start, hs.stop)]
            yield (b, hs, q[b:b + 1, :, hs].transpose(1, 2),
                   k[b:b + 1, :, kv].transpose(1, 2),
                   v[b:b + 1, :, kv].transpose(1, 2))


def flash_controls(torch, att, v, want, lim, window) -> dict:
    """Faulty versions of the plain one at the path's shape, each with its
    output rounded to bf16 as a kernel's is: P rounded to bf16 (the flash
    kernel's first P V), P rounded to float8 e4m3, and the key tile at the
    lower edge of each query block's window dropped, at the kernel's tiles
    (``BLOCK_Q`` rows, ``BLOCK_KV`` keys). Returns each one's (max |err|,
    max err / limit) against the plain float32 output."""
    from repro_torch.kernels.flash_attention import BLOCK_KV, BLOCK_Q

    pmax = att.amax(-1, keepdim=True)

    def rounded(dtype):    # P rounded as a kernel rounds exp(s - max)
        return ((att / pmax).to(dtype).float() * pmax) @ v

    s = att.shape[-1]
    qi = torch.arange(s, device=att.device)[:, None]
    ki = torch.arange(s, device=att.device)[None, :]
    q0 = qi // BLOCK_Q * BLOCK_Q
    drop = (q0 >= window) & (ki // BLOCK_KV == (q0 - window + 1)
                             // BLOCK_KV)
    dropped = att.masked_fill(drop, 0.0)
    out = {}
    for name, fn in (
            ("P bf16", lambda: rounded(torch.bfloat16)),
            ("P e4m3", lambda: rounded(torch.float8_e4m3fn)),
            ("edge tile dropped",
             lambda: (dropped / dropped.sum(-1, keepdim=True)) @ v)):
        diff = (fn().to(torch.bfloat16).float() - want).abs()
        out[name] = (float(diff.max()), float((diff / lim).max()))
    return out


def flash_checks(torch, dev) -> list:
    """Phase 11: the flash kernel against its plain version at a small
    ragged float32 shape (to 1e-5) and at the StarCoder2-3B forward's
    shape in bf16 (to 2^-8 |plain| + ``FLASH_P_REL`` |P| |V| of the plain
    version's float32 output), where faulty versions of the plain one
    must fail the same check. Yardstick: ``F.scaled_dot_product_attention``
    with the same causal (and window) mask and ``enable_gqa=True``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=dev).manual_seed(3)
    recs = []
    cases = ((2, 300, 8, 2, 64, None, torch.float32, "ragged f32"),
             (*FLASH_PATH, torch.bfloat16, "starcoder2 forward"))
    for b, s, h, hkv, d, window, dtype, label in cases:
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, s, hkv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        args = (q, k, v)
        got = flash_attention_fwd(*args, causal=True, window=window)
        if not torch.equal(got, flash_attention_fwd(*args, causal=True,
                                                    window=window)):
            raise AssertionError(f"flash_attention {label}: two calls "
                                 f"differ")
        torch.cuda.synchronize()
        err = ratio = 0.0
        for bi, hs, qc, kc, vc in head_chunks(*args):
            att = ref.flash_attention_probs(qc, kc, causal=True,
                                            window=window)
            vf = vc.float()
            want = att @ vf      # the plain version before its output cast
            diff = (got[bi:bi + 1, :, hs].transpose(1, 2).float()
                    - want).abs()
            lim = (torch.full_like(want, TOL) if dtype == torch.float32 else
                   2 ** -8 * want.abs() + FLASH_P_REL * (att @ vf.abs()))
            err = max(err, float(diff.max()))
            ratio = max(ratio, float((diff / lim).max()))
            if ratio > 1.0:
                raise AssertionError(f"flash_attention {label}: batch row "
                                     f"{bi}, heads {hs} differ from the "
                                     f"plain version by {float(diff.max())}"
                                     f" ({ratio:.3g} of the limit)")
            if dtype == torch.bfloat16 and bi == 0 and hs.start == 0:
                ctl = flash_controls(torch, att, vf, want, lim, window)
            del att, want, diff, lim
        print(f"flash {label}: max |kernel - plain| {err:.3g}, at most "
              f"{ratio:.3g} of the limit; two calls bitwise equal")
        if dtype == torch.bfloat16:
            for name, (e, r) in ctl.items():
                print(f"  control ({name}; batch row 0, heads 0-3): max "
                      f"|err| {e:.3g}, at most {r:.3g} of the limit")
            for name in ("P e4m3", "edge tile dropped"):
                if ctl[name][1] <= 1.0:
                    raise AssertionError(f"the bf16 flash check passes a "
                                         f"faulty version ({name})")

        def plain():
            for _, _, qc, kc, vc in head_chunks(*args):
                ref.flash_attention_ref(qc, kc, vc, causal=True,
                                        window=window)

        qi = torch.arange(s, device=dev)[:, None]
        ki = torch.arange(s, device=dev)[None, :]
        mask = (ki <= qi) & (ki > qi - (window or s))
        qt, kt, vt = (x.transpose(1, 2) for x in args)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        lib_err = float((library().transpose(1, 2).float()
                         - got.float()).abs().max())
        print(f"SDPA {label} vs the kernel: max abs diff {lib_err:.3g}")
        elt = q.element_size()
        nbytes = elt * (2 * q.numel() + k.numel() + v.numel())
        flops = 4.0 * d * b * h * causal_pairs(s, window)
        heavy = s > 1024
        recs.append(dict(
            name="flash_attention", label=label,
            at=f"B {b}, S {s}, H {h}, Hkv {hkv}, D {d}, window {window}",
            out_dtype=str(dtype).split(".")[-1], max_abs_err=err,
            kernel=timings(lambda: flash_attention_fwd(
                *args, causal=True, window=window)),
            plain=timings(plain, heavy=heavy),
            bound=bound(nbytes, flops, BF16_FLOP_PER_S
                        if dtype == torch.bfloat16 else FP32_FLOP_PER_S),
            library_ms=device_ms(library, iters=5 if heavy else 20,
                                 rounds=3 if heavy else 5)))
        del got, args, q, k, v, mask
        torch.cuda.empty_cache()
    return recs


def multilayer_sample_check(torch, dev, g, cfg) -> dict:
    """Phase 5d (2): the sampling kernel's nodes form at a two-layer
    step's rows: one launch over the 3B queried nodes repeated for each
    layer, per-row windows L-1 .. 0 (3B rows each), over the train
    split's T-CSR exported at depth L, bitwise against ``sample_ref`` at
    a batch mid-epoch (the batch index an int and a device scalar);
    ``engine.sample_batch_neighbors`` at that batch, one launch, its
    window-0 layer the one-layer grids. Times the kernel and its plain
    version at those rows."""
    import dataclasses

    from repro_torch.kernels import ref
    from repro_torch.kernels.build import KERNELS
    from repro_torch.kernels.neighbor_sample import neighbor_sample_fwd
    from repro_torch.tig import engine

    tcsr, prog, s, nodes = path_batch(torch, dev, g, cfg)
    n_l, k, rows = cfg.n_layers, cfg.num_neighbors, nodes.shape[0]
    win = torch.arange(n_l - 1, -1, -1, dtype=torch.int32, device=dev
                       ).repeat_interleave(rows)
    ts = ("indptr", "nbr", "t", "eidx", "bat")
    a = (*(tcsr[x] for x in ts), nodes.repeat(n_l), s, k, win)
    want = ref.sample_ref(*a)
    got = sample_exact(torch, f"{n_l} windows", lambda: neighbor_sample_fwd(
        *a), want)
    sample_exact(torch, f"{n_l} windows, device-scalar batch index",
                 lambda: neighbor_sample_fwd(*a[:6], torch.tensor(
                     s, dtype=torch.int32, device=dev), k, win), want)
    older = got[1][:rows][(got[1][:rows] >= 0).all(1)
                          & (got[1][rows:] >= 0).all(1)]
    batch = {x: torch.from_numpy(prog[x][s]).to(dev)
             for x in ("src", "dst", "neg", "valid")}
    before = KERNELS["neighbor_sample"].launches
    grids = engine.sample_batch_neighbors(batch, tcsr, s, cfg)
    one = engine.sample_batch_neighbors(
        batch, tcsr, s, dataclasses.replace(cfg, n_layers=1))
    torch.cuda.synchronize()
    if KERNELS["neighbor_sample"].launches != before + 2:
        raise AssertionError("sample_batch_neighbors: not one launch a call")
    if not all(torch.equal(grids[f"{x}_{r}"][-1], one[f"{x}_{r}"])
               for x in ("nbr", "nbrt", "nbre")
               for r in ("src", "dst", "neg")):
        raise AssertionError("the window-0 layer is not the one-layer grid")
    kern = timings(lambda: neighbor_sample_fwd(*a))
    plain = timings(lambda: ref.sample_ref(*a))
    print(f"neighbor_sample: nodes form exact at a {n_l}-layer step's "
          f"{n_l * rows} rows (windows {n_l - 1}..0, depth-{n_l} export), "
          f"with a device-scalar batch index too; {len(older)} rows with "
          f"both windows full; sample_batch_neighbors one launch, its "
          f"window-0 layer the one-layer grids; {kern['ms'] * 1e3:.2f} us "
          f"per call (plain {plain['ms'] * 1e3:.2f} us)")
    del tcsr, prog, nodes
    return {"windowed_rows": n_l * rows, "windowed_ms": kern["ms"],
            "windowed_call_ms": kern["call_ms"],
            "windowed_plain_ms": plain["ms"]}


def window_control(torch, p: dict, cfg, eager_loss) -> float:
    """Phase 5d's control: the graphed program with every layer sampled
    at window 0 (the layer-0 grid a copy of the last layer's) must fail
    the graphed-vs-eager loss check."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.tig import engine

    opt = adamw(1e-3, max_grad_norm=1.0)
    sample = ops.neighbor_sample

    def window_zero(tcsr, nodes, batch_of, k, window=0):
        return sample(tcsr, nodes, batch_of, k, window=0)

    ops.neighbor_sample = window_zero
    try:
        bad = engine.make_train_epoch(cfg, opt)(
            p["params"], opt.init(p["params"]), p["state"](), p["train"],
            p["tables"], tcsr=p["train_tcsr"])
    finally:
        ops.neighbor_sample = sample
    d = max_err([bad[3]], [eager_loss])
    print(f"control, every layer sampled at window 0: max |loss diff| "
          f"{d:.3g}")
    if d <= 1e-4:
        raise AssertionError("the window-0 control passed the check")
    return d


def multilayer_phase(torch, kernels, dev, g, train_g, part, pac4, shards,
                     prof1: dict) -> tuple:
    """Phase 5d: ``n_layers`` 2 at the paper's widths. Returns the
    launches of each of its paths and the sampler's windowed timing."""
    import dataclasses

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.tig import engine
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.stream import ShardedStream
    from repro_torch.tig.train import train_sharded, train_single

    cfg = dataclasses.replace(TIG, n_layers=2)
    t_phase = time.perf_counter()
    by_path = {}
    # (1) the path: train_single at two layers, counts from zero
    reset_counts(torch, kernels)
    t0 = time.perf_counter()
    res = train_single(g, cfg, epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kernels[n].launches for n in TIG_PATH}
    by_path["train_single_l2"] = launches
    print(f"phase 5d path: train_single TGN, 2 attention layers (dim "
          f"{cfg.dim}, K {cfg.num_neighbors}, batch {cfg.batch_size}) "
          f"losses {res.losses}, val_ap {res.val_ap:.6f}, test_ap "
          f"{res.test_ap:.6f}, test_ap_inductive "
          f"{res.test_ap_inductive:.6f}, epoch_seconds {res.epoch_seconds} "
          f"(plan {res.plan_seconds}, device epoch "
          f"{[e - q for e, q in zip(res.epoch_seconds, res.plan_seconds)]}"
          f"), wall {wall:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"kernels launched on the two-layer path: {launches}")
    steps = [-(-len(v.src) // cfg.batch_size) for v in split_views(g).views]
    want = {n: (steps[0] if n in ("temporal_attn_bwd", "fused_gru_bwd")
                else sum(steps)) * per_step(n, cfg) for n in TIG_PATH}
    if launches != want:
        raise AssertionError(f"launches on the two-layer path {launches}, "
                             f"expected {want} (steps {steps})")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"non-finite two-layer loss: {res.losses}")
    if not (0.6 < res.val_ap <= 1.0 and 0.6 < res.test_ap <= 1.0):
        raise AssertionError(f"two-layer AP not above chance: "
                             f"{res.val_ap}, {res.test_ap}")

    # (2) the sampler at the path's windowed rows
    sampled = multilayer_sample_check(torch, dev, g, cfg)

    # (3) graphed against eager, the window-0 control, the profile
    p = path_epochs(torch, g, cfg)
    checks = graph_checks(torch, kernels, p, cfg)
    window_control(torch, p, cfg, checks["eager_loss"])
    prof2 = profile_train_steps(torch, p, cfg)
    engine.release(p["tables"])
    del p, checks
    for label, prof in (("1 layer (phase 5)", prof1),
                        ("2 layers", prof2)):
        gr = prof["graphed"]
        ib = sum(v for k, v in gr["kernels"].items()
                 if "indexing_backward" in k)
        print(f"graphed train step, {label}: device busy {gr['busy']:.3f} "
              f"ms, {gr['ops']:.0f} ops; indexing_backward_kernel "
              f"{ib:.3f} ms ({ib / gr['busy']:.1%} of busy)")

    # (4) PAC at P 4, two layers, launches held to its lockstep steps
    pac = pac_path(torch, kernels, g, train_g, part, cfg)
    by_path["pac_p4_l2"] = pac["launches"]
    print(f"PAC P 4 at two layers beside one (NVIDIA card above): epoch "
          f"{pac['res'].epoch_seconds[0]:.4f} s vs "
          f"{pac4['res'].epoch_seconds[0]:.4f} s, val_ap "
          f"{pac['res'].metrics['val_ap']:.6f} vs "
          f"{pac4['res'].metrics['val_ap']:.6f}")

    # (5) out of core: phase 5c's 10 shards, one epoch, bitwise
    reset_counts(torch, kernels)
    t0 = time.perf_counter()
    shd = train_sharded(ShardedStream.open(str(shards)), cfg, epochs=1,
                        protocol=True)
    torch.cuda.synchronize()
    by_path["train_sharded_l2"] = {n: kernels[n].launches for n in TIG_PATH}
    print(f"train_sharded at two layers on phase 5c's shards: losses "
          f"{shd.losses} (train_single {res.losses}), "
          f"epoch_seconds {shd.epoch_seconds}, test_ap "
          f"{shd.metrics['test_ap']:.6f}, wall "
          f"{time.perf_counter() - t0:.3f} s; launches "
          f"{by_path['train_sharded_l2']}")
    if shd.losses != res.losses:
        raise AssertionError(f"two-layer train_sharded losses {shd.losses} "
                             f"are not train_single's {res.losses}")

    # (6) card against CPU on tiny
    small_agreement(torch, n_layers=2)
    print(f"phase 5d: {time.perf_counter() - t_phase:.1f} s "
          f"({card_line()})")
    return by_path, sampled


def restart_phase(torch, kernels, g, train_g, part, params, tmp: Path
                  ) -> dict:
    """Phase 5e: TIGER's restarter at the paper's widths, from phase 5's
    trained params. Returns the launches of its two paths."""
    import numpy as np

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.tig import engine
    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.models import init_state
    from repro_torch.tig.protocol import run_protocol, split_views
    from repro_torch.tig.restart import (collect_bank, fit_restarter,
                                         load_restarter, restart_memory,
                                         save_restarter)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    splits = split_views(g)
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              make_tables(g.edge_feat, g.node_feat).items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (1) build: collect the bank, fit the head, timed apart
    (bank, replay_state), t_collect = timed(
        lambda: collect_bank(params, TIG, splits, tables))
    rst, t_fit = timed(lambda: fit_restarter(bank, replay_state, TIG,
                                             tables))
    print(f"restarter: collect_bank {t_collect:.3f} s (a replay of "
          f"{splits.train.num_edges} train edges, {int(bank.seen.sum())} of "
          f"{splits.num_nodes} nodes seen), fit_restarter {t_fit:.3f} s "
          f"(400 AdamW steps, fit MSE {rst.fit_mse:.6g})")

    # (2) score: the restart against the replayed state, counts from zero
    reset_counts(torch, kernels)
    restart, t_rp = timed(lambda: run_protocol(
        params, TIG, splits, tables, warm="restart", restarter=rst))
    launches = {n: kernels[n].launches for n in TIG_PATH}
    oracle, t_sp = timed(lambda: run_protocol(
        params, TIG, splits, tables, warm="state", state=replay_state))
    print(f"run_protocol warm='restart' {t_rp:.3f} s: val_ap "
          f"{restart['val_ap']:.6f}, test_ap {restart['test_ap']:.6f}, "
          f"val_auc {restart['val_auc']:.6f}, test_auc "
          f"{restart['test_auc']:.6f}; warm='state' (the replayed memory) "
          f"{t_sp:.3f} s: val_ap {oracle['val_ap']:.6f}, test_ap "
          f"{oracle['test_ap']:.6f}, val_auc {oracle['val_auc']:.6f}, "
          f"test_auc {oracle['test_auc']:.6f}; launches {launches}")
    gaps = {k: abs(restart[k] - oracle[k])
            for k in ("val_ap", "test_ap", "val_auc", "test_auc")}
    if not all(v <= 0.05 for v in gaps.values()):
        raise AssertionError(f"restart metrics off the replayed state's "
                             f"by more than 0.05: {gaps}")
    if launches["temporal_attn"] == 0:
        raise AssertionError("the restart scoring launched no attention")

    # (3) the warm-up's cost: restart_memory against the train replay
    # (its host plan and the device replay; the second call, captured)
    for _ in range(2):
        state_r, t_restart = timed(lambda: restart_memory(
            rst, splits.num_nodes, tables))
    batches, t_plan = timed(lambda: build_batch_program(
        splits.train, TIG, np.random.default_rng(0),
        neg_pool=splits.neg_pool)[0])
    eval_fn = engine.make_eval_epoch(TIG)
    replays = [timed(lambda: eval_fn(params, init_state(
        TIG, splits.num_nodes, dev), batches, tables))[1] for _ in range(2)]
    engine.release(tables)
    print(f"warm-up: restart_memory {t_restart:.4f} s against the replay "
          f"{t_plan + replays[1]:.4f} s (host plan {t_plan:.4f} s + device "
          f"replay {replays[1]:.4f} s; first replay with its capture "
          f"{replays[0]:.4f} s) ({card_line()})")

    # (4) the bundle's round trip
    path = save_restarter(str(tmp / "restarter.npz"), rst)
    again = restart_memory(load_restarter(path, TIG), splits.num_nodes,
                           tables)
    if not all(torch.equal(state_r[k], again[k]) for k in state_r):
        raise AssertionError("restart_memory differs after save / load")
    print(f"restarter bundle: {Path(path).stat().st_size} bytes, "
          f"restart_memory bitwise equal after save / load")

    # (5) PAC at P 4 scored through the restarter
    reset_counts(torch, kernels)
    res, t_pac = timed(lambda: pac_train(
        train_g, part, TIG, num_devices=part.num_parts, epochs=1,
        eval_graph=g, eval_warm="restart"))
    pac_launches = {n: kernels[n].launches for n in TIG_PATH}
    m = res.metrics
    print(f"pac_train P {part.num_parts} eval_warm='restart': val_ap "
          f"{m['val_ap']:.6f}, test_ap {m['test_ap']:.6f}, wall "
          f"{t_pac:.3f} s; launches {pac_launches}")
    if not (0.6 < m["val_ap"] <= 1.0 and 0.6 < m["test_ap"] <= 1.0):
        raise AssertionError(f"PAC restart AP too low: {m}")
    print(f"phase 5e: {time.perf_counter() - t_phase:.1f} s "
          f"({card_line()})")
    return {"run_protocol_restart": launches, "pac_p4_restart": pac_launches}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_pac(torch, a, b) -> bool:
    """Two ``pac_train`` results equal bit for bit: losses, params, the
    post-sync memories and the metrics."""
    import numpy as np

    return (len(a.losses) == len(b.losses)
            and all(np.array_equal(x, y) for x, y in zip(a.losses, b.losses))
            and all(torch.equal(x, y) for x, y in
                    zip(leaves(a.params), leaves(b.params)))
            and a.memory_states.keys() == b.memory_states.keys()
            and all(torch.equal(a.memory_states[k], b.memory_states[k])
                    for k in a.memory_states)
            and same_metrics(a.metrics, b.metrics))


def mesh_profile(torch, mesh, train_g, part, cfg, prof4: dict) -> None:
    """Phase 5f (b): GRAPH_STEPS lockstep steps of the mesh's epoch
    program (the rank's union of the sharded plan), captured and replayed:
    the all-reduce runs once a step in the eager warm-up and once in the
    capture, never again in Python (it is replayed with the graph); the
    collective's device kernels a step under ``torch.profiler``; step and
    busy ms beside phase 5b's P 4 profile."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import local_part_ranks
    from repro_torch.optim import adamw
    from repro_torch.tig import engine
    from repro_torch.tig.distributed import (make_pac_epoch, plan_epoch,
                                             union_plan)
    from repro_torch.tig.models import init_params
    from repro_torch.tig.protocol import time_scale_of
    from repro_torch.tig.train import epoch_rng

    ep = plan_epoch(train_g, part.node_lists(), part.shared_nodes, cfg,
                    epoch_rng(0, 0, 11), steps_override=GRAPH_STEPS,
                    time_scale=time_scale_of(train_g.t), plan="device",
                    layout="sharded")
    union = union_plan(ep, cfg, local_part_ranks(mesh))
    opt = adamw(1e-3, max_grad_norm=1.0)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    fn = make_pac_epoch(cfg, opt, mesh=mesh)
    calls = []
    all_reduce = dist.all_reduce

    def counted(*args, **kw):
        calls.append(kw.get("op"))
        return all_reduce(*args, **kw)

    def run():
        return fn(params, opt.init(params), union)

    dist.all_reduce = counted
    try:
        run()                               # warm-up and capture
        torch.cuda.synchronize()
        n_first = len(calls)
        run()                               # replays only
        torch.cuda.synchronize()
        n_second = len(calls) - n_first
    finally:
        dist.all_reduce = all_reduce
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    steps = union["steps"]
    out = print_profile(f"{steps} PAC steps over the mesh (NCCL world of "
                        f"one, P {mesh.num_parts}), graphed", run, steps,
                        min(walls))
    coll = {k: n for k, n in out["counts"].items()
            if "nccl" in k.lower() or "onerank" in k.lower()}
    per_step = sum(coll.values())
    coll_us = sum(out["kernels"][k] for k in coll) * 1e3
    print(f"  the gradient all-reduce: {n_first} Python calls in the first "
          f"call ({engine.WARMUP_STEPS} eager warm-up steps and the "
          f"capture, op {calls[0]}), {n_second} in the second ({steps} "
          f"replays); NCCL kernels a replayed step {per_step:g} {coll}, "
          f"{coll_us:.2f} us a step")
    print(f"  step over the mesh vs phase 5b's P 4 (no mesh): unprofiled "
          f"{min(walls) / steps:.3f} vs {prof4['wall']:.3f} ms, device "
          f"busy {out['busy']:.3f} vs {prof4['busy']:.3f} ms, "
          f"{out['ops']:.0f} vs {prof4['ops']:.0f} device ops")
    if n_first != engine.WARMUP_STEPS + 1 or n_second != 0:
        raise AssertionError(f"the all-reduce is not in the captured step: "
                             f"{n_first} / {n_second} calls")
    if per_step != 1:
        raise AssertionError(f"NCCL kernels a replayed step {per_step}, "
                             f"expected 1: {coll}")


def mesh_planning(train_g, part, cfg) -> None:
    """Phase 5f (b): what a rank plans. Epoch 0's plan at P parts in the
    replicated and the sharded layout and each rank's ``local_ranks=[k]``
    plan, timed, with their host bytes, and the bytes one device
    receives (``device_input_bytes``)."""
    from repro_torch.tig.distributed import plan_epoch
    from repro_torch.tig.protocol import time_scale_of
    from repro_torch.tig.train import epoch_rng

    scale = time_scale_of(train_g.t)
    p = part.num_parts

    def timed(**kw):
        t0 = time.perf_counter()
        ep = plan_epoch(train_g, part.node_lists(), part.shared_nodes, cfg,
                        epoch_rng(0, 0, 11), time_scale=scale,
                        plan="device", **kw)
        return ep, time.perf_counter() - t0

    rep, s_rep = timed()
    full, s_full = timed(layout="sharded")
    print(f"planning, P {p}: replicated {rep.plan_bytes() / 2**20:.2f} MiB "
          f"in {s_rep:.3f} s, {rep.device_input_bytes() / 2**20:.2f} MiB "
          f"to each device; sharded {full.plan_bytes() / 2**20:.2f} MiB in "
          f"{s_full:.3f} s, {full.device_input_bytes() / 2**20:.2f} MiB to "
          f"each device")
    for k in range(p):
        loc, secs = timed(layout="sharded", local_ranks=[k])
        print(f"  local_ranks=[{k}]: {loc.plan_bytes() / 2**20:.2f} MiB in "
              f"{secs:.3f} s ({loc.plan_bytes() / full.plan_bytes():.3f} "
              f"of the full sharded plan's bytes, {secs / s_full:.3f} of "
              f"its seconds)")
    if not full.device_input_bytes() < rep.device_input_bytes():
        raise AssertionError("the sharded layout ships a device no less "
                             "than the replicated one")


def launcher_agreement(torch, tmp: Path) -> None:
    """Phase 5f (c): ``python -m repro_torch.launch.pac_cluster`` as a
    subprocess, one NCCL rank of 2 partition slots on ``tiny`` (8 SEP
    parts, 2 epochs), killed with its session past 300 s; it must exit 0
    and its npz equal the same run in this process with ``mesh=None``."""
    import os
    import signal

    import numpy as np

    from repro_torch.core import sep_partition
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.graph import chronological_split
    from repro_torch.tig.models import TIGConfig
    from repro_torch.tree import tree_leaves

    out = tmp / "launcher.npz"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pac_cluster",
         "--num-processes", "1", "--process-id", "0", "--coordinator",
         f"127.0.0.1:{free_port()}", "--local-devices", "2", "--epochs",
         "2", "--parts", "8", "--timeout", "120", "--out", str(out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"pac_cluster exited {proc.returncode}:\n"
                             f"{log[-3000:]}")
    g = synthetic_tig("tiny", seed=0)
    tr = chronological_split(g)[0]
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, batch_size=50)
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 8, k=0.05)
    res = pac_train(tr, part, cfg, num_devices=2, epochs=2, seed=0,
                    eval_graph=g)
    want = {f"loss_{e}": x for e, x in enumerate(res.losses)}
    want.update({f"param_{i}": x.cpu().numpy()
                 for i, x in enumerate(tree_leaves(res.params))})
    want.update({f"state_{k}": res.memory_states[k].cpu().numpy()
                 for k in ("mem", "mem2", "last")})
    want.update({f"metric_{k}": np.asarray(v)
                 for k, v in res.metrics.items()})
    got = np.load(out)
    same = sorted(got.files) == sorted(want) and all(
        np.array_equal(got[k], v, equal_nan=True) for k, v in want.items())
    print(f"launcher: pac_cluster, one NCCL rank, 2 partition slots, tiny, "
          f"exit {proc.returncode} in {secs:.1f} s "
          f"({log.strip().splitlines()[-1]}); its npz ({len(got.files)} "
          f"arrays) against the in-process mesh=None run: "
          + ("bitwise equal" if same else "DIFFERENT"))
    if not same:
        raise AssertionError("the launcher's npz differs from mesh=None's")


def mesh_phase(torch, kernels, g, train_g, part, pac4, prof4: dict,
               tmp: Path) -> dict:
    """Phase 5f: PAC over a mesh of ranks (``launch.mesh.make_tig_mesh``)
    on an NCCL world of one rank in this process holding all P partition
    slots (the card is one: NCCL refuses two ranks on it). Returns the
    launches of its path."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.launch.mesh import make_tig_mesh
    from repro_torch.tig.distributed import pac_train

    t_phase = time.perf_counter()
    p = part.num_parts
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_tig_mesh(p)
        # (a) the path at phase 5b's P 4, from its params: bitwise
        reset_counts(torch, kernels)
        t0 = time.perf_counter()
        res = pac_train(train_g, part, TIG, num_devices=p, epochs=1,
                        mesh=mesh, eval_graph=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: kernels[n].launches for n in TIG_PATH}
        ref = pac4["res"]
        same = same_pac(torch, res, ref)
        print(f"phase 5f path: pac_train over the mesh (NCCL world of one, "
              f"{p} partition slots, layout {res.plan.layout}), one epoch "
              f"of {res.plan.steps} steps: val_ap "
              f"{res.metrics['val_ap']:.6f}, test_ap "
              f"{res.metrics['test_ap']:.6f}; epoch_seconds "
              f"{res.epoch_seconds} (plan {res.plan_seconds}) vs phase "
              f"5b's {ref.epoch_seconds} (plan {ref.plan_seconds}), wall "
              f"{wall:.3f} s vs {pac4['wall']:.3f} s; against phase 5b's "
              f"P {p} run: losses, params, memories and metrics "
              + ("bitwise equal" if same else "DIFFERENT"))
        print(f"  kernels launched over the mesh: {launches}")
        if not same:
            raise AssertionError("PAC over the mesh differs from phase "
                                 "5b's run")
        if launches != pac4["launches"]:
            raise AssertionError(f"PAC over the mesh launched {launches}, "
                                 f"phase 5b {pac4['launches']}")
        # (b) where the time goes, and what a rank plans
        mesh_profile(torch, mesh, train_g, part, TIG, prof4)
        mesh_planning(train_g, part, TIG)
    finally:
        dist.destroy_process_group()
    # (c) the launcher
    launcher_agreement(torch, tmp)
    print(f"phase 5f: {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return {f"pac_p{p}_mesh": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.speed_tig import TIG
    from repro_torch.kernels.build import (KERNELS, SOURCES, build_all,
                                           library_path)
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig import engine
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.train import train_single

    t_all = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build_all()
    print(f"build: {len(logs)} of {len(SOURCES)} libraries compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    hgmma = sass_count(library_path("flash_attention.cu"), "HGMMA")
    print(f"flash_attention.cu: " + ("no cuobjdump to read its SASS"
                                     if hgmma is None else
                                     f"{hgmma} HGMMA (wgmma) instructions "
                                     f"in its SASS"))
    if hgmma == 0:
        raise AssertionError("the flash kernels compiled without wgmma")

    g = synthetic_tig("wikipedia-s", scale=10.0)
    print(f"data: wikipedia-s x10, {g.num_nodes} nodes, {g.num_edges} edges")
    recs = kernel_checks(torch, dev, g, TIG)
    for r in recs:
        print_kernel(r)

    small_agreement(torch)

    # the TIG path: counts from zero, read right after
    reset_counts(torch, KERNELS)
    t0 = time.perf_counter()
    res = train_single(g, TIG, epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    print(f"main path: train_single TGN (dim {TIG.dim}, K "
          f"{TIG.num_neighbors}, batch {TIG.batch_size}) losses "
          f"{res.losses}, val_ap {res.val_ap:.6f}, test_ap "
          f"{res.test_ap:.6f}, test_ap_inductive {res.test_ap_inductive:.6f}"
          f", epoch_seconds {res.epoch_seconds} (plan "
          f"{res.plan_seconds}, device epoch "
          f"{[e - q for e, q in zip(res.epoch_seconds, res.plan_seconds)]}"
          f"), wall {wall:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"kernels launched on the TIG path: {launches}")
    if not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    # one epoch of TGN learns the stream well above chance (AP 0.5)
    if not (0.6 < res.val_ap <= 1.0 and 0.6 < res.test_ap <= 1.0):
        raise AssertionError(f"AP not above chance: {res.val_ap}, "
                             f"{res.test_ap}")
    if any(launches[n] == 0 for n in TIG_PATH):
        raise AssertionError(f"a kernel never ran on the TIG path: "
                             f"{launches}")
    # on the device, one launch of each forward kernel a step of the three
    # streams, of each backward one a train step (the flush's backward
    # runs fused_gru_bwd)
    steps = [-(-len(v.src) // TIG.batch_size) for v in split_views(g).views]
    want = {n: steps[0] if n in ("temporal_attn_bwd", "fused_gru_bwd")
            else sum(steps) for n in TIG_PATH}
    if any(launches[n] != want[n] for n in TIG_PATH):
        raise AssertionError(f"launches on the TIG path {launches}, "
                             f"expected {want} (steps {steps})")

    p = path_epochs(torch, g, TIG)
    graph_checks(torch, KERNELS, p, TIG)
    prof1 = profile_train_steps(torch, p, TIG)
    engine.release(p["tables"])
    del p

    # phase 5b: SEP, then PAC on one card at P = 4 and 2, each path
    # counted from zero
    train_g, parts = pac_partitions(g)
    pac_small_agreement(torch)
    by_path = {"train_single": {n: launches[n] for n in TIG_PATH}}
    pac = {}
    for n_parts in PAC_PARTS:
        pac[n_parts] = pac_path(torch, KERNELS, g, train_g, parts[n_parts],
                                TIG)
        by_path[f"pac_p{n_parts}"] = pac[n_parts]["launches"]
    print("PAC beside train_single (one epoch, NVIDIA card above): "
          + "; ".join(
              [f"train_single {res.epoch_seconds[0]:.4f} s, val_ap "
               f"{res.val_ap:.6f}, test_ap {res.test_ap:.6f}"]
              + [f"P {n} {r['res'].epoch_seconds[0]:.4f} s (plan "
                 f"{r['res'].plan_seconds[0]:.4f} s), val_ap "
                 f"{r['res'].metrics['val_ap']:.6f}, test_ap "
                 f"{r['res'].metrics['test_ap']:.6f}, peak "
                 f"{r['peak']:.1f} MiB" for n, r in pac.items()]))
    ep4, union4 = pac_union(g, train_g, parts[PAC_PARTS[0]], TIG)
    pac_graph_checks(torch, KERNELS, ep4, union4, TIG)
    pac_extra = pac_kernel_checks(torch, dev, ep4, union4, TIG)
    del ep4, union4
    pac_prof = {n_parts: pac_profile(torch, pac_union(
        g, train_g, parts[n_parts], TIG, steps=GRAPH_STEPS)[1], TIG)
        for n_parts in PAC_PARTS}

    # phase 5c: the out-of-core data plane, each path counted from zero
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        sharded_parity(torch, g, Path(tmp))
        by_path["train_sharded"] = sharded_path(torch, KERNELS,
                                                Path(tmp))["launches"]
        p4 = PAC_PARTS[0]
        by_path[f"pac_p{p4}_shards"] = sharded_pac(
            torch, KERNELS, train_g, parts[p4], pac[p4], Path(tmp)
        )["launches"]
        node_class_agreement(torch)
        print(f"phase 5c: {time.perf_counter() - t0:.1f} s ({card})")

        # phase 5d: two attention layers; phase 5e: the restarter
        ml_paths, ml_extra = multilayer_phase(
            torch, KERNELS, dev, g, train_g, parts[p4], pac[p4],
            Path(tmp) / "parity", prof1)
        by_path.update(ml_paths)
        by_path.update(restart_phase(torch, KERNELS, g, train_g, parts[p4],
                                     res.params, Path(tmp)))
        # phase 5f: PAC over a mesh of ranks (NCCL, a world of one)
        by_path.update(mesh_phase(torch, KERNELS, g, train_g, parts[p4],
                                  pac[p4], pac_prof[p4], Path(tmp)))
    for n in TIG_PATH:
        launches[n] = sum(c[n] for c in by_path.values())

    wkv = wkv_checks(torch, dev)
    for r in wkv:
        print_kernel(r)
    lm_small_agreement(torch, "rwkv6-1.6b", 4, 8)
    # one chunked WKV launch per layer in forward (S 2048); generate feeds
    # its 32 prompt and 32 new tokens one at a time (S 1): 64 launches of
    # the sequential kernel per layer
    rwkv_launches = lm_path(torch, KERNELS, "rwkv6-1.6b", 4, 2048,
                            {"rwkv6": 1}, {"rwkv6_seq": 64})
    for name in ("rwkv6", "rwkv6_seq"):
        launches[name] = rwkv_launches[name]

    gru = gru_checks(torch, dev)
    for r in gru:
        print_kernel(r)
    gru_launches = gru_path(torch, KERNELS)
    # fused_gru_bwd runs on both paths: the TIG path's flush backward and
    # ops.gru's
    for name in ("fused_gru", "fused_gru_bwd"):
        launches[name] += gru_launches[name]
    by_path["ops_gru"] = {n: gru_launches[n]
                          for n in ("fused_gru", "fused_gru_bwd")}
    flash = flash_checks(torch, dev)
    for r in flash:
        print_kernel(r)
    # 56 prompt tokens and 16 generated: the ring buffer of the REDUCED
    # window of 64 wraps
    lm_small_agreement(torch, "starcoder2-3b", 56, 16)
    # 30 flash launches per forward; decode attends through the plain
    # decode attention, no kernel
    launches["flash_attention"] = lm_path(
        torch, KERNELS, "starcoder2-3b", 2, 8192, {"flash_attention": 1},
        {})["flash_attention"]

    def entry(r):
        return dict(
            name=r["name"], route="cuda",
            source=f"src/repro_torch/kernels/csrc/"
                   f"{KERNELS[r['name']].source}",
            replaces=TPU_KERNELS[r["name"]], launches=launches[r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["kernel"]["ms"],
            plain_ms=r["plain"]["ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            call_ms=r["kernel"]["call_ms"],
            plain_call_ms=r["plain"]["call_ms"]) | r.get("extra", {}) | (
                {"launches_by_path": {k: c[r["name"]] for k, c in
                                      by_path.items() if r["name"] in c}}
                if r["name"] in TIG_PATH else {}) | pac_extra.get(
                    r["name"], {}) | ({"multilayer": ml_extra}
                                      if r["name"] == "neighbor_sample"
                                      else {})

    def shaped_entry(main, rs):
        """The entry at the path's main shape; "shapes" holds them all."""
        e = entry(main)
        e["at"] = main["at"]
        e["shapes"] = [
            {k: v for k, v in entry(r).items() if k not in (
                "name", "route", "source", "replaces", "launches")}
            | {"label": r["label"], "at": r["at"]} for r in rs]
        return e

    # WKV: the prompt-scoring shape (the sequential kernel: decode); GRU:
    # TGN's updater shape; flash: the StarCoder2-3B forward's shape
    record = {"kernels": [entry(r) for r in recs] + [
        shaped_entry([r for r in wkv if r["name"] == name][-1],
                     [r for r in wkv if r["name"] == name])
        for name in ("rwkv6", "rwkv6_seq")] + [
        shaped_entry(next(r for r in gru if r["name"] == name),
                     [r for r in gru if r["name"] == name])
        for name in ("fused_gru", "fused_gru_bwd")] + [
        shaped_entry(flash[-1], flash)]}
    if len(record["kernels"]) != len(TPU_KERNELS):
        raise AssertionError("the record misses a kernel")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
