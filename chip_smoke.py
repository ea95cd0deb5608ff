#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card (name, power limit) and turn TF32 off;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (``neighbor_sample`` exactly, the others to
     1e-5), and time kernel, plain version, and, for the attention forward,
     ``F.scaled_dot_product_attention`` as a yardstick the port never calls;
  4. small-input agreement: one ``train_single`` epoch of a narrow TGN on
     the ``tiny`` graph, on the card and on the CPU (plain versions), from
     the same initial params;
  5. the TIG path: ``train_single(synthetic_tig("wikipedia-s",
     scale=10), TIG, epochs=1)`` — TGN at the paper's widths, ~525 train
     steps, then val and test scoring — with every kernel's launch count
     read around it; then where a train step's time goes;
  6. the WKV kernel against its plain version at the RWKV6 path's shapes
     (decode S 1 with a state, a ragged S 100 with a state, prompt scoring
     S 2048), timed beside its plain version;
  7. small-input agreement: REDUCED RWKV6 in float32, ``forward`` logits
     and 8 greedy ``generate`` tokens on the card against the CPU;
  8. the RWKV6 path at full width: RWKV6-1.6B (24 layers, d_model 2048,
     random params from a seed) ``forward`` on (4, 2048) tokens, then
     ``generate`` with batch 4, prompt 32, gen 32, greedy — launch counts
     read around each — and where a decode step's time goes.
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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5            # kernel vs plain version, float32 sums in another order
WKV_REL = 1e-5        # WKV: of the largest |plain| (float32, another order)
BF16_UNIT = 2.0 ** -7     # one bfloat16 unit, relative: two roundings
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
TPU_KERNELS = {               # the TPU kernel each CUDA kernel replaces
    "neighbor_sample": "src/repro/kernels/neighbor_sample.py:52",
    "fused_flush": "src/repro/kernels/fused_flush.py:53",
    "temporal_attn": "src/repro/kernels/temporal_attn.py:40",
    "temporal_attn_bwd": "src/repro/kernels/temporal_attn.py:84",
    "rwkv6": "src/repro/kernels/rwkv6_scan.py:39",
}
TIG_PATH = ("neighbor_sample", "fused_flush", "temporal_attn",
            "temporal_attn_bwd")
WKV_SHAPES = (        # (label, B, H, S, initial state): the RWKV6 path's
    ("decode", 4, 32, 1, True),          # serve_step at batch 4
    ("ragged", 4, 32, 100, True),        # a ragged prompt, with a state
    ("prompt", 4, 32, 2048, False),      # forward on (4, 2048) tokens
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


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


def device_spans(fn, attempts: int = 3) -> tuple[list, float]:
    """Run ``fn()`` under ``torch.profiler``; returns the device activity
    as sorted (start us, end us, name) spans, and the host wall time in ms
    from the first call to the last device completion. A profiled run that
    recorded no device activity at all (seen once on the card, mid-script,
    after earlier rounds had recorded) is run again, up to ``attempts``
    times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
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
    of them, and the profiler may miss one."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()

    per_round = []
    for _ in range(rounds):
        spans, _ = device_spans(run)
        per_round.append(sum(e - s for s, e, _ in spans) / iters)
    return statistics.median(per_round) / 1e3


def timings(fn) -> dict:
    return {"ms": device_ms(fn), "call_ms": call_ms(fn)}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


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


def kernel_checks(torch, dev, g, cfg):
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns one record per kernel."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_flush import fused_flush_fwd
    from repro_torch.kernels.neighbor_sample import neighbor_sample_fwd
    from repro_torch.kernels.temporal_attn import (temporal_attn_bwd,
                                                    temporal_attn_fwd)
    from repro_torch.tig.batching import build_batch_program
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.sampler import ChronoNeighborIndex
    from repro_torch.tig.train import epoch_rng

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    tr = split_views(g).train
    index = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes,
                                cfg.num_neighbors, cfg.batch_size)
    tcsr = {k: torch.from_numpy(v).to(dev)
            for k, v in index.device_export().items()}
    prog, _ = build_batch_program(tr, cfg, epoch_rng(0, 0, 1),
                                  index=index, plan="device")
    s = prog["src"].shape[0] // 2             # a batch mid-epoch
    b, k, d, h = cfg.batch_size, cfg.num_neighbors, cfg.dim, cfg.n_heads
    n_dump = g.num_nodes
    valid = np.tile(prog["valid"][s], 3)
    ids3 = np.concatenate([prog[r][s] for r in ("src", "dst", "neg")])
    nodes = torch.from_numpy(np.where(valid & (ids3 >= 0), ids3, 0)
                             .astype(np.int32)).to(dev)
    rows = nodes.shape[0]
    recs = []

    # --- neighbor_sample: exact
    targs = (tcsr["indptr"], tcsr["nbr"], tcsr["t"], tcsr["eidx"],
             tcsr["bat"], nodes, s, k)
    got = neighbor_sample_fwd(*targs)
    want = ref.sample_ref(*targs)
    torch.cuda.synchronize()
    exact = all(torch.equal(x, y) for x, y in zip(got, want))
    err = max_err(got, want)
    if not exact:
        raise AssertionError(f"neighbor_sample differs from sample_ref "
                             f"(max abs diff {err})")
    indptr = tcsr["indptr"].cpu().numpy()
    seg = (indptr[nodes.cpu().numpy() + 1] - indptr[nodes.cpu().numpy()])
    probes = np.ceil(np.log2(seg + 1.0)).sum()
    n_valid = int((got[0] >= 0).sum())
    nbytes = rows * 4 + rows * 8 + probes * 4 + n_valid * 12 + rows * k * 12
    recs.append(dict(name="neighbor_sample", max_abs_err=err,
                     kernel=timings(lambda: neighbor_sample_fwd(*targs)),
                     plain=timings(lambda: ref.sample_ref(*targs)),
                     bound=bound(float(nbytes), 0.0), library_ms=None))
    mask = got[0] >= 0                                    # (3B, K)

    # --- fused_flush: pending rows of this batch (src ++ dst, duplicates)
    ids = np.concatenate([prog["src"][s], prog["dst"][s]])
    ids = np.where(np.tile(prog["valid"][s], 2), ids, n_dump)
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    dm = cfg.msg_dim
    ts = torch.from_numpy(np.tile(prog["t"][s], 2)).to(dev)
    mem = randn(n_dump + 1, d, scale=0.5)
    mem[n_dump] = 0.0
    last = torch.clamp(ts.min() - randn(n_dump + 1).abs(), min=0.0)
    last[n_dump] = 0.0
    fargs = (ids, randn(2 * b, dm), ts, mem, last,
             randn(dm, 3 * d, scale=dm ** -0.5),
             randn(d, 3 * d, scale=d ** -0.5), randn(3 * d, scale=0.1),
             randn(3 * d, scale=0.1))
    err = max_err(fused_flush_fwd(*fargs), ref.flush_ref(*fargs))
    if err > TOL:
        raise AssertionError(f"fused_flush differs from flush_ref by {err}")
    ids_np = ids.cpu().numpy()
    first = [i for i, x in enumerate(ids_np)
             if x < n_dump and x not in ids_np[:i]]
    flops = len(first) * 2 * (dm + d) * 3 * d
    nbytes = (2 * b * (4 + dm * 4 + 4) + (dm + d + 2) * 3 * d * 4
              + 2 * (n_dump + 1) * (d + 1) * 4 + 2 * b * dm * 4)
    recs.append(dict(name="fused_flush", max_abs_err=err,
                     kernel=timings(lambda: fused_flush_fwd(*fargs)),
                     plain=timings(lambda: ref.flush_ref(*fargs)),
                     bound=bound(nbytes, flops), library_ms=None))

    # --- temporal attention at (3B, H, D / H) with the sampled mask
    dh = d // h
    q, kk, vv = (randn(rows, h, dh), randn(rows, k, h, dh),
                 randn(rows, k, h, dh))
    aargs = (q, kk, vv, mask)
    err = max_err([temporal_attn_fwd(*aargs)],
                  [ref.temporal_attention_ref(*aargs)])
    if err > TOL:
        raise AssertionError(f"temporal_attn differs from the ref by {err}")
    slots = int(mask.sum()) * h
    io = (q.numel() * 2 + kk.numel() * 2) * 4 + mask.numel()  # q k v m out
    io_bwd = (q.numel() * 3 + kk.numel() * 4) * 4 + mask.numel()
    # yardstick: SDPA over the rows with a neighbor, (B', H, 1, D)
    live = mask.any(-1)
    sq = q[live][:, :, None, :]
    sk = kk[live].transpose(1, 2).contiguous()
    sv = vv[live].transpose(1, 2).contiguous()
    sm = mask[live][:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs.append(dict(
        name="temporal_attn", max_abs_err=err,
        kernel=timings(lambda: temporal_attn_fwd(*aargs)),
        plain=timings(lambda: ref.temporal_attention_ref(*aargs)),
        bound=bound(io, 4 * dh * slots),
        library_ms=device_ms(lambda: sdpa(sq, sk, sv, attn_mask=sm))))

    gout = randn(rows, h, dh)
    got = temporal_attn_bwd(gout, *aargs)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, kk, vv))
    want = torch.autograd.grad(ref.temporal_attention_ref(qr, kr, vr, mask),
                               (qr, kr, vr), gout)
    err = max_err(got, want)
    if err > TOL:
        raise AssertionError(f"temporal_attn_bwd differs from autograd of "
                             f"the ref by {err}")

    def plain_bwd():
        torch.autograd.grad(ref.temporal_attention_ref(qr, kr, vr, mask),
                            (qr, kr, vr), gout)

    recs.append(dict(name="temporal_attn_bwd", max_abs_err=err,
                     kernel=timings(lambda: temporal_attn_bwd(gout, *aargs)),
                     plain=timings(plain_bwd),
                     bound=bound(io_bwd, 8 * dh * slots), library_ms=None))
    return recs


def profile_train_steps(torch, g, cfg, steps: int = 40) -> None:
    """Phase 6, where a train step's time goes: the first ``steps`` steps
    of the main path's epoch, warm, timed plain and then under
    ``torch.profiler`` (device activity only): device busy share and the
    device time by kernel."""
    from repro_torch.optim import adamw
    from repro_torch.tig.batching import build_batch_program, make_tables
    from repro_torch.tig.engine import scan_train_epoch
    from repro_torch.tig.models import init_params, init_state
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.sampler import ChronoNeighborIndex
    from repro_torch.tig.train import epoch_rng

    dev = torch.device("cuda")
    tr = split_views(g).train
    index = ChronoNeighborIndex(tr.src, tr.dst, tr.t, tr.eidx, g.num_nodes,
                                cfg.num_neighbors, cfg.batch_size)
    tcsr = {k: torch.from_numpy(v).to(dev)
            for k, v in index.device_export().items()}
    prog, _ = build_batch_program(tr, cfg, epoch_rng(0, 0, 1), index=index,
                                  plan="device")
    prog = {k: v[:steps] for k, v in prog.items()}
    tables = {k: torch.from_numpy(v).to(dev)
              for k, v in make_tables(g.edge_feat, g.node_feat).items()}
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    opt = adamw(1e-3, max_grad_norm=1.0)

    def run():
        scan_train_epoch(params, opt.init(params),
                         init_state(cfg, g.num_nodes, dev), prog, tables,
                         cfg=cfg, opt=opt, tcsr=tcsr)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    print_profile(f"{steps} train steps", run, steps, plain_wall)


def print_profile(label: str, run, steps: int, plain_wall: float) -> None:
    """Run ``run()`` (``steps`` steps, ``plain_wall`` ms unprofiled) under
    ``torch.profiler``; print the device busy and idle share of the
    profiled wall and the device time by kernel name."""
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
          f"unprofiled, {wall / steps:.3f} ms/step profiled; device busy "
          f"{busy / steps:.3f} ms/step ({busy / wall:.1%} of the profiled "
          f"wall, idle {1 - busy / wall:.1%}); {len(spans) / steps:.0f} "
          f"device ops/step")
    for key, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:12]:
        print(f"  {tot / 1e3 / steps:8.4f} ms/step  {n // steps:4d}x  {key}")


def small_agreement(torch):
    """Phase 4: the port on the card (kernels) against the port on the CPU
    (plain versions), one epoch of a narrow TGN on ``tiny``."""
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.models import TIGConfig, init_params
    from repro_torch.tig.train import train_single

    g = synthetic_tig("tiny")
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = train_single(g, cfg, epochs=1, params=p0, device="cuda")
    cpu = train_single(g, cfg, epochs=1, params=p0, device="cpu")
    # float32 sums in another order, compounded over 17 AdamW steps
    d_loss = abs(gpu.losses[0] - cpu.losses[0])
    d_ap = max(abs(gpu.val_ap - cpu.val_ap), abs(gpu.test_ap - cpu.test_ap))
    print(f"small agreement (card vs CPU): loss {gpu.losses[0]:.6f} vs "
          f"{cpu.losses[0]:.6f}, val_ap {gpu.val_ap:.6f} vs "
          f"{cpu.val_ap:.6f}, test_ap {gpu.test_ap:.6f} vs "
          f"{cpu.test_ap:.6f}")
    if not (d_loss <= 1e-4 and d_ap <= 1e-3):
        raise AssertionError(f"card and CPU disagree: loss {d_loss}, "
                             f"ap {d_ap}")


def wkv_checks(torch, dev) -> list:
    """Phase 6: the WKV kernel (through ``ops.rwkv6``, as the model calls
    it) against its plain version at the RWKV6 path's shapes; r, k, v in
    bfloat16 as the model gives them, w, u and the state in float32, all
    in the model's (B, S, H, 64) layout, which the plain versions read as
    (B, H, S, 64) views. The
    plain version is the token scan for S 1 and S 100 (the branch
    ``rwkv6_chunked_ref`` takes there) and the chunked algebra for S 2048:
    the scan's 2048 steps of small ops would take minutes to time."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    d = 64
    recs = []
    for label, b, h, s, with_state in WKV_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        r, k, v = (randn(b, s, h, d).bfloat16() for _ in range(3))
        # decays in (~0.7, 1), the regime of trained RWKV models
        w = torch.exp(-torch.exp(randn(b, s, h, d) * 0.5 - 2.0))
        u = randn(h, d) * 0.1
        state = randn(b, h, d, d) if with_state else None
        args = (r, k, v, w, u)
        fn = ref.rwkv6_ref if s <= 64 or s % 64 else ref.rwkv6_chunked_ref

        def plain(r, k, v, w, u, fn=fn, state=state):
            o, st = fn(*(x.transpose(1, 2) for x in (r, k, v, w)), u,
                       state=state, return_state=True)
            return o.transpose(1, 2), st

        got_o, got_s = ops.rwkv6(*args, state=state)
        want_o, want_s = plain(*args)
        torch.cuda.synchronize()
        if got_o.dtype != want_o.dtype:
            raise AssertionError(f"rwkv6 {label}: output {got_o.dtype}, "
                                 f"plain {want_o.dtype}")
        err = max_err([got_o, got_s], [want_o, want_s])
        go, wo = got_o.double(), want_o.double()
        atol = WKV_REL * max(1.0, float(wo.abs().max()))
        rtol = BF16_UNIT if got_o.dtype == torch.bfloat16 else 0.0
        s_err = float((got_s - want_s).abs().max())
        if not (bool(((go - wo).abs() <= atol + rtol * wo.abs()).all())
                and s_err <= WKV_REL * max(1.0, float(want_s.abs().max()))):
            raise AssertionError(f"rwkv6 {label} differs from its plain "
                                 f"version: max abs {err}")
        elt = r.element_size()
        nbytes = (3 * elt + 4 + got_o.element_size()) * b * h * s * d \
            + u.numel() * 4 + (2 if with_state else 1) * b * h * d * d * 4
        recs.append(dict(
            name="rwkv6", label=label, at=f"B {b}, H {h}, S {s}",
            max_abs_err=err, out_dtype=str(got_o.dtype).split(".")[-1],
            kernel=timings(lambda: ops.rwkv6(*args, state=state)),
            plain=timings(lambda: plain(*args)),
            bound=bound(nbytes, 5.0 * b * h * s * d * d), library_ms=None))
    return recs


def rwkv_small_agreement(torch):
    """Phase 7: REDUCED RWKV6 in float32, the port on the card (the WKV
    kernel) against the port on the CPU (the plain chunked version), from
    the same params: forward logits to 1e-4, 8 greedy tokens identical."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.serve import generate
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                              dtype="float32")
    p_cpu = model.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 128)))
    on_card = model.forward(p_gpu, {"tokens": tokens}, cfg)
    on_cpu = model.forward(p_cpu, {"tokens": tokens}, cfg, device="cpu")
    d_logit = float((on_card.cpu() - on_cpu).abs().max())
    a = generate(p_gpu, cfg, tokens[:, :4], 8)
    c = generate(p_cpu, cfg, tokens[:, :4], 8, device="cpu")
    print(f"small agreement RWKV6 REDUCED float32 (card vs CPU): forward "
          f"logits (2, 128) max abs diff {d_logit:.3g}; greedy tokens "
          f"{a.tokens.tolist()} vs {c.tokens.tolist()}")
    if not (d_logit <= 1e-4 and np.array_equal(a.tokens, c.tokens)):
        raise AssertionError("RWKV6 on the card and on the CPU disagree")


def rwkv_path(torch, kernels) -> int:
    """Phase 8: RWKV6-1.6B at its published widths, random params from a
    seed: ``forward`` on (4, 2048) tokens, then ``generate`` (batch 4,
    prompt 32, gen 32, greedy), launch counts zeroed before and read after
    each; then a profile of decode steps. Returns the WKV launches."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.serve import generate
    from repro_torch.tree import tree_leaves

    cfg = get_config("rwkv6-1.6b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_params(gen, cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"RWKV6-1.6B: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{n_params} params (float32, {cfg.dtype} compute), init "
          f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (4, 2048), generator=gen,
                           device=dev)
    logits = model.forward(params, {"tokens": tokens}, cfg)   # warm-up
    del logits
    torch.cuda.synchronize()

    def zero():
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()

    zero()
    t0 = time.perf_counter()
    logits = model.forward(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = {n: k.launches for n, k in kernels.items()}
    fwd_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    finite = bool(torch.isfinite(logits).all())
    shape, dtype = tuple(logits.shape), logits.dtype
    del logits
    print(f"RWKV6-1.6B forward (4, 2048): {fwd_s:.4f} s "
          f"({4 * 2048 / fwd_s:.0f} tok/s), logits {shape} {dtype} finite "
          f"{finite}, peak {fwd_peak:.1f} MiB, launches {fwd_launches}")

    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    zero()
    res = generate(params, cfg, prompts, 32)
    gen_launches = {n: k.launches for n, k in kernels.items()}
    gen_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"RWKV6-1.6B generate (batch 4, prompt 32, gen 32, greedy): "
          f"prefill {res.prefill_s:.4f} s, decode {res.decode_s:.4f} s "
          f"({4 * 32 / res.decode_s:.1f} tok/s, "
          f"{res.decode_s / 32 * 1e3:.3f} ms/step), peak {gen_peak:.1f} "
          f"MiB, launches {gen_launches}; first sequence "
          f"{res.tokens[0][:16].tolist()}")
    want_fwd = {n: cfg.n_layers if n == "rwkv6" else 0 for n in kernels}
    want_gen = {n: cfg.n_layers * 64 if n == "rwkv6" else 0
                for n in kernels}
    if not finite or shape != (4, 2048, cfg.vocab):
        raise AssertionError(f"forward logits {shape}, finite {finite}")
    if fwd_launches != want_fwd or gen_launches != want_gen:
        raise AssertionError(f"launches {fwd_launches} / {gen_launches}, "
                             f"expected {want_fwd} / {want_gen}")
    if res.tokens.shape != (4, 32) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"generated tokens {res.tokens}")

    # where a decode step's time goes: 8 warm serve_steps at batch 4
    cache = model.init_cache(cfg, 4)
    tok = torch.from_numpy(prompts[:, 0]).to(dev)

    def run(steps=8):
        c = cache
        for _ in range(steps):
            _, c = model.serve_step(params, c, {"token": tok}, cfg)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    print_profile("8 RWKV6-1.6B decode steps (batch 4)", run, 8,
                  (time.perf_counter() - t0) * 1e3)
    return fwd_launches["rwkv6"] + gen_launches["rwkv6"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.speed_tig import TIG
    from repro_torch.kernels.build import KERNELS, SOURCES, build_all
    from repro_torch.tig.data import synthetic_tig
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

    g = synthetic_tig("wikipedia-s", scale=10.0)
    print(f"data: wikipedia-s x10, {g.num_nodes} nodes, {g.num_edges} edges")
    recs = kernel_checks(torch, dev, g, TIG)
    for r in recs:
        print_kernel(r)

    small_agreement(torch)

    # the TIG path: counts from zero, read right after
    for kern in KERNELS.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_single(g, TIG, epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    print(f"main path: train_single TGN (dim {TIG.dim}, K "
          f"{TIG.num_neighbors}, batch {TIG.batch_size}) losses "
          f"{res.losses}, val_ap {res.val_ap:.6f}, test_ap "
          f"{res.test_ap:.6f}, test_ap_inductive {res.test_ap_inductive:.6f}"
          f", epoch_seconds {res.epoch_seconds}, wall {wall:.3f} s, peak "
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

    profile_train_steps(torch, g, TIG)

    wkv = wkv_checks(torch, dev)
    for r in wkv:
        print_kernel(r)
    rwkv_small_agreement(torch)
    launches["rwkv6"] = rwkv_path(torch, KERNELS)

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
            plain_call_ms=r["plain"]["call_ms"])

    # the WKV entry is its prompt-scoring shape; "shapes" holds all three
    wkv_entry = entry(wkv[-1])
    wkv_entry["at"] = wkv[-1]["at"]
    wkv_entry["shapes"] = [
        {k: v for k, v in entry(r).items() if k not in (
            "name", "route", "source", "replaces", "launches")}
        | {"label": r["label"], "at": r["at"]} for r in wkv]
    record = {"kernels": [entry(r) for r in recs] + [wkv_entry]}
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
