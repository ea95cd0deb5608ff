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
  5g. PAC's fault tolerance and overlapped epoch boundary at phase 5b's
     P 4 path: (a) two epochs of ``pac_train(epoch_boundary="overlap")``
     against ``"serial"``, launches counted from zero: losses, params,
     post-sync memories and metrics bitwise, launches equal to each
     other's and to phase 5b's steps; each run's epoch seconds, the
     sync's device µs (CUDA events around ``sync_shared_memory``) and
     whether it ran inside the next epoch's span; (b) an uninterrupted
     3-epoch run against a run with ``ckpt_every=1`` crashed by
     ``staging_oom@at=3`` and resumed: params, memories and epoch 2's
     losses bitwise, each snapshot's seconds and MiB; (c) the resumed
     run's ``eval_warm="restart"`` writes ``restarter.npz`` beside the
     checkpoints, and ``load_restarter`` of it is bitwise the head fitted
     in memory; (d) ``python -m repro_torch.launch.pac_cluster`` on one
     NCCL rank at ``tiny``: killed by ``host_kill@epoch=1`` (SIGKILL,
     epoch 0's checkpoint on disk), then ``--resume``d (``PAC_RESUME:
     step 0``) bitwise an undisturbed launcher run, and ``--elastic``
     with no fault exits 0 bitwise the plain run; (e) the ``speed-tig``
     CLI (``python -m repro_torch.launch.train --arch speed-tig
     --dataset small``) exits 0;
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
     time) and the shapes listed below, where faulty versions of the
     plain one (P in float8, a key tile dropped at the kernel's tiles;
     in float32 one tf32 pass and the edge tile dropped, which every
     float32 row must have) must fail the same check and two calls must
     agree bitwise, at a small ragged float32 shape without a window and
     at phase 26d's float32 training call (B 1, S 8192, 24 / 2 heads,
     window 4096), timed beside ``F.scaled_dot_product_attention`` with
     the same mask (in float32 at GQA with its GQA flag and over K / V
     expanded, the faster kept) and its bound (float32: the function's
     FLOPs three times at the TF32 rate, as 3xTF32 runs them; beside
     it, once at the CUDA cores' float32 rate);
 12. small-input agreement: REDUCED StarCoder2 in float32, ``forward``
     logits and 16 greedy ``generate`` tokens after a 56-token prompt (the
     ring buffer of the window of 64 wraps) on the card against the CPU;
 13. the StarCoder2 path at full width: StarCoder2-3B (30 layers, d_model
     3072, random params from a seed) ``forward`` on (2, 8192) tokens,
     with where its time goes, then ``generate`` with batch 4, prompt 32,
     gen 32, greedy — launch counts read around each — and where a decode
     step's time goes;
 14. small-input agreement: REDUCED OLMoE-1B-7B (MoE, qk-norm, SwiGLU)
     and Gemma-7B (GeGLU, tied embeddings) in float32, ``forward`` logits
     and aux and 16 greedy ``generate`` tokens on the card against the
     CPU;
 15. the MoE path at full width: OLMoE-1B-7B (16 layers, d_model 2048,
     64 experts top-8, random params from a seed) ``forward`` on (2,
     4096) tokens, a second call bitwise equal (the deterministic
     combine), with where its time goes, then ``generate`` with batch 4,
     prompt 32, gen 32, greedy, launch counts and peak memory read around
     each, and where a decode step's time goes;
 16. the same for Gemma-7B (28 layers, d_model 3072, head dim 256, tied
     embeddings), built after OLMoE-1B-7B is freed;
 17. the selective scan kernel (hymba's SSM heads; it replaces the JAX
     package's ``lax.scan`` in ``repro/models/ssm.py``, no TPU kernel)
     against its plain version at SCAN_SHAPES: Hymba-1.5B's forward (B 2,
     S 4096, d_inner 3200, state 16, bf16, zero state), a ragged S 333
     with a state in float32 and bf16, decode (B 4, S 1) with a state,
     a REDUCED shape (d_inner 256, state 8), and S 127 / 128 / 257 around
     the chunked form's threshold and chunk; the state to 1e-5 of its
     largest |plain|, y to 1e-5 of the largest |plain y| plus, in bf16,
     one bf16 unit of each element, for the form the wrapper picks (the
     chunked one from S 128, the per-state one below) and for both forms
     by name; faulty plain versions (dt x not rounded to bf16, the given
     state ignored) must fail the same limits against each form; each
     form's two calls bitwise equal at the forward shape; each shape
     timed beside its plain version and its bound (the SFU's
     exponentials at the forward shape);
 18. small-input agreement: REDUCED Hymba-1.5B in float32, ``forward``
     logits and 24 greedy ``generate`` tokens after a 24-token prompt
     (the ring of the window's 32 slots wraps) on the card against the
     CPU;
 19. the hybrid path at full width: Hymba-1.5B (32 layers, d_model 1600,
     25 / 5 heads of 64, window 1024, parallel mamba heads, random params
     from a seed) ``forward`` on (2, 4096) tokens (32 flash and 32 scan
     launches, nothing else; a second call bitwise equal), with where its
     time goes, then ``generate`` (batch 4, prompt 32, gen 32, greedy;
     2,048 scan launches, no flash), peak memory and a decode profile;
 20. the flash kernel at the last two families' shapes (FLASH_KEYS):
     SeamlessM4T-medium's non-causal encoder (B 2, S 1024, 16 / 16 heads
     of 64), its causal decoder (S 512) and its cross-attention (Sq 512
     over Sk 1024 keys, a key length of its own), ragged cross-attention
     (Sq 333, Sk 1000) in float32 and bf16, more queries than keys (Sq
     1024, Sk 256) and Qwen2-VL-7B's causal forward (B 2, S 4096, 28 / 4
     heads of 128), with phase 11's limits and faulty plain versions, one
     more where Sk > Sq (keys masked at Sq in place of Sk), each timed
     beside its plain version, SDPA and its bound;
 21. small-input agreement: REDUCED SeamlessM4T-medium (the bf16 encoder
     memories card vs CPU within two bf16 units of the largest, then the
     decoder from the CPU's memory on both) and Qwen2-VL-7B (16 patches
     with (t, h, w) positions) in float32, ``forward`` logits and 16
     greedy ``generate`` tokens on the card against the CPU;
 22. the encoder-decoder at full width: SeamlessM4T-medium (12 encoder
     and 12 decoder layers, d_model 1024, 16 / 16 heads of 64, vocab
     256,206) ``forward`` on (2, 512) tokens over (2, 1024) frames (36
     flash launches: 12 encoder, 12 self, 12 cross; a second call bitwise
     equal), ``generate`` with (4, 1024) frames (12 flash launches, the
     encoder once), peak memory and a decode profile;
 23. the vision-language path at full width: Qwen2-VL-7B (28 layers,
     d_model 3584, 28 / 4 heads of 128, M-RoPE) ``forward`` on 1,024
     patches and (2, 3072) tokens (28 flash launches, a second call
     bitwise equal), ``generate`` (no flash), peak memory and a decode
     profile;
 24. the flash backward kernel (dq, dk, dv; it replaces no TPU kernel:
     the JAX package differentiates ``chunked_attention`` as XLA)
     against its plain version at FLASH_BWD_CASES: StarCoder2-3B's
     training call (B 1, S 8192, 24 / 2 heads of 128, window 4096, bf16,
     and the same in float32: phase 26d's), Gemma-7B's (16 / 16 heads of
     256, causal), hymba's (25 / 5 heads of 64, window 1024), seamless's
     cross-attention (Sq 512 over Sk 1024),
     ragged cross-attention (Sq 333, Sk 1000) in float32 and bf16 and a
     REDUCED shape (D 32, S 100, float32, window 64), each of dq / dk /
     dv within 1e-5 of its largest |plain| plus, in bf16, one bf16 unit
     of each element; faulty plain versions (the D term omitted, dK / dV
     from the first query head of each group only, the key tile at each
     query block's window edge dropped from dQ, the tile as the built
     kernel reports it) must fail the same limits; two calls bitwise
     equal, one launch a call, and the kernels of one profiled call the
     two walks of its form (bf16: ``bwd_dkdv_wg`` / ``bwd_dq_wg``, at D
     256 ``bwd_dkdv_wg256`` / ``bwd_dq_wg256``; float32: ``bwd_dkdv_f32``
     / ``bwd_dkdv_sum_f32`` / ``bwd_dq_f32``); each shape timed beside
     its plain version, SDPA's backward (a yardstick the port never
     calls; the kernels of one profiled call name its backend; in
     float32 at GQA with its GQA flag and over K / V expanded, the
     faster kept) and its bound (float32: the function's FLOPs three
     times at the TF32 rate, as 3xTF32 runs them; beside it, once at
     the CUDA cores' float32 rate); then the forward at phase 11's
     StarCoder2-3B shape with and without its log-sum-exp, in turns;
 24b. the backward kernels of the two recurrences (each replaces XLA's
     gradient of the JAX package's recurrence): WKV's (``rwkv6_bwd``)
     at WKV_BWD_CASES (RWKV6-1.6B's training call, B 1, S 4096, 32 heads,
     bf16; REDUCED and ragged shapes in float32 with a state and a
     final-state cotangent; strong decays in float32 and bf16) and the
     selective scan's (``selective_scan_bwd``) at SCAN_BWD_CASES
     (Hymba-1.5B's training call, B 1, S 4096, di 3200, n 16, bf16;
     REDUCED, ragged with a state), against their plain versions: each
     gradient within 1e-5 of its largest |plain|, plus one bf16 unit of
     each element where it is returned in bf16; two calls bitwise equal,
     one launch a call; each call's launches profiled (each launch's
     device us, and the form that ran: WKV's chunked form, 64-token
     chunks with 8-token sub-chunk edge states on wgmma, and the scan's
     scanned form, 128-token chunks of runs of 16, at every case);
     faulty plain versions must fail: the carry dropped between the
     kernel's chunks (where a call has two), WKV without u's term, and at
     the new designs' seams the products of the sub-chunks between two
     reference points dropped (WKV) and the carry between the runs of a
     chunk dropped (the scan); each shape timed beside its plain version
     and its bound;
 25. small-input training agreement: REDUCED StarCoder2-3B, Minitron-4B,
     Qwen3-32B, Gemma-7B, OLMoE-1B-7B, SeamlessM4T-medium (with frames),
     Qwen2-VL-7B (with patches), RWKV6-1.6B and Hymba-1.5B in float32,
     three ``make_train_step`` steps on the card against the CPU from the
     same params: with ``sgd`` losses to 1e-5 relative and params to 1e-5
     of each leaf's largest (RWKV6, whose three steps amplify float32
     rounding past that: so step by step from the CPU's params, and
     over the three free steps to what one float32 unit of noise a step
     grows to on the CPU alone, STEPWISE_ARCHS), with ``train_lm``'s
     AdamW losses to 1e-4;
     each step's launches exactly ``train_launches`` (the forward kernels
     twice a layer, ``remat``; the backward kernels once); REDUCED
     StarCoder2-3B in its own bf16 compute (the backward's tensor-core
     form, window 64, ``remat`` on), three ``sgd`` steps card vs CPU:
     losses to 1e-2 relative, each leaf's update to 2e-2 of its largest,
     and a detached attention and a backward that ignores the window
     failing that limit;
 26. LM training at full width: StarCoder2-3B (30 layers, d_model 3072,
     3.18 B float32 params, random from a seed) with ``train_lm``'s
     AdamW on ``packed_batches`` (1, 8192) tokens, ``remat`` on, 4 steps
     counted from zero: each loss finite, step seconds, tokens/s, 60
     flash forward (30 and 30 recomputed) and 30 backward launches a
     step, nothing else, peak memory under the card's, and where a
     step's time goes (GEMMs, flash forward and backward, elementwise,
     the optimizer, idle); then a witness of the gradient: from the
     same params on one fixed batch, ``sgd`` at lr 0.25 / |g|^2, whose
     loss must fall at every step, the first drop within 0.5-1.5x of
     0.25 on the float32 loss; and why its losses rise: AdamW's on that
     batch;
 26b. RWKV6-1.6B (24 layers, d_model 2048, 32 WKV heads of 64, vocab
     65,536) and Hymba-1.5B (32 layers, d_model 1600, SSM di 3200, n
     16, window 1024) training at full width, as
     phase 26 on (1, 4096) tokens, 3 counted steps each: launches a step
     48 WKV forward and 24 WKV backward (RWKV6); 64 flash and 64 scan
     forward, 32 of each backward (hymba); the step's device busy ms,
     idle share and the backward kernels' share; the ``sgd`` witness, its
     first drop within 0.8-1.0 of 0.25 on the float32 loss;
 26c. Gemma-7B training at full width (d_model
     3072, 16 / 16 heads of 256, d_ff 24,576, vocab 256,000; 3.00 B
     float32 params) with its depth cut to 8 of 28 layers (at 28 its
     params, grads and AdamW's moments take 127.2 GiB), as phase 26 on
     (1, 4096) tokens, 3 counted steps: 16 flash forward and 8 backward
     launches a step (the backward's D 256 tensor-core form), nothing
     else; the ``sgd`` witness within phase 26's 0.5-1.5;
 26d. this slice's main path: StarCoder2-3B training at full width in
     float32 compute (``dataclasses.replace(cfg, dtype="float32")``;
     depth not cut), as phase 26 on (1, 8192) tokens, 3 counted steps:
     60 flash forward and 30 backward launches a step (the backward's
     float32 form, 3xTF32 on the tensor cores), nothing else; step
     seconds, tokens/s, peak memory under the card's, where a step's
     time goes with the flash backward's share; the ``sgd`` witness
     within phase 26's 0.5-1.5;
 27. the LM pretraining CLI: ``python -m repro_torch.launch.train --arch
     starcoder2-3b --reduced --steps 20 --batch 8 --seq 128`` exits 0
     with finite losses;
 28. the roofline and the dry run (``repro_torch.roofline``,
     ``repro_torch.launch.dryrun``): one eager TGN ``train_single`` step
     (phase 5's graph, ``TIG``) and one StarCoder2-3B bf16 training step
     at phase 26's (1, 8192), each counted by the step cost counter on
     the card and on ``meta`` copies of the same inputs: FLOPs and
     collective bytes equal, bytes within 1% (any aten op counted
     differently printed); ``mfu`` = 6 N_active D / (phase 26's median
     step seconds x 989 TFLOP/s), beside the counted FLOPs' share of that
     peak, labelled as such (the JAX program's FLOPs, masked attention
     chunks included, so not a utilisation); each training path's mfu at
     its dtype's peak; the dry run
     of each phase 26 path at its shape (StarCoder2-3B bf16 and float32,
     RWKV6-1.6B, Hymba-1.5B, Gemma-7B at 8 layers) and of Gemma-7B at 28
     layers, each report printed with its state + saved bytes beside the
     path's measured peak.
Phase 11 also holds the bf16 flash kernel at OLMoE-1B-7B's and
Gemma-7B's forward shapes (B 2, S 4096, 16 / 16 heads, D 128 and 256,
causal) and at hymba-1.5B's head dim 64 (25 / 5 heads, window 1024). After
phase 5g, phase 5h runs the ``host_replay`` oracle: ``pac_train(
host_replay=True)`` on 4 SEP parts of ``tiny`` at P 4 over two epochs,
bitwise the default run, its launches held to the lockstep steps.
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
# the H100 SXM's peaks, from the port's roofline: HBM3 bytes/s, float32
# FLOP/s outside the tensor cores, dense TF32 and bf16 on them
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.roofline.analysis import (  # noqa: E402
    BF16_FLOPS as BF16_FLOP_PER_S, FP32_FLOPS as FP32_FLOP_PER_S,
    HBM_BW as HBM_BYTES_PER_S, TF32_FLOPS as TF32_FLOP_PER_S)
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
# kernels that replace no TPU kernel (each a loop the JAX package leaves
# to XLA), and what each replaces there
NEW_KERNELS = {
    "selective_scan": "src/repro/models/ssm.py:79",    # lax.scan of step
    # XLA's gradient of chunked_attention (the TPU flash kernel has none)
    "flash_attention_bwd": "src/repro/models/layers.py:173",
    # XLA's gradients of the WKV path (rwkv6_chunked_xla; the TPU WKV
    # kernel has no VJP) and of mamba's scan under jax.checkpoint
    "rwkv6_bwd": "src/repro/kernels/ref.py:190",
    "selective_scan_bwd": "src/repro/models/ssm.py:79",
}
# H100 SXM: 132 SMs x 16 SFU results (MUFU.EX2) a clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) at the 1.98 GHz boost clock (data sheet)
SFU_EXP_PER_S = 132 * 16 * 1.98e9
SCAN_REL = 1e-5       # selective scan: of the largest |plain| y and state
SCAN_SHAPES = (       # (label, B, S, di, n, dtype, initial state)
    ("hymba forward", 2, 4096, 3200, 16, "bfloat16", False),
    ("ragged f32", 2, 333, 3200, 16, "float32", True),
    ("ragged bf16", 2, 333, 3200, 16, "bfloat16", True),
    ("decode", 4, 1, 3200, 16, "bfloat16", True),
    ("reduced", 2, 128, 256, 8, "float32", True),
    ("below the threshold", 2, 127, 3200, 16, "bfloat16", True),
    ("at the threshold", 2, 128, 3200, 16, "bfloat16", True),
    ("two chunks + 1", 2, 257, 3200, 16, "bfloat16", True),
)
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
# phase 11, flash at the causal LM paths' shapes: (label, B, Sq, Sk, H,
# Hkv, D, window, causal, dtype); the last, StarCoder2-3B's forward on (2,
# 8192) tokens, is the kernel's main shape in the record
FLASH_CASES = (
    ("ragged f32", 2, 300, 300, 8, 2, 64, None, True, "float32"),
    ("olmoe-1b-7b forward", 2, 4096, 4096, 16, 16, 128, None, True,
     "bfloat16"),
    ("gemma-7b forward", 2, 4096, 4096, 16, 16, 256, None, True, "bfloat16"),
    ("hymba-1.5b shape (D 64)", 2, 4096, 4096, 25, 5, 64, 1024, True,
     "bfloat16"),
    ("starcoder2-3b training f32", 1, 8192, 8192, 24, 2, 128, 4096, True,
     "float32"),
    ("starcoder2 forward", 2, 8192, 8192, 24, 2, 128, 4096, True,
     "bfloat16"),
)
# phase 20, flash's calls on the last two families' paths and at a key
# length of its own (non-causal, no window), in the same form
FLASH_KEYS = (
    ("seamless encoder", 2, 1024, 1024, 16, 16, 64, None, False,
     "bfloat16"),
    ("seamless decoder", 2, 512, 512, 16, 16, 64, None, True, "bfloat16"),
    ("seamless cross", 2, 512, 1024, 16, 16, 64, None, False, "bfloat16"),
    ("ragged cross f32", 2, 333, 1000, 16, 16, 64, None, False, "float32"),
    ("ragged cross bf16", 2, 333, 1000, 16, 16, 64, None, False,
     "bfloat16"),
    ("more queries than keys", 2, 1024, 256, 16, 16, 64, None, False,
     "bfloat16"),
    ("qwen2-vl forward", 2, 4096, 4096, 28, 4, 128, None, True, "bfloat16"),
)
GRAPH_STEPS = 40      # train steps of phase 5's graph checks, profile
SHARD_PARITY_EDGES = 16_384   # phase 5c's shards of phase 5's stream: 10,
                              # none a multiple of the batch
PAC_PARTS = (4, 2)    # SEP parts (= devices) of phase 5b's PAC paths
PAC_SEP_K = 0.05      # SEP's top-k hub fraction (paper §III-B default)
# torch.profiler's filler launches before and after the profiled work
PROFILE_FILL = (256, 64)
PROFILE_LOSS = {"rounds": 0, "before": [], "after": []}   # lost fillers


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


def device_spans(fn, attempts: int = 6,
                 pause: float = 0.1) -> tuple[list, float]:
    """Run ``fn()`` under ``torch.profiler``; returns the device activity
    as sorted (start us, end us, name) spans, and the host wall time in ms
    from the first call to the last device completion. On the card the
    profiler loses device events: whole rounds, or a round's first
    launches (19 of 20 GRU backward launches in one run, 17 of 20 flash
    launches in another). So the work is wrapped in PROFILE_FILL cheap
    filler launches (``torch.cuda._sleep``), left out of the spans; a
    round that lost every filler before the work, or one after it, is run
    again after a pause growing by ``pause`` seconds an attempt, up to
    ``attempts`` times, and then the most complete one is returned (said
    on stderr). Lost fillers are tallied in PROFILE_LOSS."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before, after = PROFILE_FILL
    best = None
    for attempt in range(attempts):
        time.sleep(pause * attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(before):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            for _ in range(after):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        rec = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        spans = [r for r in rec if "spin_kernel" not in r[2]]
        fill = [r[0] for r in rec if "spin_kernel" in r[2]]
        # fillers before the work start before its first span; with no
        # span recorded, the split is unknown and the round is run again
        first = spans[0][0] if spans else -math.inf
        n_before = sum(t < first for t in fill)
        n_after = len(fill) - n_before
        PROFILE_LOSS["rounds"] += 1
        PROFILE_LOSS["before"].append(before - n_before)
        PROFILE_LOSS["after"].append(after - n_after)
        if spans and n_before and n_after == after:
            return spans, wall
        if best is None or len(spans) > len(best[0]):
            best = spans, wall
        print(f"torch.profiler lost device events (fillers recorded: "
              f"{n_before} of {before} before, {n_after} of {after} "
              f"after; {len(spans)} spans of the work); running the round "
              f"again", file=sys.stderr)
    if not best[0]:
        raise RuntimeError(f"torch.profiler recorded no device activity "
                           f"in {attempts} attempts")
    print(f"torch.profiler: no complete round in {attempts} attempts; the "
          f"most complete kept ({len(best[0])} spans)", file=sys.stderr)
    return best


def profile_loss_line() -> str:
    """What PROFILE_LOSS tallied over the run."""
    b, a = PROFILE_LOSS["before"], PROFILE_LOSS["after"]
    return (f"torch.profiler over {PROFILE_LOSS['rounds']} profiled rounds "
            f"(fillers {PROFILE_FILL[0]} before, {PROFILE_FILL[1]} after "
            f"the work): fillers lost before the work in "
            f"{sum(x > 0 for x in b)} rounds (at most {max(b, default=0)}), "
            f"after it in {sum(x > 0 for x in a)} (at most "
            f"{max(a, default=0)})")


def launch_rounds(fn, done, rounds: int = 12) -> list:
    """The device spans of profiled rounds of ``fn()``, run until
    ``done(spans)`` holds of a round or ``rounds`` have run. The profiler
    loses device events but records none that did not run, so a check of
    what ``fn`` launches reads every round: a kernel ran if any round
    recorded it, and a round that recorded more launches than allowed
    is a fault."""
    out = []
    for _ in range(rounds):
        spans, _ = device_spans(fn, attempts=12, pause=0.25)
        out.append(spans)
        if done(spans):
            break
    return out


def device_ms(fn, iters: int = 20, rounds: int = 5,
              warmup: int = 5) -> float:
    """Device time per call of ``fn()``: the median, over the profiled
    rounds of ``iters`` calls each that recorded the most device
    operations of any round (``torch.profiler`` loses events, never
    adds them), of the round's summed kernel and copy durations over
    ``iters``. A round is summed whole, not cut into calls, because the
    ops of one call cannot be told from the next's: a library call may
    launch a varying number of them. A round the profiler records
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
        per_round.append((len(spans), sum(e - s for s, e, _ in spans)))
    if not per_round:
        print("device time from CUDA events (back to back): the profiler "
              "recorded no round", file=sys.stderr)
        return call_ms(fn, iters=iters, warmup=0)
    most = max(n for n, _ in per_round)
    kept = [t / iters for n, t in per_round if n == most]
    if len(kept) < len(per_round):
        print(f"torch.profiler lost device events in "
              f"{len(per_round) - len(kept)} of {len(per_round)} rounds "
              f"({sorted(n for n, _ in per_round)} ops); those left out",
              file=sys.stderr)
    return statistics.median(kept) / 1e3


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
        spans, _ = device_spans(lambda: [kernel_bwd() for _ in range(10)],
                                attempts=12, pause=0.25)
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
    spans, wall = device_spans(run, attempts=12, pause=0.25)
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


def host_replay_phase(torch, kernels) -> dict:
    """Phase 5h: the ``host_replay`` oracle on the card. ``pac_train`` on 4
    SEP parts of ``tiny`` on 4 devices, a narrow TGN, two epochs, from the
    same params: the default (device plan, the wrap-around on the device)
    against ``host_replay=True`` (host plan, grids replayed on the host),
    both replaying their captured PAC step; losses, params and post-sync
    memories bitwise. Launches counted from zero around the replay run and
    held to its lockstep steps: one launch of each kernel a step, but no
    sampling (the host plan samples on the host). Returns them."""
    from repro_torch.core import sep_partition
    from repro_torch.tig.data import synthetic_tig
    from repro_torch.tig.distributed import pac_train
    from repro_torch.tig.graph import chronological_split
    from repro_torch.tig.models import TIGConfig, init_params

    t_phase = time.perf_counter()
    g = synthetic_tig("tiny")
    tr = chronological_split(g)[0]
    cfg = TIGConfig(flavor="tgn", dim=16, dim_time=8, dim_edge=16,
                    dim_node=16, num_neighbors=4, n_heads=2, batch_size=50)
    part = sep_partition(tr.src, tr.dst, tr.t, g.num_nodes, 4, k=PAC_SEP_K)
    p0 = init_params(torch.Generator().manual_seed(0), cfg)
    kw = dict(num_devices=4, epochs=2, params=p0)
    base = pac_train(tr, part, cfg, **kw)
    reset_counts(torch, kernels)
    replay = pac_train(tr, part, cfg, host_replay=True, **kw)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()
                if n in TIG_PATH}
    same = same_pac(torch, base, replay)
    steps = replay.plan.steps
    print(f"phase 5h path: pac_train(host_replay=True) P 4 on tiny, 2 "
          f"epochs of {steps} lockstep steps (cycles "
          f"{replay.plan.n_batches.tolist()}, grid "
          f"{tuple(replay.plan.batches['src'].shape)}), bitwise the default "
          f"run: {same}; launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not (replay.plan.host_replay and same):
        raise AssertionError("pac_train(host_replay=True) differs from the "
                             "default run")
    want = {n: 0 if n == "neighbor_sample" else 2 * steps * per_step(n, cfg)
            for n in TIG_PATH}
    if launches != want:
        raise AssertionError(f"host replay launches {launches}, expected "
                             f"{want}")
    return launches


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


def wkv_bwd_bound(b, h, s, in_elt, with_state) -> tuple:
    """The least time of the WKV backward on the card, bounded as
    ``wkv_bound`` bounds the forward: its bytes (r, k, v, w, u, do and the
    states read once; dr, dk, dv, dw, du and the initial state's gradient
    written once) at the memory rate, or the operations of the chunked
    form (64-token chunks) at the rates its products use, whichever is
    larger. A chunk of n tokens takes five products of n x 64 x 64 (its
    state from the last, K^T V; the cotangent's carry, R^T dO; the inter-
    chunk terms of dr, dS S^T, of dk, V dS^T, and of dv, K dS) and five
    of the causal n x n x 64 (the scores R K^T, dA = dO V^T, and dr's,
    dk's and dv's intra-chunk terms dA K, dA^T R, A^T dO), each on the
    bf16 tensor cores in six passes for a float32 product, three where an
    operand is a bf16 v; on the CUDA cores in float32, the decay products
    and dw's reverse sum (4 operations an element each) and u's terms
    (9)."""
    d, c = 64, 64
    nbytes = ((6 * in_elt + 12) * b * h * s * d + 2 * h * d * 4
              + (3 if with_state else 0) * b * h * d * d * 4)
    v_passes = 3 if in_elt == 2 else 6
    bf16 = fp32 = 0.0
    for t0 in range(0, s, c):
        n = min(c, s - t0)
        bf16 += 2.0 * n * d * d * (2 * v_passes + 3 * 6)
        bf16 += 2.0 * (n * (n + 1) // 2) * d * (v_passes + 4 * 6)
        fp32 += 17.0 * n * d
    ops_ms = (bf16 / BF16_FLOP_PER_S + fp32 / FP32_FLOP_PER_S) * 1e3 * b * h
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


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


def lm_extras(torch, cfg, b: int, n_text: int, gen) -> dict:
    """The inputs beside the tokens of an LM's ``forward`` batch, drawn
    from ``gen`` on its device: the encoder-decoder's frames (b,
    frontend_tokens, d) and the vision-language family's patches (b, F =
    frontend_tokens, d), both N(0, 1) float32, with ``positions3`` (b, 3,
    F + n_text): the patches on a square grid (t 0, h the row, w the
    column), the text continuing from the grid's side on all three
    axes."""
    dev = gen.device
    shape = (b, cfg.frontend_tokens, cfg.d_model)
    if cfg.enc_dec:
        return {"frames": torch.randn(shape, generator=gen, device=dev)}
    if cfg.frontend != "vision":
        return {}
    f = cfg.frontend_tokens
    side = math.isqrt(f)
    idx = torch.arange(f, device=dev)
    grid = torch.stack([torch.zeros_like(idx), idx // side, idx % side])
    text = (torch.arange(n_text, device=dev) + side).expand(3, -1)
    return {"patches": torch.randn(shape, generator=gen, device=dev),
            "positions3": torch.cat([grid, text], 1).expand(b, -1, -1)}


def lm_small_agreement(torch, arch: str, prompt: int, gen: int) -> None:
    """Phases 7, 12, 14, 18 and 21: a REDUCED LM in float32, the port on
    the card (its kernel) against the port on the CPU (the plain
    version), from the same params and inputs (``lm_extras``): forward
    logits on (2, 128) tokens to 1e-4 and the MoE aux loss to 1e-5
    (float32 sums in another order), then ``gen`` greedy tokens after
    ``prompt`` prompt tokens, identical. The encoder-decoder's encoder
    runs in bf16 on both (as in the JAX package), each rounding its own
    float32 sums: its memories are held to two bf16 units of the largest
    |memory|, and the decoder's checks then run on both from the CPU's
    memory (``model.encode`` swapped for it)."""
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
    batch = {"tokens": tokens, **lm_extras(
        torch, cfg, 2, 128, torch.Generator().manual_seed(0))}
    encode = model.encode
    if cfg.enc_dec:
        mem_card = encode(p_gpu, batch["frames"], cfg).cpu().float()
        mem_cpu = encode(p_cpu, batch["frames"], cfg, device="cpu")
        d_mem = float((mem_card - mem_cpu.float()).abs().max())
        lim = 2 * BF16_UNIT * float(mem_cpu.float().abs().max())
        print(f"small agreement {arch} REDUCED: encoder memory "
              f"{tuple(mem_cpu.shape)} bf16, card vs CPU max abs diff "
              f"{d_mem:.3g} (limit {lim:.3g}: two bf16 units of the "
              f"largest)")
        if d_mem > lim:
            raise AssertionError(f"{arch}: the encoder on the card and on "
                                 f"the CPU disagree")
        model.encode = lambda params, frames, cfg, device=None: mem_cpu.to(
            params["embed"].device)
    try:
        on_card, aux_card = model.forward(p_gpu, batch, cfg)
        on_cpu, aux_cpu = model.forward(p_cpu, batch, cfg, device="cpu")
        frames = batch.get("frames")
        a = generate(p_gpu, cfg, tokens[:, :prompt], gen, frames=frames)
        c = generate(p_cpu, cfg, tokens[:, :prompt], gen, frames=frames,
                     device="cpu")
    finally:
        model.encode = encode
    d_logit = float((on_card.cpu() - on_cpu).abs().max())
    d_aux = abs(float(aux_card) - float(aux_cpu))
    print(f"small agreement {arch} REDUCED float32 (card vs CPU): forward "
          f"logits {tuple(on_cpu.shape)} max abs diff {d_logit:.3g}, aux "
          f"{float(aux_card):.6f} vs {float(aux_cpu):.6f}; greedy tokens "
          f"after {prompt} prompt tokens {a.tokens.tolist()} vs "
          f"{c.tokens.tolist()}")
    if not (d_logit <= 1e-4 and d_aux <= 1e-5
            and np.array_equal(a.tokens, c.tokens)):
        raise AssertionError(f"{arch} on the card and on the CPU disagree")


def lm_path(torch, kernels, arch: str, batch: int, seq: int,
            fwd_per_layer: dict, gen_per_layer: dict,
            bitwise: bool = False, enc_per_layer=None) -> dict:
    """Phases 8, 13, 15, 16, 19, 22 and 23: an LM at its published widths,
    random params from a seed: ``forward`` on (batch, seq) positions
    (tokens; the vision-language family's ``frontend_tokens`` patches
    and the rest tokens; the encoder-decoder's tokens beside
    ``frontend_tokens`` frames, from ``lm_extras``) and where its time
    goes, then ``generate`` (batch 4, prompt 32, gen 32, greedy; the
    encoder-decoder's frames (4, frontend_tokens, d)), launch counts
    zeroed before and read after each: each kernel of ``fwd_per_layer``
    that many times per layer in ``forward``, each of ``gen_per_layer``
    in ``generate``, each of ``enc_per_layer`` that many times per
    encoder layer in both (the encoder runs once in each), no other
    kernel. With ``bitwise`` a second ``forward`` must give the same
    logits and aux bit for bit. Then a profile of decode steps (from the
    filled encoder memory). Returns every kernel's launches over both."""
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
             f"{cfg.resolved_head_dim}, window {cfg.window}, qk-norm "
             f"{cfg.qk_norm}, {cfg.act}, tied {cfg.tie_embeddings}")
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff "
           f"{cfg.d_ff_expert} (capacity factor {cfg.capacity_factor})"
           if cfg.is_moe else f"d_ff {cfg.d_ff}")
    if cfg.ssm_state:
        heads += (f", parallel mamba heads (d_inner "
                  f"{cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, "
                  f"conv {cfg.ssm_conv})")
    if cfg.enc_dec:
        heads += (f", {cfg.n_enc_layers} encoder layers (non-causal) and "
                  f"cross-attention")
    if cfg.rope == "mrope":
        heads += f", M-RoPE sections {tuple(cfg.mrope_sections)}"
    print(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {heads}, "
          f"{ffn}, vocab {cfg.vocab}, {n_params} params (float32, "
          f"{n_params * 4 / 1e9:.2f} GB; {cfg.dtype} compute), init "
          f"{time.perf_counter() - t0:.2f} s")
    n_text = seq - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    fwd_batch = {"tokens": torch.randint(0, cfg.vocab, (batch, n_text),
                                         generator=gen, device=dev),
                 **lm_extras(torch, cfg, batch, n_text, gen)}
    inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in fwd_batch.items())
    logits, _ = model.forward(params, fwd_batch, cfg)   # warm-up
    del logits
    torch.cuda.synchronize()

    reset_counts(torch, kernels)
    t0 = time.perf_counter()
    logits, aux = model.forward(params, fwd_batch, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = {n: k.launches for n, k in kernels.items()}
    fwd_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    finite = bool(torch.isfinite(logits).all())
    shape, dtype = tuple(logits.shape), logits.dtype
    print(f"{arch} forward ({batch}, {seq}; {inputs}): {fwd_s:.4f} s "
          f"({batch * seq / fwd_s:.0f} positions/s), logits {shape} {dtype} "
          f"finite {finite}, aux {float(aux):.6f}, peak {fwd_peak:.1f} "
          f"MiB, launches {fwd_launches} ({card_line()})")
    if bitwise:
        again, aux2 = model.forward(params, fwd_batch, cfg)
        same = torch.equal(logits, again) and torch.equal(aux, aux2)
        print(f"{arch} forward: a second call bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{arch} forward differs between calls")
        del again
    del logits
    print_profile(f"{arch} forward ({batch}, {seq})",
                  lambda: model.forward(params, fwd_batch, cfg), 1,
                  fwd_s * 1e3)

    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    frames = lm_extras(torch, cfg, 4, 32, gen).get("frames")
    reset_counts(torch, kernels)
    res = generate(params, cfg, prompts, 32, frames=frames)
    gen_launches = {n: k.launches for n, k in kernels.items()}
    gen_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"{arch} generate (batch 4, prompt 32, gen 32, greedy): "
          f"prefill {res.prefill_s:.4f} s, decode {res.decode_s:.4f} s "
          f"({4 * 32 / res.decode_s:.1f} tok/s, "
          f"{res.decode_s / 32 * 1e3:.3f} ms/step), peak {gen_peak:.1f} "
          f"MiB, launches {gen_launches}; first sequence "
          f"{res.tokens[0][:16].tolist()} ({card_line()})")
    enc = {n: cfg.n_enc_layers * (enc_per_layer or {}).get(n, 0)
           for n in kernels}
    want_fwd = {n: cfg.n_layers * fwd_per_layer.get(n, 0) + enc[n]
                for n in kernels}
    want_gen = {n: cfg.n_layers * gen_per_layer.get(n, 0) + enc[n]
                for n in kernels}
    if not finite or shape != (batch, n_text, cfg.vocab):
        raise AssertionError(f"forward logits {shape}, finite {finite}")
    if fwd_launches != want_fwd or gen_launches != want_gen:
        raise AssertionError(f"launches {fwd_launches} / {gen_launches}, "
                             f"expected {want_fwd} / {want_gen}")
    if res.tokens.shape != (4, 32) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"generated tokens {res.tokens}")

    # where a decode step's time goes: 8 warm serve_steps at batch 4
    cache = model.init_cache(cfg, 4, 64, enc_len=0 if frames is None
                             else frames.shape[1])
    if frames is not None:
        cache = model.fill_enc_cache(params, cache, frames, cfg)
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


def scan_bound(b, s, di, n, elt, with_state) -> tuple:
    """The least time of the selective scan on the card: its bytes (x, dt,
    b and c read and y written in the compute dtype, a and the states in
    float32) at the memory rate, or its operations, whichever is larger:
    B S di n exponentials on the SFU (SFU_EXP_PER_S) beside 6 float32
    operations per state element and token (dt a, da h, u b, their sum, c
    h, the sum over n) and dt x per channel and token at the float32 rate,
    the slower of the two units."""
    nbytes = (elt * b * s * (3 * di + 2 * n) + 4 * di * n
              + (2 if with_state else 1) * 4 * b * di * n)
    exps = float(b) * s * di * n
    ops_ms = max(exps / SFU_EXP_PER_S,
                 (6.0 * exps + b * s * di) / FP32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def scan_inputs(torch, gen, dev, b, s, di, n, dtype, with_state) -> tuple:
    """The scan's inputs as the model makes them, from ``gen``: x, b and c
    standard normal, dt = softplus(N(-4, 0.5)) (the init's dt bias is
    -4.6), a = -(1..n) (``a_log = log(1..n)``), the state standard normal.
    Returns ((x, dt, b, c, a), state or None)."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(b, s, di).to(dtype)
    dt = F.softplus(randn(b, s, di) * 0.5 - 4.0).to(dtype)
    bm, cm = (randn(b, s, n).to(dtype) for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(di,
                                                                        1)
    return (x, dt, bm, cm, a), (randn(b, di, n) if with_state else None)


def scan_limit_ratio(torch, got, want, parts: bool = False):
    """The scan's largest error over its limit (at most 1 passes): the
    state to SCAN_REL of its largest |plain|; y to SCAN_REL of the largest
    |plain y|, plus in bfloat16 one bfloat16 unit of each element
    (BF16_UNIT: the kernel's and the plain version's roundings of y to
    bfloat16 may fall on the two sides of a boundary). ``parts``: (y's
    ratio, the state's) instead of the larger."""
    (y, h), (yw, hw) = got, want
    yd, ywd = y.double(), yw.double()
    lim = SCAN_REL * float(ywd.abs().max()) + (
        BF16_UNIT * ywd.abs() if y.dtype == torch.bfloat16 else 0.0)
    ratios = (float(((yd - ywd).abs() / lim).max()),
              float((h - hw).abs().max()) / (SCAN_REL
                                             * float(hw.abs().max())))
    return ratios if parts else max(ratios)


def scan_checks(torch, dev) -> list:
    """Phase 17: the selective scan kernel (through ``ops.selective_scan``,
    as ``mamba_apply`` calls it) against ``ref.selective_scan_ref`` on the
    card at SCAN_SHAPES: hymba-1.5B's forward from a zero state, a ragged S
    333 with a state in float32 and in bfloat16, decode (B 4, S 1) with a
    state, a REDUCED shape at n 8, and S 127 / 128 / 257 (the chunked
    form's threshold, a chunk edge) with a state. Inputs from
    ``scan_inputs``, limits those of ``scan_limit_ratio``. Two faulty
    plain versions must fail the same limits: one that forms dt x in
    float32, without the JAX package's bfloat16 rounding (at the bfloat16
    shapes with S > 1), and one that ignores the given state (at every
    shape with one). The call through ``ops.selective_scan`` (one
    launch, timed) runs the form the wrapper picks, bit for bit that form
    called by name; both forms by name are held to the limits and the
    controls at every shape, and each is called twice, bitwise equal, at
    the forward shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import selective_scan as sscan
    from repro_torch.kernels.build import KERNELS

    gen = torch.Generator(device=dev).manual_seed(5)
    kern = KERNELS["selective_scan"]
    recs = []

    def check(got, want) -> tuple:
        """(within the limits, max abs error, largest error / limit)."""
        (y, h), (yw, hw) = got, want
        ratio = scan_limit_ratio(torch, got, want)
        finite = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
        return finite and ratio <= 1.0, max_err([y, h], [yw, hw]), ratio

    for label, b, s, di, n, dt_name, with_state in SCAN_SHAPES:
        dtype = getattr(torch, dt_name)
        args, state = scan_inputs(torch, gen, dev, b, s, di, n, dtype,
                                  with_state)
        x, dt, bm, cm, a = args
        before = kern.launches
        got = ops.selective_scan(*args, state=state)
        launched = kern.launches - before
        want = ref.selective_scan_ref(*args, state=state)
        torch.cuda.synchronize()
        if launched != 1 or got[0].dtype != dtype or tuple(
                got[1].shape) != (b, di, n):
            raise AssertionError(f"selective_scan {label}: {launched} "
                                 f"launches, y {got[0].dtype}, state "
                                 f"{tuple(got[1].shape)}")
        form = "chunked" if sscan.takes_chunked(x, dt, bm, cm) else "state"
        ok, err, ratio = check(got, want)
        print(f"selective_scan {label}: the {form} form ran; max abs err "
              f"{err:.3g}, at most {ratio:.3g} of the limit")
        if not ok:
            raise AssertionError(f"selective_scan {label} differs from its "
                                 f"plain version ({ratio:.3g} of the limit)")
        controls = {}
        if dtype == torch.bfloat16 and s > 1:
            y32, h32 = ref.selective_scan_ref(x.float(), dt.float(), bm, cm,
                                              a, state=state)
            controls["dt x unrounded"] = (y32.to(dtype), h32)
        if with_state:
            controls["state ignored"] = ref.selective_scan_ref(*args)
        ratios, ctl = {}, {}
        for name, fn in (("state", sscan.selective_scan_state_fwd),
                         ("chunked", sscan.selective_scan_chunked_fwd)):
            out = fn(*args, state)
            if name == form and not (torch.equal(out[0], got[0])
                                     and torch.equal(out[1], got[1])):
                raise AssertionError(f"selective_scan {label}: the {name} "
                                     f"form by name differs from the call")
            ok_f, err_f, ratios[name] = check(out, want)
            print(f"  {name} form: max abs err {err_f:.3g}, "
                  f"{ratios[name]:.3g} of the limit")
            if not ok_f:
                raise AssertionError(f"selective_scan {label}: the {name} "
                                     f"form differs from its plain version "
                                     f"({ratios[name]:.3g} of the limit)")
            ctl[name] = {}
            for cname, faulty in controls.items():
                ok_c, err_c, ctl[name][cname] = check(out, faulty)
                print(f"    control ({cname}): max abs err {err_c:.3g}, "
                      f"{ctl[name][cname]:.3g} of the limit")
                if ok_c:
                    raise AssertionError(
                        f"the scan check passes a faulty plain version "
                        f"({cname}) against the {name} form at {label}")
            if label == "hymba forward":
                again = fn(*args, state)
                if not (torch.equal(out[0], again[0])
                        and torch.equal(out[1], again[1])):
                    raise AssertionError(f"selective_scan: two calls of the "
                                         f"{name} form differ")
                print(f"  {name} form: two calls bitwise equal")
                del again
            del out
        recs.append(dict(
            name="selective_scan", label=label,
            at=f"B {b}, S {s}, di {di}, n {n}"
               + (", with a state" if with_state else ""),
            out_dtype=dt_name, max_abs_err=err,
            kernel=timings(lambda: ops.selective_scan(*args, state=state)),
            plain=timings(lambda: ref.selective_scan_ref(*args,
                                                         state=state),
                          heavy=s > 64),
            bound=scan_bound(b, s, di, n, x.element_size(), with_state),
            library_ms=None,
            extra={"form": form, "limit_ratio": ratio,
                   "limit_ratio_by_form": ratios, "controls": ctl}))
        del got, want, controls, args, x, dt
        torch.cuda.empty_cache()
    return recs


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
            # the distinct kernels of 10 calls, over rounds until a round
            # recorded two: the profiler may lose launches, never add one
            def ten():
                for _ in range(10):
                    fused_gru_bwd(g, *args)

            def kernel_names(spans):
                return {n.replace("(anonymous namespace)::", "")
                        .split("(")[0] for _, _, n in spans}

            rounds = launch_rounds(ten, lambda sp: len(kernel_names(sp)) > 1)
            names = sorted(set().union(*map(kernel_names, rounds)))
            most = max(map(len, rounds))
            print(f"fused_gru_bwd {label}: {len(names)} device kernels per "
                  f"call (3 in the first version) {names}; launches of 10 "
                  f"calls recorded in {len(rounds)} profiled rounds "
                  f"{[len(sp) for sp in rounds]}")
            if len(names) != 2 or most > 20:
                raise AssertionError(f"fused_gru_bwd runs {names} (at most "
                                     f"{most} launches in 10 calls), "
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


def sdpa_forms(q, k, v, bf16: bool) -> dict:
    """The forms in which phases 11, 20 and 24 call
    ``F.scaled_dot_product_attention`` on the model-layout q (B, S, H, D),
    k, v (B, S, Hkv, D): {form: (q, k, v in (B, H, S, D), enable_gqa,
    query heads a KV head)}. With its GQA flag always; in float32 with
    fewer KV heads than query heads also over K / V expanded to every
    query head, which SDPA may send to another backend. Each form is
    timed and the faster is the yardstick."""
    g = q.shape[2] // k.shape[2]
    forms = {"GQA flag": (1, True)}
    if not bf16 and g > 1:
        forms["K / V expanded"] = (g, False)
    return {name: tuple(x.transpose(1, 2).repeat_interleave(
        1 if x is q else e, 1) for x in (q, k, v)) + (flag, e)
            for name, (e, flag) in forms.items()}


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


def flash_controls(torch, att, v, want, lim, window, bf16=True, qk=None,
                   causal=True, group=1) -> dict:
    """Faulty versions of the plain one, each with its output rounded as a
    kernel's is (bf16, or not in float32): in bf16, P rounded to bf16 (the
    flash kernel's first P V) and P rounded to float8 e4m3; in float32,
    one tf32 pass (q and k of ``qk``, v and P rounded to tf32, as 3xTF32
    without its lo parts); in both, the key tile at the lower edge of each
    query block's window (no window: key tile 0) dropped where the block
    has another, at the kernel's tiles (bf16: ``BLOCK_Q`` rows,
    ``BLOCK_KV[D]`` keys; float32: ``f32_tiles``' slots, two heads of a
    KV group on one slot's rows where ``group`` is even, else two slots'
    rows of one head), where some block has such a tile and another;
    where there are more keys than queries, the keys past the query length
    masked (a key length taken for the query length). Returns each one's
    (max |err|, max err / limit) against the plain float32 output."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (BLOCK_KV, BLOCK_Q,
                                                     f32_tiles)

    if bf16:
        block_q, block_kv = BLOCK_Q, BLOCK_KV.get(v.shape[-1], 128)
    else:
        _, slot, block_kv = f32_tiles(v.shape[-1])
        block_q = slot if group % 2 == 0 else 2 * slot
    pmax = att.amax(-1, keepdim=True)

    def rounded(dtype):    # P rounded as a kernel rounds exp(s - max)
        return ((att / pmax).to(dtype).float() * pmax) @ v

    def renormed(drop):
        kept = att.masked_fill(drop, 0.0)
        return (kept / kept.sum(-1, keepdim=True)) @ v

    def keeps_a_key(drop):
        return bool(drop.any()) and bool(
            (att.masked_fill(drop, 0.0).sum(-1) > 0).all())

    def one_tf32_pass():
        qt, kt = (tf32_round(torch, x.float()) for x in qk)
        pt = ref.flash_attention_probs(qt, kt, causal=causal, window=window)
        return tf32_round(torch, pt) @ tf32_round(torch, v)

    sq, sk = att.shape[-2:]
    qi = torch.arange(sq, device=att.device)[:, None]
    ki = torch.arange(sk, device=att.device)[None, :]
    q0 = qi // block_q * block_q
    edge = (q0 - window + 1).clamp(min=0) if window else torch.zeros_like(q0)
    edge_tile = (q0 >= (window or block_kv)) & (
        ki // block_kv == edge // block_kv)
    fns = {}
    if bf16:
        fns["P bf16"] = lambda: rounded(torch.bfloat16)
        fns["P e4m3"] = lambda: rounded(torch.float8_e4m3fn)
    elif qk is not None:
        fns["one tf32 pass"] = one_tf32_pass
    if keeps_a_key(edge_tile):
        fns["edge tile dropped"] = lambda: renormed(edge_tile)
    if sk > sq:
        fns["keys masked at Sq"] = lambda: renormed(
            (ki >= sq).expand(sq, -1))
    out = {}
    for name, fn in fns.items():
        got = fn()
        if bf16:
            got = got.to(torch.bfloat16).float()
        diff = (got - want).abs()
        out[name] = (float(diff.max()), float((diff / lim).max()))
        del got, diff
    return out


# the controls that must fail the check
FLASH_FAULTS = ("P e4m3", "edge tile dropped", "keys masked at Sq",
                "one tf32 pass")
# the controls every float32 row must have (and fail)
FLASH_F32_FAULTS = ("one tf32 pass", "edge tile dropped")


def flash_checks(torch, dev, cases) -> list:
    """Phases 11 and 20: the flash kernel against its plain version at
    ``cases`` ((label, B, Sq, Sk, H, Hkv, D, window, causal, dtype)), in
    float32 to 1e-5 and in bf16 to 2^-8 |plain| + ``FLASH_P_REL`` |P| |V|
    of the plain version's float32 output; two calls must agree bitwise
    and faulty versions of the plain one (``FLASH_FAULTS``, on batch row
    0, heads 0-3) must fail the same check. Yardstick:
    ``F.scaled_dot_product_attention`` with the causal flag (or the
    window's mask) and ``enable_gqa=True``, timed from the profiler and by
    CUDA events over back-to-back calls, as the kernel is (in float32 at
    GQA also over K / V expanded, the faster kept: ``sdpa_forms``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=dev).manual_seed(3)
    recs = []
    for label, b, sq, sk, h, hkv, d, window, causal, dtype in cases:
        dtype = getattr(torch, dtype)
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, sk, hkv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        args = (q, k, v)

        def kernel():
            return flash_attention_fwd(*args, causal=causal, window=window)

        got = kernel()
        if not torch.equal(got, kernel()):
            raise AssertionError(f"flash_attention {label}: two calls "
                                 f"differ")
        torch.cuda.synchronize()
        err = ratio = 0.0
        bf16 = dtype == torch.bfloat16
        ctl = {}
        for bi, hs, qc, kc, vc in head_chunks(*args):
            att = ref.flash_attention_probs(qc, kc, causal=causal,
                                            window=window)
            vf = vc.float()
            want = att @ vf      # the plain version before its output cast
            diff = (got[bi:bi + 1, :, hs].transpose(1, 2).float()
                    - want).abs()
            lim = (2 ** -8 * want.abs() + FLASH_P_REL * (att @ vf.abs())
                   if bf16 else torch.full_like(want, TOL))
            err = max(err, float(diff.max()))
            ratio = max(ratio, float((diff / lim).max()))
            if ratio > 1.0:
                raise AssertionError(f"flash_attention {label}: batch row "
                                     f"{bi}, heads {hs} differ from the "
                                     f"plain version by {float(diff.max())}"
                                     f" ({ratio:.3g} of the limit)")
            if bi == 0 and hs.start == 0:
                ctl = flash_controls(torch, att, vf, want, lim, window,
                                     bf16, qk=(qc, kc), causal=causal,
                                     group=h // hkv)
            del att, want, diff, lim
        print(f"flash {label}: max |kernel - plain| {err:.3g}, at most "
              f"{ratio:.3g} of the limit; two calls bitwise equal")
        for name, (e, r) in ctl.items():
            print(f"  control ({name}; batch row 0, heads 0-3): max "
                  f"|err| {e:.3g}, at most {r:.3g} of the limit")
            if name in FLASH_FAULTS and r <= 1.0:
                raise AssertionError(f"the flash check passes a faulty "
                                     f"version ({name}) at {label}")
        missing = [] if bf16 else [n for n in FLASH_F32_FAULTS
                                   if n not in ctl]
        if missing:
            raise AssertionError(f"flash {label}: no float32 control "
                                 f"{missing}")

        def plain():
            for _, _, qc, kc, vc in head_chunks(*args):
                ref.flash_attention_ref(qc, kc, vc, causal=causal,
                                        window=window)

        qi = torch.arange(sq, device=dev)[:, None]
        ki = torch.arange(sk, device=dev)[None, :]
        # without a window the causal flag, else the window's mask
        mask = None if window is None else (ki <= qi) & (ki > qi - window)
        heavy = sq * sk > 1024 * 1024
        forms = {}
        for form, (qt, kt, vt, gqa, _) in sdpa_forms(*args, bf16).items():
            def library(qt=qt, kt=kt, vt=vt, gqa=gqa):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=gqa)

            lib_err = float((library().transpose(1, 2).float()
                             - got.float()).abs().max())
            forms[form] = {
                "ms": device_ms(library, iters=5 if heavy else 20,
                                rounds=3 if heavy else 5),
                "call_ms": call_ms(library, iters=10 if heavy else 50)}
            print(f"SDPA {label} ({form}) vs the kernel: max abs diff "
                  f"{lib_err:.3g}; {forms[form]['ms'] * 1e3:.2f} us")
            del qt, kt, vt, library
        best = min(forms, key=lambda f: forms[f]["ms"])
        elt = q.element_size()
        nbytes = elt * (2 * q.numel() + k.numel() + v.numel())
        pairs = causal_pairs(sq, window) if causal else sq * sk
        flops = 4.0 * d * b * h * pairs
        recs.append(dict(
            name="flash_attention", label=label,
            at=f"B {b}, Sq {sq}, Sk {sk}, H {h}, Hkv {hkv}, D {d}, window "
               f"{window}, causal {causal}",
            out_dtype=str(dtype).split(".")[-1], max_abs_err=err,
            kernel=timings(kernel), plain=timings(plain, heavy=heavy),
            # float32 runs as 3xTF32: the function's FLOPs three times at
            # the TF32 rate
            bound=(bound(nbytes, flops, BF16_FLOP_PER_S) if bf16 else
                   bound(nbytes, 3 * flops, TF32_FLOP_PER_S)),
            library_ms=forms[best]["ms"],
            # CUDA events over back-to-back calls, beside the kernel's own
            # call_ms: a bound on each where the profiler loses events
            extra={"library_call_ms": forms[best]["call_ms"],
                   "library_form": best, "library_forms": forms,
                   "controls": {n: r for n, (_, r) in ctl.items()}}))
        print(f"SDPA {label} ({best}): "
              f"{recs[-1]['extra']['library_call_ms'] * 1e3:.2f}"
              f" us back to back (CUDA events)")
        if not bf16:
            # beside it, the function's FLOPs on the CUDA cores' float32
            # FMA
            recs[-1]["extra"]["fp32_fma_bound_ms"] = (
                flops / FP32_FLOP_PER_S * 1e3)
            print(f"flash {label}: bound {recs[-1]['bound'][0]:.4g} ms "
                  f"(3xTF32), on float32 FMA "
                  f"{recs[-1]['extra']['fp32_fma_bound_ms']:.4g} ms, kernel "
                  f"{recs[-1]['kernel']['ms']:.4g} ms, SDPA ({best}) "
                  f"{forms[best]['ms']:.4g} ms ({card_line()})")
        del got, args, q, k, v, mask
        torch.cuda.empty_cache()
    return recs


# phase 24, the flash backward: (label, B, Sq, Sk, H, Hkv, D, window,
# causal, dtype); the first, StarCoder2-3B's training call on (1, 8192)
# tokens, is the kernel's main shape in the record
FLASH_BWD_CASES = (
    ("starcoder2-3b training", 1, 8192, 8192, 24, 2, 128, 4096, True,
     "bfloat16"),
    ("starcoder2-3b training f32", 1, 8192, 8192, 24, 2, 128, 4096, True,
     "float32"),
    ("gemma-7b", 1, 4096, 4096, 16, 16, 256, None, True, "bfloat16"),
    ("hymba-1.5b", 1, 4096, 4096, 25, 5, 64, 1024, True, "bfloat16"),
    ("seamless cross", 1, 512, 1024, 16, 16, 64, None, False, "bfloat16"),
    ("ragged cross f32", 1, 333, 1000, 16, 16, 64, None, False, "float32"),
    ("ragged cross bf16", 1, 333, 1000, 16, 16, 64, None, False,
     "bfloat16"),
    ("reduced", 2, 100, 100, 8, 2, 32, 64, True, "float32"),
)
# the controls that must fail the backward's check
FLASH_BWD_FAULTS = ("D term omitted", "dK / dV from one head of a group",
                    "edge key tile dropped")


def flash_bwd_head(torch, q, k, v, o, lse, do, causal, window,
                   fault=None, tile=None):
    """The plain backward (``ref.flash_attention_bwd_ref``'s formulas) of
    one query head in float32: q, o, do (Sq, D), k, v (Sk, D), lse (Sq,);
    returns (dq, dk, dv) (the head's share of its KV head's dk, dv).
    ``fault``: "D term omitted" (dS = P dP) or "edge key tile dropped"
    (dQ's sum without, for each query block of the kernel's ``tile``
    (query rows, keys; ``flash_attention.bwd_dq_tile``), the key tile
    holding its window's first key, or key tile 0 without a window,
    where the block has another)."""
    from repro_torch.kernels import ref

    sq, d = q.shape
    sk = k.shape[0]
    m = ref.attention_mask(sq, sk, causal, window, q.device)
    s = (q @ k.T) * (1.0 / math.sqrt(d))
    p = torch.exp(s - lse[:, None]).masked_fill_(~m, 0.0)
    dv = p.T @ do
    dp = do @ v.T
    if fault != "D term omitted":
        dp -= (do * o).sum(-1, keepdim=True)
    ds = p.mul_(dp)
    del s, dp
    dk = (ds.T @ q) * (1.0 / math.sqrt(d))
    if fault == "edge key tile dropped":
        bq, bk = tile
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        q0 = qi // bq * bq
        edge = ((q0 - window + 1).clamp(min=0) if window
                else torch.zeros_like(q0))
        drop = (ki // bk == edge // bk) & (
            (q0 >= (window or bk)) if causal else (ki >= 0))
        ds = ds.masked_fill(drop & (sk > bk), 0.0)
    dq = (ds @ k) * (1.0 / math.sqrt(d))
    return dq, dk, dv


def flash_bwd_plain(torch, q, k, v, o, lse, do, causal, window):
    """The plain backward of a whole call, a query head at a time so its
    (Sq, Sk) tables stay small: (dq, dk, dv) float32 in the model's
    layout, dk and dv summed over each KV group in head order."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    f = [x.float() for x in (q, k, v, o, do)]
    dq = torch.empty_like(f[0])
    dk, dv = torch.zeros_like(f[1]), torch.zeros_like(f[2])
    for bi in range(b):
        for hh in range(h):
            kv = hh // group
            gq, gk, gv = flash_bwd_head(
                torch, f[0][bi, :, hh], f[1][bi, :, kv], f[2][bi, :, kv],
                f[3][bi, :, hh], lse[bi, hh], f[4][bi, :, hh], causal,
                window)
            dq[bi, :, hh] = gq
            dk[bi, :, kv] += gk
            dv[bi, :, kv] += gv
    return dq, dk, dv


def flash_bwd_ratio(torch, got, want, bf16: bool) -> float:
    """max |got - want| / limit over dq, dk, dv: 1e-5 of each one's
    largest |plain| (float32 sums in another order), plus in bf16 one
    bf16 unit (2^-7) of each element of the plain version rounded as the
    kernel's output is."""
    ratio = 0.0
    for g, w in zip(got, want):
        lim = TOL * float(w.abs().max())
        if bf16:
            lim = lim + BF16_UNIT * w.to(torch.bfloat16).float().abs()
        ratio = max(ratio, float(((g.float() - w).abs() / lim).max()))
    return ratio


def flash_bwd_controls(torch, q, k, v, o, lse, do, causal, window,
                       bf16: bool) -> dict:
    """Faulty plain versions on batch row 0 and the first KV group, held
    to the same limits against the plain one (rounded as the kernel's
    outputs are): each one's limit ratio."""
    from repro_torch.kernels.flash_attention import bwd_dq_tile

    group = q.shape[2] // k.shape[2]
    tile = bwd_dq_tile(q.shape[3], bf16)
    f = [x[0:1].float() for x in (q, k, v, o, do)]
    args = [f[0][0, :, :group], f[1][0, :, 0], f[2][0, :, 0],
            f[3][0, :, :group], lse[0, :group], f[4][0, :, :group]]

    def group_grads(fault=None, first_only=False):
        dq, dk, dv = [], 0, 0
        for hh in range(group):
            gq, gk, gv = flash_bwd_head(
                torch, args[0][:, hh], args[1], args[2], args[3][:, hh],
                args[4][hh], args[5][:, hh], causal, window, fault, tile)
            dq.append(gq)
            if hh == 0 or not first_only:
                dk, dv = dk + gk, dv + gv
        return torch.stack(dq, 1), dk, dv

    want = group_grads()
    faults = {"D term omitted": lambda: group_grads("D term omitted"),
              "edge key tile dropped": lambda: group_grads(
                  "edge key tile dropped")}
    if group > 1:
        faults["dK / dV from one head of a group"] = lambda: group_grads(
            first_only=True)
    out = {}
    for name, fn in faults.items():
        got = fn()
        if bf16:
            got = [x.to(torch.bfloat16) for x in got]
        out[name] = flash_bwd_ratio(torch, got, want, bf16)
    return out


def kernel_names(fn) -> list:
    """The device kernels of one call of ``fn`` (which SDPA backend ran),
    the longest first, each name cut to 90 characters, from one round of
    ``device_spans``."""
    fn()
    spans, _ = device_spans(fn)
    times = {}
    for start, end, name in spans:
        times[name[:90]] = times.get(name[:90], 0.0) + end - start
    return [f"{k} ({t:.1f} us)" for k, t in
            sorted(times.items(), key=lambda kv: -kv[1])]


def flash_bwd_checks(torch, dev, cases, fwd_main=None) -> list:
    """Phase 24: the flash backward kernel against its plain version at
    ``cases``: limits of ``flash_bwd_ratio``, two calls bitwise equal,
    one launch a call, faulty plain versions (``FLASH_BWD_FAULTS``, where
    one changes the call) failing the same limits; each shape timed
    beside the plain version, SDPA's backward alone (from one forward
    graph, the causal flag or the window's mask; the faster of
    ``sdpa_forms``) and its bound: 2.5x the forward's FLOPs (bf16 dense
    peak for bf16 inputs; three times at the TF32 rate for float32,
    which runs as 3xTF32) against the bytes of q, k, v, o, dO, lse, dq,
    dk, dv. Then the forward at StarCoder2-3B's
    serving shape with and without the log-sum-exp, in turns, beside
    phase 11's time (``fwd_main``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.build import KERNELS
    from repro_torch.kernels.flash_attention import (bwd_dq_tile,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)

    gen = torch.Generator(device=dev).manual_seed(24)
    recs = []
    for label, b, sq, sk, h, hkv, d, window, causal, dtype in cases:
        dtype = getattr(torch, dtype)
        bf16 = dtype == torch.bfloat16
        q, do = (torch.randn((b, sq, h, d), generator=gen,
                             device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, sk, hkv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        args = (q, k, v, o, lse, do)

        def kernel():
            return flash_attention_bwd(*args, causal=causal, window=window)

        before = KERNELS["flash_attention_bwd"].launches
        got = kernel()
        again = kernel()
        launches = KERNELS["flash_attention_bwd"].launches - before
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        want = flash_bwd_plain(torch, *args, causal, window)
        ratio = flash_bwd_ratio(torch, got, want, bf16)
        err = max(float((g.float() - w).abs().max())
                  for g, w in zip(got, want))
        del want
        ctl = flash_bwd_controls(torch, *args, causal, window, bf16)
        own = kernel_names(kernel)
        print(f"flash backward {label} (B {b}, Sq {sq}, Sk {sk}, H {h}, "
              f"Hkv {hkv}, D {d}, window {window}, causal {causal}, "
              f"{str(dtype)[6:]}): max |kernel - plain| {err:.3g}, at "
              f"most {ratio:.3g} of the limit; two calls bitwise equal "
              f"{same}; launches for two calls {launches}; dQ tile "
              f"{bwd_dq_tile(d, bf16)}; its kernels (one profiled call): "
              + "; ".join(own) + "; controls "
              + ", ".join(f"{n} {r:.3g}" for n, r in ctl.items()))
        if not (ratio <= 1.0 and same and launches == 2):
            raise AssertionError(f"flash backward fails at {label}")
        # bf16 takes the wgmma form, float32 the 3xTF32 one
        walks = (("bwd_dkdv_wg", "bwd_dq_wg") if bf16 else
                 ("bwd_dkdv_f32", "bwd_dkdv_sum_f32", "bwd_dq_f32"))
        if not all(any(w in n for n in own) for w in walks):
            raise AssertionError(f"flash backward at {label} ran {own}, "
                                 f"not {walks}")
        bad = [n for n, r in ctl.items() if n in FLASH_BWD_FAULTS
               and r <= 1.0]
        if bad:
            raise AssertionError(f"the flash backward check passes faulty "
                                 f"versions {bad} at {label}")

        def plain():
            flash_bwd_plain(torch, *args, causal, window)

        qi = torch.arange(sq, device=dev)[:, None]
        ki = torch.arange(sk, device=dev)[None, :]
        mask = None if window is None else (ki <= qi) & (ki > qi - window)
        ldo = do.transpose(1, 2)
        heavy = sq * sk > 1024 * 1024
        forms = {}
        for form, (lq, lk, lv, gqa, expand) in sdpa_forms(
                q, k, v, bf16).items():
            # the leaves of SDPA's backward, from one forward graph
            lq, lk, lv = (x.detach().requires_grad_(True)
                          for x in (lq, lk, lv))
            lout = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=gqa)

            def library(lout=lout, leaves=(lq, lk, lv)):
                return torch.autograd.grad(lout, leaves, ldo,
                                           retain_graph=True)

            def per_kv(x, expand=expand):
                return x.unflatten(1, (x.shape[1] // expand, expand)).sum(2)

            lib = library()
            lib_err = max(float(((x if x is lib[0] else per_kv(x)).transpose(
                1, 2).float() - y.float()).abs().max())
                          for x, y in zip(lib, got))
            del lib
            forms[form] = {
                "ms": device_ms(library, iters=3 if heavy else 20,
                                rounds=3 if heavy else 5),
                "call_ms": call_ms(library, iters=3 if heavy else 20),
                "kernels": kernel_names(library)}
            print(f"SDPA backward {label} ({form}) vs the kernel: max abs "
                  f"diff {lib_err:.3g}; {forms[form]['ms'] * 1e3:.2f} us; "
                  f"its kernels (one profiled call): "
                  + "; ".join(forms[form]["kernels"]))
            del lq, lk, lv, lout, library
        best = min(forms, key=lambda f: forms[f]["ms"])
        elt = q.element_size()
        # read q, k, v, o, dO and lse, write dq, dk, dv
        nbytes = (elt * (4 * q.numel() + 2 * (k.numel() + v.numel()))
                  + 4 * lse.numel())
        pairs = causal_pairs(sq, window) if causal else sq * sk
        flops = 2.5 * 4.0 * d * b * h * pairs
        recs.append(dict(
            name="flash_attention_bwd", label=label,
            at=f"B {b}, Sq {sq}, Sk {sk}, H {h}, Hkv {hkv}, D {d}, window "
               f"{window}, causal {causal}",
            out_dtype=str(dtype).split(".")[-1], max_abs_err=err,
            kernel=timings(kernel, heavy=heavy),
            plain=timings(plain, heavy=True),
            # float32 runs as 3xTF32: the function's FLOPs three times at
            # the TF32 rate
            bound=(bound(nbytes, flops, BF16_FLOP_PER_S) if bf16 else
                   bound(nbytes, 3 * flops, TF32_FLOP_PER_S)),
            library_ms=forms[best]["ms"],
            extra={"library_call_ms": forms[best]["call_ms"],
                   "limit_ratio": ratio, "controls": ctl,
                   "library_form": best,
                   "library_forms": {f: {"ms": r["ms"],
                                         "call_ms": r["call_ms"]}
                                     for f, r in forms.items()},
                   "library_kernels": forms[best]["kernels"]}))
        if not bf16:
            # beside it, the function's FLOPs on the CUDA cores' float32
            # FMA
            recs[-1]["extra"]["fp32_fma_bound_ms"] = (
                flops / FP32_FLOP_PER_S * 1e3)
            print(f"flash backward {label}: bound {recs[-1]['bound'][0]:.4g}"
                  f" ms (3xTF32), on float32 FMA "
                  f"{recs[-1]['extra']['fp32_fma_bound_ms']:.4g} ms, kernel "
                  f"{recs[-1]['kernel']['ms']:.4g} ms, SDPA ({best}) "
                  f"{forms[best]['ms']:.4g} ms ({card_line()})")
        print_kernel(recs[-1])
        del got, args, q, k, v, o, lse, do, ldo, mask
        torch.cuda.empty_cache()

    # the optional lse costs serving nothing: phase 11's StarCoder2-3B
    # forward with and without it, in turns
    b, s, h, hkv, d, window = 2, 8192, 24, 2, 128, 4096
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, hkv, d), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    runs = {"without lse": lambda: flash_attention_fwd(
        q, k, v, causal=True, window=window),
            "with lse": lambda: flash_attention_fwd(
        q, k, v, causal=True, window=window, return_lse=True)}
    turns = {n: [] for n in runs}
    for n in ("without lse", "with lse", "with lse", "without lse"):
        turns[n].append(call_ms(runs[n], iters=20))
    print("flash forward at StarCoder2-3B's serving shape (B 2, S 8192, "
          "24 / 2 heads, window 4096), us back to back in turns: "
          + "; ".join(f"{n} {' / '.join(f'{t * 1e3:.2f}' for t in ts)}"
                      for n, ts in turns.items())
          + ("" if fwd_main is None else
             f"; phase 11 device {fwd_main['ms'] * 1e3:.2f} us, back to "
             f"back {fwd_main['call_ms'] * 1e3:.2f} us")
          + f" ({card_line()})")
    recs[0]["extra"]["forward_lse_turns_ms"] = turns
    del q, k, v
    return recs


# phase 24b, the backward kernels of the two recurrences: (label, B, H, S,
# dtype, decays, with an initial state and a final-state cotangent); the
# first, RWKV6-1.6B's training call, is the kernel's main shape in the
# record
WKV_BWD_CASES = (
    ("rwkv6-1.6b training", 1, 32, 4096, "bfloat16", "trained", False),
    ("reduced", 2, 2, 64, "float32", "trained", False),
    ("ragged f32, state", 2, 2, 100, "float32", "trained", True),
    ("strong f32, state", 2, 4, 330, "float32", "strong", True),
    ("strong bf16, ragged", 2, 4, 333, "bfloat16", "strong", True),
)
# (label, B, S, di, n, dtype, with a state and its cotangent)
SCAN_BWD_CASES = (
    ("hymba-1.5b training", 1, 4096, 3200, 16, "bfloat16", False),
    ("reduced", 2, 64, 256, 8, "float32", False),
    ("ragged f32, state", 2, 333, 200, 16, "float32", True),
    ("ragged bf16, state", 2, 100, 3200, 16, "bfloat16", True),
)
# float32 operations a state element and token that the scan's backward
# needs (csrc/selective_scan_bwd.cu): dt a, h's update (3), g's (3), g
# h_{t-1} exp(dt a) (2) and the multiply-adds of dc, db, du, ddt, da (2
# each), and one exponential on the SFU; mamba-1's decay exp(dt a) differs
# for each (channel, state index), so no product form puts it on the
# tensor cores. WKV's is bounded by ``wkv_bwd_bound``.
SCAN_BWD_FLOPS = 19
RECUR_FAULTS = ("carry dropped between chunks", "u's term left out",
                "sub-chunk products dropped", "carry dropped between runs")
# the launches of each backward's design, in order: (kernel name as the
# profiler reports it, the form it marks)
RECUR_LAUNCHES = {
    "rwkv6_bwd": (("wkv_bwd_sum", "wkv_bwd_edges", "wkv_bwd_grad",
                   "wkv_bwd_du"), "chunked (64-token chunks, 8-token "
                  "sub-chunks, wgmma)"),
    "selective_scan_bwd": (("scan_bwd_sum", "scan_bwd_carry",
                            "scan_bwd_grad", "scan_bwd_reduce"),
                           "scanned (128-token chunks, runs of 16)")}


def scan_bwd_scanned(torch, x, dt, b, c, a, dy, state, dstate,
                     fault=None):
    """``ref.selective_scan_bwd_scanned_ref`` (the kernel's order);
    ``fault="run_carry"`` drops the carry between the runs inside a chunk
    (a faulty version for the controls)."""
    from repro_torch.kernels import ref

    return ref.selective_scan_bwd_scanned_ref(x, dt, b, c, a, dy,
                                              state=state, dstate=dstate,
                                              fault=fault)


def recur_ratio(torch, got, want, names) -> dict:
    """Each gradient's largest error over its limit (at most 1 passes):
    TOL (1e-5) of its largest |plain|, plus one bfloat16 unit (BF16_UNIT)
    of each element for the gradients returned in bfloat16 (both sides
    round the same float32 value once, and may round to the two sides of
    a boundary). None pairs are skipped."""
    out = {}
    for name, g, w in zip(names, got, want):
        if g is None and w is None:
            continue
        gd, wd = g.double(), w.double()
        lim = TOL * float(wd.abs().max()) + (
            BF16_UNIT * wd.abs() if g.dtype == torch.bfloat16 else 0.0)
        out[name] = float(((gd - wd).abs() / lim).max())
    return out


def wkv_bwd_plain(torch, r, k, v, w, u, do, state, dstate, *,
                  chunk=None, bonus=True):
    """``ref.rwkv6_bwd_ref`` in the model's layout. Faulty versions for
    the controls: ``chunk`` walks each run of ``chunk`` tokens back from a
    zero cotangent (the final state's in the last), dropping the carry
    between chunks, with each run's true starting state; ``bonus=False``
    leaves out u's term (u = 0 in the backward)."""
    from repro_torch.kernels import ref

    def heads(*xs):
        return [None if x is None else x.transpose(1, 2) for x in xs]

    if not bonus:
        u = torch.zeros_like(u)
    s = r.shape[1]
    cuts = [(0, s)] if chunk is None else [
        (t, min(t + chunk, s)) for t in range(0, s, chunk)]
    st, parts = state, []
    for t0, t1 in cuts:
        sl = [x[:, t0:t1] for x in (r, k, v, w, do)]
        last = t1 == s
        parts.append(ref.rwkv6_bwd_ref(*heads(*sl[:4]), u, *heads(sl[4]),
                                       state=st,
                                       dstate=dstate if last else None))
        if not last:
            _, st = ref.rwkv6_ref(*heads(*sl[:4]), u, state=st,
                                  return_state=True)
    cat = [torch.cat([p[i] for p in parts], 2).transpose(1, 2)
           for i in range(4)]
    du = sum(p[4] for p in parts)
    return (*cat, du, parts[0][5])


def wkv_bwd_chunked(torch, r, k, v, w, u, do, state, dstate, fault=None):
    """``ref.rwkv6_bwd_chunked_ref`` (the kernel's algebra) in the model's
    layout; ``fault="sub_ref"`` drops the products of the sub-chunks
    between two reference points (a faulty version for the controls)."""
    from repro_torch.kernels import ref

    got = ref.rwkv6_bwd_chunked_ref(
        *(x.transpose(1, 2) for x in (r, k, v, w)), u, do.transpose(1, 2),
        state=state, dstate=dstate, fault=fault)
    return (*(x.transpose(1, 2) for x in got[:4]), *got[4:])


def scan_bwd_plain(torch, x, dt, b, c, a, dy, state, dstate, *,
                   chunk=None):
    """``ref.selective_scan_bwd_ref``; with ``chunk``, the faulty version
    that walks each run of ``chunk`` tokens back from a zero carry (the
    final state's in the last), each from its true starting state."""
    from repro_torch.kernels import ref

    s = x.shape[1]
    cuts = [(0, s)] if chunk is None else [
        (t, min(t + chunk, s)) for t in range(0, s, chunk)]
    h, parts = state, []
    for t0, t1 in cuts:
        sl = [z[:, t0:t1] for z in (x, dt, b, c, dy)]
        last = t1 == s
        parts.append(ref.selective_scan_bwd_ref(
            *sl[:4], a, sl[4], state=h, dstate=dstate if last else None))
        if not last:
            _, h = ref.selective_scan_ref(*sl[:4], a, state=h)
    cat = [torch.cat([p[i] for p in parts], 1) for i in range(4)]
    da = sum(p[4] for p in parts)
    return (*cat, da, parts[0][5])


def launch_times(fn, calls: int = 3) -> dict:
    """The device time of each kernel ``fn()`` launches, us a call over
    ``calls`` profiled calls, by kernel name (namespaces and template
    arguments cut)."""
    def run():
        for _ in range(calls):
            fn()

    spans, _ = device_spans(run, attempts=6, pause=0.25)
    split: dict = {}
    for s0, e0, full in spans:
        key = full.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("<")[0].split("(")[0].split("::")[-1]
        split[key] = split.get(key, 0.0) + (e0 - s0) / calls
    return split


def launch_split(torch, name: str, fn, calls: int = 3) -> tuple:
    """``launch_times`` of ``fn()`` (one call of the backward ``name``),
    and the form that ran: RECUR_LAUNCHES' form if its launches, and only
    they, ran, each as ``classify`` names its part."""
    split = launch_times(fn, calls)
    want, form = RECUR_LAUNCHES[name]
    part = "WKV backward" if name == "rwkv6_bwd" else "scan backward"
    ok = set(split) == set(want) and all(classify(k) == part for k in want)
    return split, (form if ok else f"unexpected launches {sorted(split)}")


def wkv_bwd_inputs(torch, randn, case) -> tuple:
    """Phase 24b's inputs of a WKV_BWD_CASES case, from ``randn``: (r, k,
    v, w, u, do, state, dstate) in the model's layout, r, k, v in the
    case's dtype, do of its values in float32, the decays trained (w =
    exp(-exp(N(-2, 0.5)))) or strong (N(1.5, 0.5))."""
    _, b, h, s, dt_name, decays, with_state = case
    dtype = getattr(torch, dt_name)
    r, k, v = (0.3 * randn(b, s, h, 64) for _ in range(3))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    w = torch.exp(-torch.exp(
        randn(b, s, h, 64) * 0.5 + (1.5 if decays == "strong" else -2.0)))
    u = 0.5 * randn(h, 64)
    do = randn(b, s, h, 64).to(dtype).float()
    st = 0.3 * randn(b, h, 64, 64) if with_state else None
    dst = randn(b, h, 64, 64) if with_state else None
    return r, k, v, w, u, do, st, dst


def scan_bwd_inputs(torch, randn, case) -> tuple:
    """Phase 24b's inputs of a SCAN_BWD_CASES case, from ``randn``: (x,
    dt, b, c, a, dy, state, dstate), dt a softplus output ~0.02, a = -(1
    .. n), dy of the dtype's values in float32."""
    import torch.nn.functional as F

    _, b, s, di, n, dt_name, with_state = case
    dtype = getattr(torch, dt_name)
    dev = torch.device("cuda")
    x = randn(b, s, di).to(dtype)
    dt = F.softplus(randn(b, s, di) * 0.5 - 4.0).to(dtype)
    bm, cm = (randn(b, s, n).to(dtype) for _ in range(2))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(
        di, 1)
    dy = randn(b, s, di).to(dtype).float()
    h0 = randn(b, di, n) if with_state else None
    dh = randn(b, di, n) if with_state else None
    return x, dt, bm, cm, a, dy, h0, dh


def recur_bwd_checks(torch, dev) -> tuple[list, list]:
    """Phase 24b: the backward kernels of WKV (``rwkv6_bwd``) and of the
    selective scan (``selective_scan_bwd``), which replace XLA's
    gradients of the JAX package's recurrences, against their plain
    versions (``ref.rwkv6_bwd_ref``, ``ref.selective_scan_bwd_ref``) on
    the card at WKV_BWD_CASES and SCAN_BWD_CASES: the two training calls
    at full width (RWKV6-1.6B's 32 heads, Hymba-1.5B's di 3200, n 16, on
    (1, 4096) tokens, bf16), REDUCED shapes and ragged S with an initial
    state and a final-state cotangent, WKV also at strong decays
    (w = exp(-exp(N(1.5, 0.5)))). Every gradient within
    ``recur_ratio``'s limits; two calls bitwise equal; one launch a call.
    Faulty plain versions must fail the limits: the carry dropped between
    the kernel's chunks (both; where the call has more than one chunk), u's
    term left out (WKV), and at the new designs' own seams the products of
    the sub-chunks between two reference points dropped (WKV,
    ``rwkv6_bwd_chunked_ref``) and the carry between the runs inside a
    chunk dropped (the scan, ``selective_scan_bwd_scanned_ref``). Each
    call's launches profiled (``launch_split``: each launch's device us,
    and the form that ran, which must be the new one at every case). Each
    shape timed beside its plain version and its bound (``wkv_bwd_bound``;
    SCAN_BWD_FLOPS and the SFU's exponentials, against the bytes); no
    PyTorch call computes either function. The plain versions' times are
    CUDA events over one call (host-bound token loops)."""
    from repro_torch.kernels.build import KERNELS
    from repro_torch.kernels.rwkv6_scan import bwd_chunk, rwkv6_bwd
    from repro_torch.kernels.selective_scan import (bwd_tiles,
                                                    selective_scan_bwd)

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(33)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def run_case(kind, label, at, kern, call, plain, faults, names, bnd,
                 dtype):
        split, form = launch_split(torch, kern.name, call)
        print(f"{kind} backward {label}: form {form}; device us a call by "
              "launch " + ", ".join(f"{k} {v:.2f}" for k, v in
                                    split.items()))
        if form != RECUR_LAUNCHES[kern.name][1]:
            raise AssertionError(f"{kind} backward at {label}: {form}")
        before = kern.launches
        got = call()
        again = call()
        torch.cuda.synchronize()
        launches = kern.launches - before
        same = all(x is None or torch.equal(x, y)
                   for x, y in zip(got, again))
        del again
        want = plain()
        ratios = recur_ratio(torch, got, want, names)
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want) if g is not None)
        finite = all(bool(torch.isfinite(g).all()) for g in got
                     if g is not None)
        del want
        ctl = {n: max(recur_ratio(torch, got, f(), names).values())
               for n, f in faults.items()}
        print(f"{kind} backward {label} ({at}, {dtype}): max |kernel - "
              f"plain| {err:.3g}, over each gradient's limit "
              + ", ".join(f"{n} {r:.3g}" for n, r in ratios.items())
              + f"; two calls bitwise equal {same}; launches for two "
              f"calls {launches}; controls "
              + ", ".join(f"{n} {r:.3g}" for n, r in ctl.items()))
        if not (finite and max(ratios.values()) <= 1.0 and same
                and launches == 2):
            raise AssertionError(f"{kind} backward fails at {label}")
        bad = [n for n, r in ctl.items() if r <= 1.0]
        if bad:
            raise AssertionError(f"the {kind} backward check passes faulty "
                                 f"versions {bad} at {label}")
        # the plain versions are token loops of ~10 launches a token,
        # bound by the host (~50,000 launches a call at the training
        # shapes): timed by CUDA events over one call
        t_plain = call_ms(plain, iters=1, warmup=0)
        rec = dict(
            name=kern.name, label=label, at=at, out_dtype=dtype,
            max_abs_err=err, kernel=timings(lambda: call()),
            plain={"ms": t_plain, "call_ms": t_plain}, bound=bnd,
            library_ms=None,
            extra={"limit_ratios": ratios, "controls": ctl,
                   "bitwise_repeat": same, "form": form,
                   "launch_split_us": split})
        print_kernel(rec)
        return rec

    wkv = []
    for case in WKV_BWD_CASES:
        label, b, h, s, dt_name, decays, with_state = case
        args = wkv_bwd_inputs(torch, randn, case)
        r = args[0]
        wkv.append(run_case(
            "WKV", label, f"B {b}, S {s}, H {h}, {decays} decays"
            + (", with a state" if with_state else ""),
            KERNELS["rwkv6_bwd"], lambda: rwkv6_bwd(*args),
            lambda: wkv_bwd_plain(torch, *args),
            {**({RECUR_FAULTS[0]: lambda: wkv_bwd_plain(
                torch, *args, chunk=bwd_chunk())} if s > bwd_chunk()
                else {}),
             RECUR_FAULTS[1]: lambda: wkv_bwd_plain(torch, *args,
                                                    bonus=False),
             RECUR_FAULTS[2]: lambda: wkv_bwd_chunked(torch, *args,
                                                      fault="sub_ref")},
            ("dr", "dk", "dv", "dw", "du", "dstate0"),
            wkv_bwd_bound(b, h, s, r.element_size(), with_state),
            dt_name))
        del args, r
        torch.cuda.empty_cache()

    scan = []
    for case in SCAN_BWD_CASES:
        label, b, s, di, n, dt_name, with_state = case
        args = scan_bwd_inputs(torch, randn, case)
        elt = args[0].element_size()
        nbytes = (b * s * (4 * di + 4 * n) * elt + 4 * b * s * di
                  + 8 * di * n + (3 if with_state else 0) * b * di * n * 4)
        elems = float(b) * s * di * n
        ops_ms = max(elems / SFU_EXP_PER_S,
                     SCAN_BWD_FLOPS * elems / FP32_FLOP_PER_S) * 1e3
        bnd = bound(nbytes, 0.0)
        if ops_ms > bnd[0]:
            bnd = (ops_ms, "operations")
        scan.append(run_case(
            "scan", label, f"B {b}, S {s}, di {di}, n {n}"
            + (", with a state" if with_state else ""),
            KERNELS["selective_scan_bwd"],
            lambda: selective_scan_bwd(*args),
            lambda: scan_bwd_plain(torch, *args),
            {**({RECUR_FAULTS[0]: lambda: scan_bwd_plain(
                torch, *args, chunk=bwd_tiles()[0])} if s > bwd_tiles()[0]
                else {}),
             RECUR_FAULTS[3]: lambda: scan_bwd_scanned(
                 torch, *args, fault="run_carry")},
            ("dx", "ddt", "db", "dc", "da", "dstate0"), bnd, dt_name))
        del args
        torch.cuda.empty_cache()
    print(f"phase 24b: {time.perf_counter() - t_phase:.1f} s "
          f"({card_line()})")
    return wkv, scan


# phase 25: the families whose training runs on the card
TRAIN_ARCHS = ("starcoder2-3b", "minitron-4b", "qwen3-32b", "gemma-7b",
               "olmoe-1b-7b", "seamless-m4t-medium", "qwen2-vl-7b",
               "rwkv6-1.6b", "hymba-1.5b")
# seamless's bfloat16 encoder path: params held to the size of their
# update (see lm_train_agreement)
ENC_PATH = ("enc_layers", "enc_norm", "layers/cross/wk", "layers/cross/wv")
# REDUCED StarCoder2 in its own bfloat16 compute (the backward's
# tensor-core form, causal with a window, remat on), card vs CPU: losses
# as the CPU test holds them against JAX's in bf16, and each leaf's
# update to a share of its largest, the bound the CPU tests give a bf16
# path's gradients
BF16_LOSS_REL = 1e-2
BF16_UPDATE_REL = 2e-2
# families whose REDUCED sgd run (lr 0.5, 3 steps) amplifies float32
# rounding past the params limit. Their sgd params are held twice: step
# by step (each card step from the CPU's params and state, the params
# after it to 1e-5 of a leaf's largest), and over the three free steps
# to ``ulp_spread``, what one float32 unit of noise on every param at
# each step's start grows to on the CPU alone.
STEPWISE_ARCHS = ("rwkv6-1.6b",)


def ulp_spread(torch, step, p0, s0, batches) -> float:
    """The CPU's own float32 noise over ``batches`` steps of ``step`` from
    ``p0`` / ``s0``: for each step i, every param nudged by one float32
    unit (a random sign each, seed i) at step i's start and run to the
    end; the spreads (max |nudged - plain| / leaf's largest) summed over
    i. ``tests/test_torch_lm_train.py::test_ulp_spread`` reports it."""
    from repro_torch.tree import tree_leaves, tree_map

    def run(p, s, first):
        p, s = tree_map(torch.clone, p), tree_map(torch.clone, s)
        for b in batches[first:]:
            p, s, _ = step(p, s, b)
        return p

    plain = run(p0, s0, 0)
    total, p, s = 0.0, tree_map(torch.clone, p0), tree_map(torch.clone, s0)
    for i, b in enumerate(batches):
        gen = torch.Generator().manual_seed(i)

        def nudge(x):
            sign = torch.randint(0, 2, x.shape, generator=gen) * 2 - 1
            return torch.nextafter(x, sign.to(x.dtype) * math.inf)

        got = run(tree_map(nudge, p), s, i)
        total += max(float((x - y).abs().max()) / float(y.abs().max())
                     for x, y in zip(tree_leaves(got), tree_leaves(plain)))
        p, s, _ = step(p, s, b)
    return total


def named_leaves(tree, prefix="") -> list:
    """(path, leaf) pairs in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def train_launches(cfg, steps: int = 1) -> dict:
    """The kernel launches of ``steps`` training steps of ``cfg`` on the
    card, ``remat`` on: each layer's forward kernels twice (the step's
    forward and the backward's recomputation), its backward kernels once.
    Attention: the flash forward and backward a layer (an encoder layer
    one, a decoder layer of the encoder-decoder two: self and cross);
    RWKV6: WKV (S >= 64: the chunked forward kernel) and its backward;
    hymba: flash and the selective scan, each with its backward."""
    n = cfg.n_layers
    if cfg.rwkv:
        return {"rwkv6": 2 * n * steps, "rwkv6_bwd": n * steps}
    layers = n * (2 if cfg.enc_dec else 1) + cfg.n_enc_layers
    out = {"flash_attention": 2 * layers * steps,
           "flash_attention_bwd": layers * steps}
    if cfg.ssm_state:
        out |= {"selective_scan": 2 * n * steps,
                "selective_scan_bwd": n * steps}
    return out


def lm_train_agreement(torch, kernels) -> dict:
    """Phase 25: REDUCED ``TRAIN_ARCHS`` in float32, three
    ``make_train_step`` steps on the card against the CPU from the same
    params and batches (2 x 64 tokens, with ``lm_extras``): with ``sgd``
    losses to 1e-5 relative and params to 1e-5 of each leaf's largest
    (``STEPWISE_ARCHS``: so after each step from the CPU's params, and
    after the three free steps to ``ulp_spread``); with ``train_lm``'s
    AdamW and schedule losses to 1e-4. Seamless's encoder computes in
    bfloat16 on both devices, each rounding its own float32 sums: at each
    step both take the CPU's encoder memory as the value of their own
    encoder's output (the gradient flows through each one's encoder), and
    the params of the bfloat16 path (``ENC_PATH``) are held to 2^-6 of
    their largest update. Each card step launches ``train_launches`` and
    nothing else: RWKV6's WKV and hymba's scan go through their backward
    kernels. Returns the launches by kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.optim import adamw, linear_warmup_cosine, sgd
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    total: dict = {}
    real_encode = model.encode
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32")
        p0 = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
        rng = np.random.default_rng(0)
        batches = []
        for i in range(3):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 65)))
            batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:],
                            **lm_extras(torch, cfg, 2, 64,
                                        torch.Generator().manual_seed(i))})
        mem = {}

        def encode(params, frames, cfg, device=None):
            e = real_encode(params, frames, cfg, device)
            if e.device.type == "cpu":
                mem["cpu"] = e.detach()
                return e
            return mem["cpu"].to(e.device, e.dtype) + (e - e.detach())

        model.encode = encode
        try:
            out = {}
            for name, opt in (("sgd", sgd(0.5)), ("adamw", adamw(
                    lr=linear_warmup_cosine(3e-3, 20, 3), weight_decay=0.1,
                    max_grad_norm=1.0))):
                step_cpu = model.make_train_step(cfg, opt, device="cpu")
                step_gpu = model.make_train_step(cfg, opt)
                held = name == "sgd" and arch in STEPWISE_ARCHS
                for stepwise in (False, True) if held else (False,):
                    p_cpu = tree_map(torch.clone, p0)
                    p_gpu = tree_map(lambda x: x.cuda(), p0)
                    s_cpu, s_gpu = opt.init(p_cpu), opt.init(p_gpu)
                    losses, d_steps = [], []
                    for batch in batches:
                        p_cpu, s_cpu, m_cpu = step_cpu(p_cpu, s_cpu, batch)
                        reset_counts(torch, kernels)
                        p_gpu, s_gpu, m_gpu = step_gpu(p_gpu, s_gpu, batch)
                        torch.cuda.synchronize()
                        if stepwise:
                            d_steps.append(max(
                                float((a.cpu() - b).abs().max())
                                / float(b.abs().max()) for a, b in zip(
                                    tree_leaves(p_gpu), tree_leaves(p_cpu))))
                            p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
                            s_gpu = tree_map(lambda x: x.cuda(), s_cpu)
                        got = {n: k.launches for n, k in kernels.items()
                               if k.launches}
                        if got != train_launches(cfg):
                            raise AssertionError(
                                f"{arch} {name}: launches a step {got}; "
                                f"expected {train_launches(cfg)}")
                        for n, c in got.items():
                            total[n] = total.get(n, 0) + c
                        losses.append((float(m_gpu["loss"]),
                                       float(m_cpu["loss"])))
                    d_loss = max(abs(a - b) / abs(b) for a, b in losses)
                    d_par, d_enc = 0.0, 0.0
                    for (path, a), (_, b), (_, b0) in zip(
                            named_leaves(p_gpu), named_leaves(p_cpu),
                            named_leaves(p0)):
                        diff = float((a.cpu() - b).abs().max())
                        if cfg.enc_dec and path.startswith(ENC_PATH):
                            d_enc = max(d_enc, diff / float(
                                (b - b0).abs().max()))
                        else:
                            d_par = max(d_par, diff / float(b.abs().max()))
                    if stepwise:
                        d_par = max(d_steps)
                    lim = 1e-5
                    if held and not stepwise:
                        lim = ulp_spread(torch, step_cpu, p0, opt.init(p0),
                                         batches)
                    mode = ("step by step from the CPU's params"
                            if stepwise else "free")
                    out[name if not stepwise else "sgd stepwise"] = (
                        d_loss, d_par / lim, d_enc)
                    print(f"train agreement {arch} REDUCED float32, {name}, "
                          f"3 steps, {mode} (card vs CPU): losses {losses}, "
                          f"max relative loss diff {d_loss:.3g}, params max "
                          f"|diff| / leaf's largest {d_par:.3g}"
                          + (f" ({[f'{d:.3g}' for d in d_steps]})"
                             if stepwise else "")
                          + (f" (limit {lim:.3g}: ulp_spread, the CPU's "
                             f"own float32 noise over these steps)"
                             if held and not stepwise else "")
                          + (f", bf16 encoder path max |diff| / largest "
                             f"update {d_enc:.3g}" if cfg.enc_dec else ""))
                    if not all(math.isfinite(a) for a, _ in losses):
                        raise AssertionError(f"{arch}: non-finite loss")
        finally:
            model.encode = real_encode
        sg, aw = out["sgd"], out["adamw"]
        sw = out.get("sgd stepwise", (0.0, 0.0, 0.0))
        if not (sg[0] <= 1e-5 and sg[1] <= 1.0 and sg[2] <= 2 ** -6
                and sw[0] <= 1e-5 and sw[1] <= 1.0 and aw[0] <= 1e-4):
            raise AssertionError(f"{arch} trains differently on the card "
                                 f"and on the CPU (params over their "
                                 f"limit): {out}")
    bf16 = lm_train_bf16_agreement(torch, kernels)
    for n in bf16:
        total[n] += bf16[n]
    print(f"phase 25: {time.perf_counter() - t0:.1f} s ({card_line()})")
    return total


def lm_train_bf16_agreement(torch, kernels) -> dict:
    """Phase 25, in bf16: REDUCED StarCoder2 as configured (bfloat16
    compute, window 64, head dim 32: the flash backward's tensor-core
    form; ``remat`` on), three ``sgd`` steps of ``make_train_step`` on
    (2, 256) tokens on the card against the CPU from the same float32
    params. Each loss within ``BF16_LOSS_REL`` of the CPU's, each leaf's
    update (params less their start) within ``BF16_UPDATE_REL`` of the
    CPU's largest. Two faulty backwards on the card must fail the update
    limit: attention detached (no gradient through it, the fault a
    forward-only kernel had) and the window ignored in the backward.
    Returns the flash launches of the kernel's run."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models import model
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_map

    cfg = get_config("starcoder2-3b", reduced=True)
    p0 = model.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 257)))
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})

    def run(device):
        opt = sgd(0.5)
        params = tree_map(lambda x: x.to(device, copy=True), p0)
        state = opt.init(params)
        step = model.make_train_step(cfg, opt, device=device)
        losses = []
        for batch in batches:
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        return losses, params

    def detached(ctx, do):
        q, k, v = ctx.saved_tensors[:3]
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v), None, None)

    def window_ignored(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                     causal=ctx.causal, window=None),
                None, None)

    want_losses, want = run("cpu")
    ups = [(path, b - b0, float((b - b0).abs().max())) for (path, b), (
        _, b0) in zip(named_leaves(want), named_leaves(p0))]
    real = ops.FlashAttention.backward
    out = {}
    for name, fault in (("kernel", None), ("attention detached", detached),
                        ("window ignored in the backward", window_ignored)):
        if fault is not None:
            ops.FlashAttention.backward = staticmethod(fault)
        try:
            reset_counts(torch, kernels)
            losses, got = run("cuda")
            torch.cuda.synchronize()
            counts = {n: kernels[n].launches for n in (
                "flash_attention", "flash_attention_bwd")}
        finally:
            ops.FlashAttention.backward = real
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         want_losses))
        d_up = max(float(((a.cpu() - b0) - u).abs().max()) / top
                   for (_, a), (_, b0), (_, u, top) in zip(
                       named_leaves(got), named_leaves(p0), ups))
        out[name] = (losses, d_loss, d_up, counts)
        print(f"train agreement starcoder2-3b REDUCED bfloat16 (tensor-core "
              f"backward, window {cfg.window}, remat {cfg.remat}), sgd, 3 "
              f"steps, {name} (card vs CPU): losses "
              f"{list(zip(losses, want_losses))}, max relative loss diff "
              f"{d_loss:.3g} (limit {BF16_LOSS_REL}), updates max |diff| / "
              f"leaf's largest update {d_up:.3g} (limit "
              f"{BF16_UPDATE_REL}); flash launches {counts}")
    losses, d_loss, d_up, counts = out["kernel"]
    layers = cfg.n_layers * len(batches)
    if counts != {"flash_attention": 2 * layers,
                  "flash_attention_bwd": layers}:
        raise AssertionError(f"bf16 starcoder2: flash launches {counts}")
    if not (all(math.isfinite(x) for x in losses)
            and d_loss <= BF16_LOSS_REL and d_up <= BF16_UPDATE_REL):
        raise AssertionError(f"bf16 starcoder2 trains differently on the "
                             f"card and on the CPU: {out['kernel']}")
    passed = [n for n in out if n != "kernel"
              and out[n][2] <= BF16_UPDATE_REL]
    if passed:
        raise AssertionError(f"the bf16 training check passes faulty "
                             f"backwards {passed}")
    return counts


GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "Kernel2")
TRAIN_STEPS = 4       # phase 26's optimizer steps
SGD_DROP = 0.25       # phase 26's witness: sgd's first-order loss drop
SGD_DROP_RATIO = (0.5, 1.5)   # its measured drop over the prediction
# phase 26b: RWKV6-1.6B and Hymba-1.5B at full width on (1, 4096) tokens,
# each with the sgd witness, its first drop within 0.8-1.0 of the
# prediction
RECUR_TRAIN = ("rwkv6-1.6b", "hymba-1.5b")
RECUR_TRAIN_SEQ = 4096
RECUR_TRAIN_STEPS = 3
RECUR_DROP_RATIO = (0.8, 1.0)
# phase 26c: Gemma-7B at full width on (1, 4096) tokens, its depth cut to
# 8 of 28 layers (at 28, params, grads and AdamW's moments take 127.2 GiB
# of float32 state, past the card's 80 GB); the witness as phase 26's
GEMMA_TRAIN = "gemma-7b"
GEMMA_TRAIN_LAYERS = 8
GEMMA_TRAIN_SEQ = 4096
GEMMA_TRAIN_STEPS = 3
# phase 26d: StarCoder2-3B at full width in float32 compute on (1, 8192)
# tokens, depth not cut (the flash backward's float32 form on the main
# path); the witness as phase 26's
F32_TRAIN_SEQ = 8192
F32_TRAIN_STEPS = 3


def classify(name: str) -> str:
    """The part of a training step a device kernel belongs to."""
    if name.startswith(("fa_bf16_kernel", "fa_f32_tc_kernel")):
        return "flash forward"
    if name.startswith("bwd_"):
        return "flash backward"
    if "wkv_bwd" in name:
        return "WKV backward"
    if "wkv_" in name:
        return "WKV forward"
    if "scan_bwd" in name:
        return "scan backward"
    if "selective_scan_kernel" in name or name.endswith(
            "::chunked_kernel"):
        return "scan forward"
    if any(g in name for g in GEMM_NAMES):
        return "GEMMs"
    return "elementwise and other"


def step_breakdown(torch, label: str, run) -> dict:
    """``run()`` under ``torch.profiler``: device time by part
    (``classify``), device busy and the idle share of the wall; prints
    the parts and the top kernels."""
    spans, wall = device_spans(run, attempts=6, pause=0.25)
    busy, end = 0.0, -math.inf
    parts: dict = {}
    by_name: dict = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        key = name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("<")[0].split("(")[0][:60]
        part = classify(key)
        parts[part] = parts.get(part, 0.0) + (e - s) / 1e3
        tot, n = by_name.get(key, (0.0, 0))
        by_name[key] = (tot + e - s, n + 1)
    busy /= 1e3
    print(f"profile: {label}: wall {wall:.1f} ms, device busy {busy:.1f} "
          f"ms (idle {1 - busy / wall:.1%}), {len(spans)} device ops; "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
              parts.items(), key=lambda kv: -kv[1])))
    for key, (tot, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"  {tot / 1e3:9.3f} ms  {n:5d}x  [{classify(key)}]  {key}")
    return {"wall_ms": wall, "busy_ms": busy, "parts_ms": parts}


def lm_train_path(torch, kernels, arch="starcoder2-3b", seq=8192,
                  steps=TRAIN_STEPS, drop_ratio=SGD_DROP_RATIO,
                  layers=None, dtype=None) -> dict:
    """Phase 26 (StarCoder2-3B: 30 layers, d_model 3072, 3.18 B float32
    params), phase 26b (RWKV6-1.6B, Hymba-1.5B), phase 26c (Gemma-7B,
    ``layers`` 8 of its 28) and phase 26d (StarCoder2-3B, ``dtype``
    float32): ``arch`` at full width, its depth cut to ``layers`` where
    given (random params from a seed, the config's bf16 compute or
    ``dtype``) with
    ``train_lm``'s optimizer (AdamW, linear warm-up and cosine decay,
    weight decay 0.1, clipping at 1.0) on ``packed_batches`` (1,
    ``seq``) tokens, ``remat`` on: one warm step, then ``steps`` steps
    with the launch counts zeroed before and read after
    (``train_launches`` and nothing else), each loss finite, step
    seconds, tokens/s, peak memory under the card's; then where one more
    step's time goes (its gradient and its optimizer update profiled
    apart), and ``sgd_witness``. Returns the launches, ``cfg`` and the
    schedule's length ``total``."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data import LMDataConfig, packed_batches
    from repro_torch.models import model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = full = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(full, n_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    per_layer = sum(x.numel() for x in tree_leaves(
        params["layers"])) // cfg.n_layers
    n_full = n_params + per_layer * (full.n_layers - cfg.n_layers)
    total = steps + 2
    opt = adamw(lr=linear_warmup_cosine(3e-3, 20, total), weight_decay=0.1,
                max_grad_norm=1.0)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    shape = ((f"{cfg.n_layers} of {full.n_layers} layers (depth cut: "
              f"{16 * n_full / 2 ** 30:.1f} GiB of float32 state at "
              f"{full.n_layers})" if cfg.n_layers < full.n_layers else
              f"{cfg.n_layers} layers") + f", d_model {cfg.d_model}, "
             + (f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of "
                f"{cfg.rwkv_head_dim}" if cfg.rwkv else
                f"{cfg.n_heads} / {cfg.n_kv_heads} heads of "
                f"{cfg.resolved_head_dim}, window {cfg.window}")
             + (f", SSM di {cfg.ssm_expand * cfg.d_model}, n "
                f"{cfg.ssm_state}" if cfg.ssm_state else "")
             + f", d_ff {cfg.d_ff}")
    print(f"{arch} training: {shape}, vocab {cfg.vocab}, {n_params} "
          f"float32 params ({16 * n_params / 2 ** 30:.1f} GiB with grads "
          f"and AdamW's moments), {cfg.dtype} compute, remat {cfg.remat}; "
          f"init {time.perf_counter() - t0:.2f} s")
    step = model.make_train_step(cfg, opt)
    data = packed_batches(LMDataConfig(vocab=cfg.vocab, seq_len=seq,
                                       global_batch=1, seed=0))

    def batch():
        return {k: torch.from_numpy(v).to(dev) for k, v in next(
            data).items()}

    params, opt_state, m = step(params, opt_state, batch())     # warm
    torch.cuda.synchronize()
    print(f"{arch} warm step: loss {float(m['loss']):.4f}")
    batches = [batch() for _ in range(steps)]
    reset_counts(torch, kernels)
    secs, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))      # synchronizes
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    print(f"{arch} training (1, {seq}) tokens, {steps} steps: "
          f"losses {losses}, step seconds {[round(s, 4) for s in secs]}, "
          f"tokens/s {[round(seq / s, 1) for s in secs]} (median "
          f"{seq / statistics.median(secs):.1f}), peak "
          f"{peak / 2 ** 30:.2f} GiB of {card_bytes / 2 ** 30:.2f} GiB, "
          f"launches { {n: c for n, c in launches.items() if c} } "
          f"({card_line()})")
    want = train_launches(cfg, steps)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if {n: launches[n] for n in want} != want or any(
            c for n, c in launches.items() if n not in want):
        raise AssertionError(f"launches {launches}, expected {want}")
    if peak >= card_bytes:
        raise AssertionError(f"peak {peak} bytes over the card's")

    # where one more step's time goes: its gradient, then its update
    b = batch()
    grads = {}

    def grad_part():
        grads.clear()            # a round run again frees the last first
        grads["g"] = model._grads(params, b, cfg, dev)[1]

    def opt_part():
        it = iter(grads["g"])
        opt.apply_(tree_map(lambda _: next(it), params), opt_state,
                   params)

    g_prof = step_breakdown(torch, f"{arch} step, loss and gradient",
                            grad_part)
    o_prof = step_breakdown(torch, f"{arch} step, AdamW update (apply_)",
                            opt_part)
    wall = g_prof["wall_ms"] + o_prof["wall_ms"]
    parts = dict(g_prof["parts_ms"])
    parts["optimizer"] = o_prof["busy_ms"]
    parts["idle"] = wall - g_prof["busy_ms"] - o_prof["busy_ms"]
    print(f"{arch} step, where the time goes (profiled, {wall:.1f} ms): "
          + ", ".join(f"{k} {v:.1f} ms ({v / wall:.1%})" for k, v
                      in sorted(parts.items(), key=lambda kv: -kv[1])))
    bwd_ms = sum(v for k, v in parts.items() if k.endswith("backward"))
    print(f"{arch} step: device busy {wall - parts['idle']:.1f} ms of "
          f"{wall:.1f} (idle {parts['idle'] / wall:.1%}), the backward "
          f"kernels {bwd_ms:.1f} ms ({bwd_ms / wall:.1%} of the step)")
    del params, opt_state, grads, b
    torch.cuda.empty_cache()
    witness = sgd_witness(torch, cfg, seq, steps, drop_ratio)
    print(f"phase 26 {arch}: {time.perf_counter() - t_phase:.1f} s "
          f"({card_line()})")
    return {"launches": launches, "losses": losses, "step_s": secs,
            "tok_s": [seq / x for x in secs], "peak_gib": peak / 2 ** 30,
            "parts_ms": parts, "witness": witness, "cfg": cfg,
            "total": total}


def fixed_batch(torch, cfg, seq: int) -> dict:
    """The warm step's batch of phase 26: the first of ``packed_batches``
    (1, ``seq``), seed 0, on the card."""
    from repro_torch.data import LMDataConfig, packed_batches

    return {k: torch.from_numpy(v).cuda() for k, v in next(packed_batches(
        LMDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=1,
                     seed=0))).items()}


def sgd_witness(torch, cfg, seq: int, steps: int, drop_ratio) -> dict:
    """A full-width check of the gradient's direction and size: from the
    params of seed 0 on one fixed batch (``fixed_batch``), ``steps`` + 1
    steps of ``make_train_step`` with ``sgd`` at lr ``SGD_DROP`` / |g|^2
    (g the first gradient), whose first step should lower the loss by
    ``SGD_DROP`` to first order. The loss must fall at every step (a
    step's loss is the one before its update), and the first drop, read
    on the float32 loss (``cfg`` in float32 compute, forward only) at the
    params before and after the first step, lie within ``drop_ratio`` of
    the prediction: the bf16 loss's rounding moves a 0.25 drop by ~0.5%
    (Hymba-1.5B's read 1.0019 of it in bf16, 0.9978 in float32)."""
    import dataclasses

    from repro_torch.models import model
    from repro_torch.optim import sgd

    dev = torch.device("cuda")
    b0 = fixed_batch(torch, cfg, seq)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    g = model._grads(params, b0, cfg, dev)[1]
    gsq = float(sum((x.float() ** 2).sum() for x in g))
    del g
    opt = sgd(SGD_DROP / gsq)
    state = opt.init(params)
    step = model.make_train_step(cfg, opt)
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def loss32():
        with torch.no_grad():
            return float(model.loss_fn(params, b0, cfg32, dev)[0])

    losses, f32 = [], [loss32()]
    for i in range(steps + 1):
        params, state, m = step(params, state, b0)
        losses.append(float(m["loss"]))
        if i == 0:
            f32.append(loss32())
    del params, state, step, opt
    torch.cuda.empty_cache()
    drop = (f32[0] - f32[1]) / SGD_DROP
    drop_bf16 = (losses[0] - losses[1]) / SGD_DROP
    print(f"{cfg.name}, one fixed batch, loss before each step: sgd at lr "
          f"{SGD_DROP} / |g|^2 {losses}; first drop {drop:.4g} of the "
          f"first-order prediction on the float32 loss ({f32}), "
          f"{drop_bf16:.4g} on the {cfg.dtype} loss (limits {drop_ratio}) "
          f"({card_line()})")
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    lo, hi = drop_ratio
    if not (falls and lo <= drop <= hi):
        raise AssertionError(f"sgd does not descend as its gradient "
                             f"predicts at full width: {losses}, float32 "
                             f"{f32}")
    return {"sgd": losses, "sgd_f32": f32, "sgd_first_drop_ratio": drop}


def adamw_rise(torch, cfg, total: int, seq: int, steps: int) -> list:
    """Why phase 26's losses rise over its first steps: from the params of
    seed 0 on ``fixed_batch``, ``steps`` + 1 steps of ``train_lm``'s AdamW
    (schedule of ``total`` steps); their losses, beside ``sgd_witness``'s
    falling ones."""
    from repro_torch.models import model
    from repro_torch.optim import adamw, linear_warmup_cosine

    dev = torch.device("cuda")
    b0 = fixed_batch(torch, cfg, seq)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    opt = adamw(lr=linear_warmup_cosine(3e-3, 20, total), weight_decay=0.1,
                max_grad_norm=1.0)
    state = opt.init(params)
    step = model.make_train_step(cfg, opt)
    losses = []
    for _ in range(steps + 1):
        params, state, m = step(params, state, b0)
        losses.append(float(m["loss"]))
    del params, state, step, opt
    torch.cuda.empty_cache()
    print(f"{cfg.name}, one fixed batch, loss before each step: AdamW "
          f"(train_lm's) {losses} ({card_line()})")
    return losses


def lm_cli() -> None:
    """Phase 27: the LM pretraining CLI on the card, REDUCED StarCoder2,
    20 steps of (8, 128): exit 0 and finite losses."""
    import os

    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "starcoder2-3b", "--reduced", "--steps", "20", "--batch", "8",
           "--seq", "128", "--log-every", "5"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    losses = [float(line.split()[3]) for line in lines
              if line.startswith("step")]
    print(f"phase 27: {' '.join(cmd[1:])}: exit {res.returncode}, "
          f"{lines[:1]}, losses {losses}, {time.perf_counter() - t0:.1f} s")
    if res.returncode != 0 or not losses or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"the LM CLI failed: {res.stderr[-2000:]}")


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
            and (a.metrics is b.metrics is None
                 or same_metrics(a.metrics, b.metrics)))


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
    if per_step < 1:
        # the profiler lost launches (it adds none): profile again until a
        # round records one a step; the most any round recorded counts
        def nccl(spans):
            return sum("nccl" in n.lower() or "onerank" in n.lower()
                       for _, _, n in spans)

        rounds = launch_rounds(run, lambda sp: nccl(sp) >= steps)
        print(f"  NCCL kernels recorded in {len(rounds)} more profiled "
              f"rounds of {steps} steps: {[nccl(sp) for sp in rounds]}")
        per_step = max(per_step, *(nccl(sp) / steps for sp in rounds))
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


def same_run(torch, a, b) -> bool:
    """Two ``pac_train`` results equal bit for bit: losses, params, the
    post-sync memories, and the metrics where both have them."""
    import numpy as np

    return (len(a.losses) == len(b.losses)
            and all(np.array_equal(x, y) for x, y in zip(a.losses, b.losses))
            and all(torch.equal(x, y) for x, y in
                    zip(leaves(a.params), leaves(b.params)))
            and a.memory_states.keys() == b.memory_states.keys()
            and all(torch.equal(a.memory_states[k], b.memory_states[k])
                    for k in a.memory_states)
            and (a.metrics is None or b.metrics is None
                 or same_metrics(a.metrics, b.metrics)))


class BoundarySpans:
    """CUDA events around each ``sync_shared_memory`` call (on the stream
    it runs on: the sync stream under the overlapped boundary) and each
    PAC epoch program call (load, replays and result copies, on the main
    stream) inside ``pac_train``; with ``saves``, the host seconds of each
    checkpoint write. Patched into ``tig.distributed`` while in use."""

    def __init__(self, torch):
        self.torch = torch
        self.syncs, self.epochs, self.saves = [], [], []

    def _span(self, out: list, fn):
        def timed(*args, **kw):
            a = self.torch.cuda.Event(enable_timing=True)
            b = self.torch.cuda.Event(enable_timing=True)
            a.record()
            res = fn(*args, **kw)
            b.record()
            out.append((a, b))
            return res
        return timed

    def __enter__(self):
        from repro_torch.tig import distributed as td

        self.td = td
        self.orig = (td.sync_shared_memory, td.make_pac_epoch,
                     td.save_checkpoint)
        sync, make, save = self.orig
        td.sync_shared_memory = self._span(self.syncs, sync)

        def make_timed(*args, **kw):
            return self._span(self.epochs, make(*args, **kw))

        def save_timed(*args, **kw):
            t0 = time.perf_counter()
            path = save(*args, **kw)
            self.saves.append((time.perf_counter() - t0,
                               Path(path).stat().st_size / 2**20))
            return path

        td.make_pac_epoch = make_timed
        td.save_checkpoint = save_timed
        return self

    def __exit__(self, *exc):
        (self.td.sync_shared_memory, self.td.make_pac_epoch,
         self.td.save_checkpoint) = self.orig

    def report(self) -> tuple[list, list]:
        """Each sync's device µs, and for each sync but the last the share
        of its span inside the next epoch program's span."""
        self.torch.cuda.synchronize()
        ref = self.epochs[0][0]

        def at(ev):
            return ref.elapsed_time(ev)

        sync_us = [1e3 * a.elapsed_time(b) for a, b in self.syncs]
        inside = []
        for (a, b), (c, d) in zip(self.syncs, self.epochs[1:]):
            s0, s1, e0, e1 = at(a), at(b), at(c), at(d)
            inside.append(max(0.0, min(s1, e1) - max(s0, e0))
                          / max(s1 - s0, 1e-9))
        return sync_us, inside


def run_logged(cmds: list, timeout: float = 300) -> list:
    """Run the commands at once, each in its own session (killed with its
    group past ``timeout``); their (return code, log, seconds from the
    start until it was collected, in order: a run that ended before an
    earlier one reads that one's time)."""
    import os
    import signal

    env = {k: v for k, v in os.environ.items() if k != "REPRO_FAULTS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m", *cmd], cwd=ROOT, env={**env, **extra},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for cmd, extra in cmds]
    out = []
    try:
        for p in procs:
            log = p.communicate(timeout=timeout)[0]
            out.append((p.returncode, log, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return out


def boundary_launchers(tmp: Path) -> None:
    """Phase 5g (d) and (e): the launcher on one NCCL rank at ``tiny``
    killed and resumed, its elastic supervisor with no fault, beside an
    undisturbed run; then the ``speed-tig`` CLI."""
    import numpy as np

    run, el = tmp / "launch_run", tmp / "launch_elastic"

    def launcher(*args):
        return ["repro_torch.launch.pac_cluster", "--num-processes", "1",
                "--process-id", "0", "--coordinator",
                f"127.0.0.1:{free_port()}", "--local-devices", "2",
                "--epochs", "2", "--parts", "8", "--timeout", "120", *args]

    [(rc, log, secs)] = run_logged([(launcher(
        "--run-dir", str(run), "--ckpt-every", "1"),
        {"REPRO_FAULTS": "host_kill@epoch=1"})])
    ckpts = sorted(p.name for p in (run / "ckpt").iterdir())
    print(f"launcher killed: exit {rc} in {secs:.1f} s, checkpoints "
          f"{ckpts}")
    if rc != -9 or ckpts != ["ckpt_00000000.json", "ckpt_00000000.npz"]:
        raise AssertionError(f"the launcher was not killed after epoch "
                             f"0's checkpoint (exit {rc}):\n{log[-3000:]}")
    outs = {k: tmp / f"launch_{k}.npz" for k in ("resumed", "plain",
                                                 "elastic")}
    runs = run_logged([
        (launcher("--run-dir", str(run), "--resume", "--out",
                  str(outs["resumed"])), {}),
        (launcher("--out", str(outs["plain"])), {}),
        (launcher("--elastic", "--run-dir", str(el), "--out",
                  str(outs["elastic"])), {}),
        (["repro_torch.launch.train", "--arch", "speed-tig", "--dataset",
          "small"], {})])
    for (rc, log, secs), name in zip(runs, ("resumed", "plain", "elastic",
                                            "CLI")):
        print(f"  {name}: exit {rc}, collected {secs:.1f} s after the "
              f"four started")
        if rc != 0:
            raise AssertionError(f"{name} exited {rc}:\n{log[-3000:]}")
    if "PAC_RESUME: step 0" not in runs[0][1]:
        raise AssertionError("the resumed launcher did not resume step 0")
    got = {k: np.load(v) for k, v in outs.items()}
    plain = got["plain"]
    resumed_same = sorted(got["resumed"].files) == sorted(
        k for k in plain.files if k != "loss_1") and all(
        np.array_equal(got["resumed"][k],
                       plain["loss_1" if k == "loss_0" else k],
                       equal_nan=True) for k in got["resumed"].files)
    elastic_same = sorted(got["elastic"].files) == sorted(plain.files) \
        and all(np.array_equal(got["elastic"][k], plain[k], equal_nan=True)
                for k in plain.files)
    print(f"launcher, one NCCL rank, tiny: killed by host_kill@epoch=1 "
          f"(SIGKILL, epoch 0's checkpoint kept), resumed (PAC_RESUME: "
          f"step 0): epoch 1 and the result against the undisturbed run "
          + ("bitwise equal" if resumed_same else "DIFFERENT")
          + "; --elastic with no fault against the plain run "
          + ("bitwise equal" if elastic_same else "DIFFERENT"))
    cli = [line for line in runs[3][1].splitlines()
           if line.startswith(("PAC:", "eval:", "total"))]
    print("  speed-tig CLI (small, card): " + " | ".join(cli))
    if not (resumed_same and elastic_same):
        raise AssertionError("a launcher run differs from the plain run")


def boundary_phase(torch, kernels, g, train_g, part, pac4,
                   tmp: Path) -> dict:
    """Phase 5g: PAC's overlapped epoch boundary, checkpoints and resume,
    the restarter bundle, the launchers' kill-and-resume and elastic
    supervisor, and the ``speed-tig`` CLI, at phase 5b's P 4 path.
    Returns the launches of the overlapped path."""
    import numpy as np

    from repro_torch.configs.speed_tig import TIG
    from repro_torch.faults import FaultInjector
    from repro_torch.tig import distributed as td
    from repro_torch.tig.protocol import split_views
    from repro_torch.tig.restart import load_restarter

    t_phase = time.perf_counter()
    p = part.num_parts
    # (a) overlap against serial, two epochs, launches from zero
    runs, counts = {}, {}
    for boundary in ("serial", "overlap"):
        reset_counts(torch, kernels)
        with BoundarySpans(torch) as spans:
            t0 = time.perf_counter()
            res = td.pac_train(train_g, part, TIG, num_devices=p, epochs=2,
                               eval_graph=g, epoch_boundary=boundary)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts[boundary] = {n: kernels[n].launches for n in TIG_PATH}
        sync_us, inside = spans.report()
        runs[boundary] = res
        print(f"phase 5g path: pac_train P {p}, epoch_boundary="
              f"{boundary!r}, 2 epochs: epoch_seconds {res.epoch_seconds} "
              f"(plan {res.plan_seconds}), wall with scoring {wall:.3f} s; "
              f"the sync's device µs {[round(x, 1) for x in sync_us]}; "
              f"share of sync e inside epoch e+1's program span "
              f"{[round(x, 3) for x in inside]} ("
              + ("overlapped" if inside and inside[0] > 0.5 else
                 "not overlapped") + f"); val_ap "
              f"{res.metrics['val_ap']:.6f}")
    same = same_run(torch, runs["serial"], runs["overlap"])
    sp = split_views(g)
    scored = sum(-(-len(v.src) // TIG.batch_size) for v in sp.views[1:])
    steps = sum(x.shape[1] for x in runs["overlap"].losses)
    want = {n: (steps if n not in ("fused_flush", "temporal_attn")
                else steps + scored) * per_step(n, TIG) for n in TIG_PATH}
    print(f"  overlap against serial: losses, params, memories and "
          f"metrics " + ("bitwise equal" if same else "DIFFERENT")
          + f"; launches {counts['overlap']} / {counts['serial']}, from "
          f"phase 5b's steps {want} (phase 5b, one epoch: "
          f"{pac4['launches']})")
    if not same:
        raise AssertionError("the overlapped boundary differs from the "
                             "serial one")
    if not counts["overlap"] == counts["serial"] == want:
        raise AssertionError(f"launches {counts}, expected {want}")

    # (b) resume, and (c) the restarter bundle of the resumed run
    d = tmp / "pac_ckpt"
    full = td.pac_train(train_g, part, TIG, num_devices=p, epochs=3)
    with BoundarySpans(torch) as spans:
        try:
            td.pac_train(train_g, part, TIG, num_devices=p, epochs=3,
                         ckpt_dir=str(d), ckpt_every=1,
                         faults=FaultInjector.parse("staging_oom@at=3"))
            crashed = None
        except MemoryError as exc:
            crashed = exc
    if crashed is None:
        raise AssertionError("staging_oom@at=3 did not fire")
    fitted = []
    build = td.build_restarter

    def keep(*args, **kw):
        fitted.append(build(*args, **kw))
        return fitted[-1]

    td.build_restarter = keep
    try:
        t0 = time.perf_counter()
        res = td.pac_train(train_g, part, TIG, num_devices=p, epochs=3,
                           ckpt_dir=str(d), resume=True, eval_graph=g,
                           eval_warm="restart")
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    finally:
        td.build_restarter = build
    full.losses = full.losses[2:]
    same = same_run(torch, full, res)
    print(f"resume: 3 epochs uninterrupted against 2 checkpointed epochs "
          f"crashed by staging_oom@at=3 and resumed (1 epoch and the "
          f"restart scoring, {resumed_s:.3f} s): params, memories and "
          f"epoch 2's losses " + ("bitwise equal" if same else "DIFFERENT")
          + "; snapshots (host s, MiB) "
          + str([(round(s_, 4), round(m, 2)) for s_, m in spans.saves]))
    if not same:
        raise AssertionError("the resumed PAC run differs from the "
                             "uninterrupted one")
    rst = fitted[0][0]
    loaded = load_restarter(str(d / "restarter.npz"), TIG)
    bundle = (len(leaves(rst.params)) == len(leaves(loaded.params))
              and all(torch.equal(x, y) for x, y in
                      zip(leaves(rst.params), leaves(loaded.params)))
              and np.array_equal(rst.bank.emb, loaded.bank.emb)
              and np.array_equal(rst.bank.t, loaded.bank.t)
              and np.array_equal(rst.bank.seen, loaded.bank.seen)
              and rst.fit_mse == loaded.fit_mse)
    print(f"restarter bundle: {sorted(q.name for q in d.iterdir())}; "
          f"load_restarter against the head fitted in memory: "
          + ("bitwise equal" if bundle else "DIFFERENT")
          + f"; restart val_ap {res.metrics['val_ap']:.6f}")
    if not bundle:
        raise AssertionError("the saved restarter differs from the fitted "
                             "one")

    # (d) the launchers, (e) the CLI
    boundary_launchers(tmp)
    print(f"phase 5g: {time.perf_counter() - t_phase:.1f} s "
          f"({card_line()})")
    return {f"pac_p{p}_overlap": counts["overlap"]}


ROOFLINE_REL = 0.01       # phase 28: card bytes within 1% of meta's


def count_compare(label: str, card, on_meta) -> None:
    """Phase 28's check of one step counted on the card and on ``meta``:
    equal FLOPs and collective bytes, bytes within ``ROOFLINE_REL``; any
    aten op counted differently is printed first."""
    diff = {k: (card.by_op.get(k), on_meta.by_op.get(k))
            for k in sorted(set(card.by_op) | set(on_meta.by_op))
            if card.by_op.get(k) != on_meta.by_op.get(k)}
    for op, (c, m) in diff.items():
        print(f"  {label}: {op} counted differently: card [calls, FLOPs, "
              f"bytes] {c}, meta {m}")
    rel = abs(card.bytes - on_meta.bytes) / max(on_meta.bytes, 1)
    print(f"{label}, counted: card {card.flops} FLOPs, {card.bytes} bytes, "
          f"{card.collective_bytes} collective bytes; meta {on_meta.flops} "
          f"FLOPs, {on_meta.bytes} bytes, {on_meta.collective_bytes} "
          f"collective bytes (bytes {rel:.2e} apart); kernel scopes "
          f"{card.kernels}")
    if card.flops != on_meta.flops or card.kernels != on_meta.kernels:
        raise AssertionError(f"{label}: card and meta FLOPs differ")
    if card.collective_bytes != on_meta.collective_bytes:
        raise AssertionError(f"{label}: collective bytes differ")
    if rel > ROOFLINE_REL:
        raise AssertionError(f"{label}: bytes {rel:.3%} apart")


def roofline_phase(torch, g, cfg, paths: dict) -> None:
    """Phase 28: the step cost counter on the card against the dry run's
    ``meta`` count, ``mfu`` from phase 26's step times, and the dry run
    of each phase 26 path beside its measured peak (see the module's
    docstring). ``paths``: label -> (arch, seq, layers, dtype,
    ``lm_train_path``'s result)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.roofline.analysis import MODEL_FLOPS, peak_flops

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    # one eager TGN step of train_single, on the card and on meta
    inputs = dryrun.tig_step_inputs(g, cfg, dev)
    tig_card = dryrun.count_tig_step(cfg, inputs, dev)
    tig_meta = dryrun.count_tig_step(cfg, dryrun.on_meta(inputs), "meta")
    count_compare(f"TGN train_single step (batch {cfg.batch_size}, "
                  f"{g.num_nodes} nodes; {card})", tig_card, tig_meta)
    del inputs
    # one StarCoder2-3B bf16 training step at phase 26's shape
    arch, seq = "starcoder2-3b", 8192
    lm = get_config(arch)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               lm)
    opt = adamw(lr=linear_warmup_cosine(3e-3, 20, TRAIN_STEPS + 2),
                weight_decay=0.1, max_grad_norm=1.0)
    opt_state = opt.init(params)
    batch = fixed_batch(torch, lm, seq)
    meta_args = [dryrun.on_meta(x) for x in (params, opt_state, batch)]
    lm_card, saved_card = dryrun.count_lm_train_step(lm, params, opt,
                                                     opt_state, batch, dev)
    torch.cuda.synchronize()
    del params, opt_state, batch
    torch.cuda.empty_cache()
    lm_meta, saved_meta = dryrun.count_lm_train_step(
        lm, meta_args[0], opt, meta_args[1], meta_args[2], "meta")
    count_compare(f"{arch} bf16 training step (1, {seq}) ({card})",
                  lm_card, lm_meta)
    print(f"{arch} saved for the backward (distinct storages): card "
          f"{saved_card / 2 ** 30:.3f} GiB, meta {saved_meta / 2 ** 30:.3f} "
          f"GiB ({card})")
    # mfu from each training path's measured step time
    for label, (a, s, layers, dtype, res) in paths.items():
        c = res["cfg"]
        step_s = statistics.median(res["step_s"])
        peak = peak_flops(c.dtype)
        mf = MODEL_FLOPS(c.active_param_count(), s, "train")
        line = (f"{label}: mfu {mf / (step_s * peak):.4f} (6 N D = "
                f"{mf:.4e} over {step_s:.4f} s x {peak:.3e} FLOP/s, "
                f"{c.dtype} peak)")
        if label == "starcoder2-3b training":
            line += (f"; counted-FLOP share of the peak (the JAX "
                     f"program's FLOPs, masked attention chunks included, "
                     f"not a utilisation) "
                     f"{lm_card.flops / (step_s * peak):.4f}, counted FLOPs "
                     f"{lm_card.flops:.4e}")
        print(f"{line} ({card})")
    # the dry run of each path at its shape, beside its measured peak
    for label, (a, s, layers, dtype, res) in paths.items():
        out = dryrun.dryrun_one(a, "train_4k", batch=1, seq=s,
                                layers=layers, dtype=dtype, save=False,
                                verbose=False)
        est = out["state_bytes"] + out["saved_bytes"]
        print(f"dry run {label} ({out['note']}): {json.dumps(out)}")
        print(f"{label}: measured peak {res['peak_gib']:.2f} GiB beside the "
              f"dry run's state {out['state_bytes'] / 2 ** 30:.2f} + saved "
              f"{out['saved_bytes'] / 2 ** 30:.2f} = {est / 2 ** 30:.2f} GiB "
              f"({card})")
    out = dryrun.dryrun_one("gemma-7b", "train_4k", batch=1,
                            seq=GEMMA_TRAIN_SEQ, save=False, verbose=False)
    print(f"dry run gemma-7b training, 28 layers: {json.dumps(out)}")
    print(f"gemma-7b at 28 layers: state {out['state_bytes'] / 2 ** 30:.2f}"
          f" + saved {out['saved_bytes'] / 2 ** 30:.2f} GiB, fits one card: "
          f"{out['fits_one_card']}")
    print(f"phase 28: {time.perf_counter() - t0:.1f} s ({card})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
        # phase 5g: the overlapped boundary and fault tolerance
        by_path.update(boundary_phase(torch, KERNELS, g, train_g,
                                      parts[p4], pac[p4], Path(tmp)))
    # phase 5h: the host_replay oracle, counted from zero
    by_path["pac_p4_host_replay"] = host_replay_phase(torch, KERNELS)
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
    flash = flash_checks(torch, dev, FLASH_CASES)
    for r in flash:
        print_kernel(r)
    # 56 prompt tokens and 16 generated: the ring buffer of the REDUCED
    # window of 64 wraps
    lm_small_agreement(torch, "starcoder2-3b", 56, 16)
    # 30 flash launches per forward; decode attends through the plain
    # decode attention, no kernel
    flash_by_path = {"starcoder2-3b": lm_path(
        torch, KERNELS, "starcoder2-3b", 2, 8192, {"flash_attention": 1},
        {})["flash_attention"]}
    torch.cuda.empty_cache()
    # phase 14: REDUCED OLMoE (MoE, qk-norm, SwiGLU) and Gemma (GeGLU,
    # tied embeddings) in float32, card vs CPU
    for arch in ("olmoe-1b-7b", "gemma-7b"):
        lm_small_agreement(torch, arch, 16, 16)
    # phases 15 and 16: OLMoE-1B-7B (16 flash launches per forward, D 128)
    # and Gemma-7B (28, D 256) at full width, each freed before the next
    for arch in ("olmoe-1b-7b", "gemma-7b"):
        flash_by_path[arch] = lm_path(
            torch, KERNELS, arch, 2, 4096, {"flash_attention": 1}, {},
            bitwise=True)["flash_attention"]
        torch.cuda.empty_cache()
    # phase 17: the selective scan kernel against its plain version
    t0 = time.perf_counter()
    scan = scan_checks(torch, dev)
    for r in scan:
        print_kernel(r)
    # phase 18: REDUCED hymba in float32, card vs CPU: 24 prompt and 24
    # generated tokens wrap the ring of the REDUCED window's 32 slots
    lm_small_agreement(torch, "hymba-1.5b", 24, 24)
    # phase 19: Hymba-1.5B at full width: one flash and one scan launch a
    # layer in forward; generate's 64 serve steps one scan launch a layer
    # each, no flash (decode attention is plain PyTorch, as in JAX)
    hymba = lm_path(torch, KERNELS, "hymba-1.5b", 2, 4096,
                    {"flash_attention": 1, "selective_scan": 1},
                    {"selective_scan": 64}, bitwise=True)
    flash_by_path["hymba-1.5b"] = hymba["flash_attention"]
    launches["selective_scan"] = hymba["selective_scan"]
    torch.cuda.empty_cache()
    print(f"phases 17-19: {time.perf_counter() - t0:.1f} s ({card})")
    # phase 20: flash at the last two families' shapes and at a key length
    # of its own (cross-attention), with a control that takes the query
    # length for the key length
    t0 = time.perf_counter()
    flash_keys = flash_checks(torch, dev, FLASH_KEYS)
    for r in flash_keys:
        print_kernel(r)
    # phase 21: REDUCED seamless and Qwen2-VL in float32, card vs CPU
    for arch in ("seamless-m4t-medium", "qwen2-vl-7b"):
        lm_small_agreement(torch, arch, 16, 16)
    # phase 22: SeamlessM4T-medium at full width, (2, 512) tokens over
    # (2, 1024) frames: a flash launch an encoder layer, two a decoder
    # layer (self and cross) in forward; generate runs the encoder once
    # and decodes with no flash
    flash_by_path["seamless-m4t-medium"] = lm_path(
        torch, KERNELS, "seamless-m4t-medium", 2, 512,
        {"flash_attention": 2}, {}, bitwise=True,
        enc_per_layer={"flash_attention": 1})["flash_attention"]
    torch.cuda.empty_cache()
    # phase 23: Qwen2-VL-7B at full width, 1,024 patches and 3,072 tokens
    # (S 4096): a flash launch a layer in forward, none in decode
    flash_by_path["qwen2-vl-7b"] = lm_path(
        torch, KERNELS, "qwen2-vl-7b", 2, 4096, {"flash_attention": 1}, {},
        bitwise=True)["flash_attention"]
    torch.cuda.empty_cache()
    print(f"phases 20-23: {time.perf_counter() - t0:.1f} s ({card})")
    # phase 24: the flash backward kernel against its plain version, and
    # the forward's optional lse against phase 11's time
    t0 = time.perf_counter()
    flash_bwd = flash_bwd_checks(torch, dev, FLASH_BWD_CASES,
                                 flash[-1]["kernel"])
    print(f"phase 24: {time.perf_counter() - t0:.1f} s ({card})")
    # phase 24b: the backward kernels of WKV and the selective scan
    # against their plain versions
    wkv_bwd, scan_bwd = recur_bwd_checks(torch, dev)
    # phase 25: REDUCED training of nine families card vs CPU
    agree = lm_train_agreement(torch, KERNELS)
    torch.cuda.empty_cache()
    # phase 26: StarCoder2-3B training at full width, counted from zero
    train = lm_train_path(torch, KERNELS)
    adamw_rise(torch, train["cfg"], train["total"], 8192, TRAIN_STEPS)
    torch.cuda.empty_cache()
    # phase 26b: RWKV6-1.6B and Hymba-1.5B training at full width, each
    # counted from zero
    recur_res = {arch: lm_train_path(
        torch, KERNELS, arch, RECUR_TRAIN_SEQ, RECUR_TRAIN_STEPS,
        RECUR_DROP_RATIO) for arch in RECUR_TRAIN}
    recur = {arch: r["launches"] for arch, r in recur_res.items()}
    torch.cuda.empty_cache()
    # phase 26c: Gemma-7B training at full width, 8 of its 28 layers,
    # counted from zero (the flash backward at D 256)
    gemma_res = lm_train_path(torch, KERNELS, GEMMA_TRAIN, GEMMA_TRAIN_SEQ,
                              GEMMA_TRAIN_STEPS, layers=GEMMA_TRAIN_LAYERS)
    gemma = gemma_res["launches"]
    torch.cuda.empty_cache()
    # phase 26d, this slice's main path: StarCoder2-3B training at full
    # width in float32 compute, counted from zero (the flash backward's
    # float32 form)
    train32_res = lm_train_path(torch, KERNELS, "starcoder2-3b",
                                F32_TRAIN_SEQ, F32_TRAIN_STEPS,
                                dtype="float32")
    train32 = train32_res["launches"]
    torch.cuda.empty_cache()
    flash_by_path["starcoder2-3b training"] = train["launches"][
        "flash_attention"]
    flash_by_path["hymba-1.5b training"] = recur["hymba-1.5b"][
        "flash_attention"]
    flash_by_path["gemma-7b training (8 layers)"] = gemma["flash_attention"]
    flash_by_path["starcoder2-3b float32 training"] = train32[
        "flash_attention"]
    bwd_by_path = {
        "flash_attention_bwd": {
            "starcoder2-3b training": train["launches"][
                "flash_attention_bwd"],
            "starcoder2-3b float32 training": train32["flash_attention_bwd"],
            "hymba-1.5b training": recur["hymba-1.5b"][
                "flash_attention_bwd"],
            "gemma-7b training (8 layers)": gemma["flash_attention_bwd"]},
        "rwkv6_bwd": {"rwkv6-1.6b training": recur["rwkv6-1.6b"][
            "rwkv6_bwd"]},
        "selective_scan_bwd": {"hymba-1.5b training": recur[
            "hymba-1.5b"]["selective_scan_bwd"]}}
    for name, by in bwd_by_path.items():
        launches[name] = sum(by.values())
        by["train agreement (phase 25)"] = agree[name]
    # the backward's entry at this slice's main shape: StarCoder2-3B's
    # float32 training call (phase 26d)
    bwd_main = next(r for r in flash_bwd
                    if r["label"] == "starcoder2-3b training f32")
    bwd_main["extra"]["launches_by_path"] = bwd_by_path[
        "flash_attention_bwd"]
    wkv_bwd[0]["extra"]["launches_by_path"] = bwd_by_path["rwkv6_bwd"]
    scan_bwd[0]["extra"]["launches_by_path"] = bwd_by_path[
        "selective_scan_bwd"]
    # the forward kernels on the training paths beside serving's
    for name, arch in (("rwkv6", "rwkv6-1.6b"),
                       ("selective_scan", "hymba-1.5b")):
        launches[name] += recur[arch][name]
    wkv_main = [r for r in wkv if r["name"] == "rwkv6"][-1]
    wkv_main["extra"] = wkv_main.get("extra", {}) | {"launches_by_path": {
        "rwkv6-1.6b forward + generate": rwkv_launches["rwkv6"],
        "rwkv6-1.6b training": recur["rwkv6-1.6b"]["rwkv6"]}}
    scan[0]["extra"]["launches_by_path"] = {
        "hymba-1.5b forward + generate": hymba["selective_scan"],
        "hymba-1.5b training": recur["hymba-1.5b"]["selective_scan"]}
    # phase 27: the LM pretraining CLI
    lm_cli()
    # phase 28: the step cost counter on the card against the dry run's
    # meta count, mfu, and the dry run of phase 26's paths
    roofline_phase(torch, g, TIG, {
        "starcoder2-3b training": ("starcoder2-3b", 8192, None, None,
                                   train),
        "starcoder2-3b float32 training": ("starcoder2-3b", F32_TRAIN_SEQ,
                                           None, "float32", train32_res),
        "rwkv6-1.6b training": ("rwkv6-1.6b", RECUR_TRAIN_SEQ, None, None,
                                recur_res["rwkv6-1.6b"]),
        "hymba-1.5b training": ("hymba-1.5b", RECUR_TRAIN_SEQ, None, None,
                                recur_res["hymba-1.5b"]),
        "gemma-7b training (8 layers)": (GEMMA_TRAIN, GEMMA_TRAIN_SEQ,
                                         GEMMA_TRAIN_LAYERS, None,
                                         gemma_res)})
    torch.cuda.empty_cache()
    launches["flash_attention"] = sum(flash_by_path.values())
    flash[-1]["extra"]["launches_by_path"] = flash_by_path

    def entry(r):
        return dict(
            name=r["name"], route="cuda",
            source=f"src/repro_torch/kernels/csrc/"
                   f"{KERNELS[r['name']].source}",
            replaces=TPU_KERNELS.get(r["name"]) or NEW_KERNELS[r["name"]],
            tpu_kernel=r["name"] in TPU_KERNELS,
            launches=launches[r["name"]],
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
    # TGN's updater shape; flash: the StarCoder2-3B forward's shape; the
    # selective scan: the Hymba-1.5B forward's shape; the flash backward:
    # StarCoder2-3B's float32 training call
    record = {"kernels": [entry(r) for r in recs] + [
        shaped_entry([r for r in wkv if r["name"] == name][-1],
                     [r for r in wkv if r["name"] == name])
        for name in ("rwkv6", "rwkv6_seq")] + [
        shaped_entry(next(r for r in gru if r["name"] == name),
                     [r for r in gru if r["name"] == name])
        for name in ("fused_gru", "fused_gru_bwd")] + [
        shaped_entry(flash[-1], flash + flash_keys),
        shaped_entry(scan[0], scan),
        shaped_entry(bwd_main, flash_bwd),
        shaped_entry(wkv_bwd[0], wkv_bwd),
        shaped_entry(scan_bwd[0], scan_bwd)]}
    if len(record["kernels"]) != len(TPU_KERNELS) + len(NEW_KERNELS):
        raise AssertionError("the record misses a kernel")
    print(profile_loss_line())
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
