#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each of which must pass (any failure raises and exits non-zero):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit`` and builds the
   eight kernels from ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel) into ``build/repro_torch/``.
2. Kernel edge cases: every kernel against its plain PyTorch version on the
   card (merge and rank exactly, Lindley within 1e-9 s and bitwise equal
   over two calls; the merge around its 1,024-output tile, with all-equal
   keys, duplicates, 1 key against 1,000,000 and on a side stream; Lindley
   around its 4,096-op tile, over 10,000 rows of 0-3 ops, with d0 above
   every arrival and past an all-ones NaN (the call must end); the rank
   also against np.searchsorted at 4,094-4,097 and 6,143-6,145 fences, 1,
   255, 257 and 3,007 keys, strided keys and on a side stream; flash_attention
   over S 1..384 and 63/64/65, head_dim 64/128, GQA and windows, S 4,096
   with a 128-token window and with GQA rep 2 at D 128, and B 8 grids at
   ragged S 777 and 1,000, then head_dim 256 (gemma3: GQA 4 over 1) over
   the same S with windows, and windows 1, 16 and 512 at S 1,000 and
   4,096 and global at 4,096; ssd_scan's y and final state over L 1..300,
   63/64/65 and 189, G < H, dt from 1e-4 to 10, contiguous inputs and
   strided views of one xbc buffer, and L 4,096 at B 2 and at zamba2's
   64 heads, half of them with the final state from an fp32 state_dt,
   then bf16 x, B and C with fp32 dt as the model passes them (L 65, 189
   and 4,096, state_dt omitted and given as that dt);
   paged_attention over B 1-3, G 1/2/3/6/8, head_dim 64/128, page sizes
   16/32, shuffled page tables with repeats and garbage past the length,
   lengths 0, 1, PS, PS+1 and MAXP*PS, then lengths at the boundaries of
   the kernel's split over blocks, an all-empty batch and a B 1 x 4,096
   decode; then sliding windows: head_dim 256 at G 1, 4 and 8, fp32 and
   bf16, windows 1, PS-1, PS, PS+1, 512 and past the length, lengths at
   the window's, pages' and splits' edges, the D 64/128 cases again with
   windows, and gemma3's B 1 x 4,096 with its window and global, every
   windowed case given NaN in every row before the window and -1 or
   2**30 in the table entries of pages wholly before it, against the plain
   version on clean inputs; every case again with ``return_lse``: the
   output bitwise the same, each row's log-sum-exp within the fp32 TOL of
   the plain version's and exactly -1e30 for an empty row; every element
   within atol + rtol * |plain| as TOL below states).  flash_attention also non-causal with Sk keys for Sq
   queries (Sq 1, 63, 64, 65, 189 over Sk 1, 65, 1,500; its rows'
   log-sum-exp beside); its backward kernel (dQ, dK, dV) against
   ``flash_attention_bwd_plain`` over S 1-384 (ragged, 63/64/65), head_dim
   64/128/256, GQA rep 1/2/4/8, causal and windows 1/16/512 and
   non-causal Sq != Sk, fp32 and bf16 (bf16 on its wgmma kernels at
   every head_dim), whisper-tiny's training shapes and gemma3-1b's (4
   query heads over 1 of 256, 4,096 tokens, window 512 and global), each
   case launched twice and bitwise equal, gemma3's bf16 cases profiled:
   their kernels must be the tensor-core ones (``BWD_D256_KERNELS``); ssd_scan's backward kernel (dx, d(dt), da, dB, dC) against
   ``ssd_scan_bwd_plain`` over L 0, 1, 63, 64, 65, 189, 300 and 4,096, H 4
   over G 1 and 2 and zamba2's 64 heads (and mamba2-130m's 24 at N 128)
   over one group, (N, P) of (64, 64), (128, 64), (16, 32) and (64, 48),
   fp32 and bf16 x/B/C/dy with fp32 dt log-uniform from 1e-4 to 10,
   contiguous and strided views of one xbc buffer, and zamba2's training
   shape, each case launched twice and bitwise equal, within TOL_BWD; x
   as a view whose innermost stride is not 1 and dy expanded from one
   element (``y.sum()``/``y.mean()``, through ``SsdScanFn`` too); N 240
   with P 64 in bf16 and N 144 with P 64 in fp32, past a block's shared
   memory, refused with a ValueError;
   paged_attention over whisper's cross cache (1,500 live rows of
   1,504, NaN in the 4 pad rows).
3. Store path: ``Simulator.run`` on the card for every registered policy
   (vlsm, rocksdb, rocksdb_io, adoc, lsmi, lazy) at the paper's byte scale
   (64 MiB scale, ``DeviceModel.scaled(1.0)``, 200-byte pairs): 8,000,000
   uniform keys loaded at 500,000 ops/s, a 10 s settle, then 2,000,000
   YCSB Run A ops (50% GET / 50% update, Zipfian 0.99) at 8,000 ops/s.
   Launch counts are zeroed just before and read just after; overlap_scan
   and lindley_scan must have launched, lookup_probe exactly once for each
   GET batch (each ``LSMTree._lookup_batch`` call with a key, counted by
   wrapping it), and merge_path exactly once for
   each input SST of a compaction past the first of its merge: the runs
   that ``LSMTree.merge_runs`` is handed must add up to the job log's input
   SSTs (lsmi's here each move one SST into an empty key range and merge
   nothing).  The (keys, fences) sizes of every rank call and the (A, B)
   lengths of every merge call are counted on the way (by wrapping the
   names in the store's modules, not in the package) and must add up to
   overlap_scan's and merge_path's launches.  On vlsm's and rocksdb's
   trees as their runs left them, lookup_probe is held against its plain
   chain element for element: the run's median GET batch of its first GET
   keys, with every fence, one below and one above it, and the int64
   extremes.
3b. db_bench: ``db_bench.main`` on the card, from rewound uid counters, at
   the reference's full sizes for every policy (fillrandom uniform and
   pareto, read_path, ycsb_a, seekrandom, chain_report, shard_sweep
   x1/x2/x4 and the x4 Zipf hot shard, fleet_sweep over 4 shard counts x
   32 rates with its serial oracle on every rate, serve_sweep's three
   tenants over 6 load factors with admission off and on, and the
   perf_trajectory row), each bench's launches counted apart; its rows, in
   order, against all 902 committed ``BENCH_dbbench.json`` rows: timing
   keys and the two tier keys dropped, every integer, string and
   structural field equal (perf_trajectory's task, cache-hit, cache-miss
   and worker counts included), a rounded simulated-time field within one
   unit of its last digit (counted), the parity gap within 1e-9 s; at
   least one row must stall.  Under ``REPRO_PARANOID_CHECKS=1`` every row
   must pass the schema gate ``paranoid_validate_rows`` checks
   against the families ``repro_torch.analysis`` extracts from the port's
   emitter, and all 902 must have been validated (the switch is set
   around that validation only: it also arms the store's invariant
   checks, which double db_bench's time).
3c. The fleet matrix (every policy x shard counts 1, 2, 4, 16 x 32 rates:
   4,416 queues) through ``fleet.fleet_sweep``: ONE lindley_scan launch,
   its queues and departures bit for bit those of the 768 per-pass
   launches of 3b's ``sweep_execute``, the kernel within 1e-9 s of its
   plain version on the batch; then db_bench's quick fleet_sweep with 1
   and with 2 spawned workers, rows identical but for timing keys.
3d. Open-loop serving at the paper's byte scale, for vlsm and rocksdb over
   2 hash shards: db_bench's pinned three-tenant spec (``make_serve_spec``:
   YCSB-B at priority 0 with a 25 ms SLO, bursty YCSB-A at priority 1,
   60 ms, a bulk load at priority 2, 250 ms) offering 2,000,000 ops over
   8,000,000 preloaded keys at load factors 1, 2 and 8 (4,000, 8,000 and
   32,000 ops/s; the last past the admission knee).  Admission off:
   ``serve_grid`` (one structural replay, one temporal pass and one
   lindley_scan launch a factor), its factor-1 run equal to a serial
   ``Simulator.run`` on the same stream (per-op reads, probed counts and
   stall events identical, latency within 1e-9 s).  Admission on:
   ``Simulator.serve`` under ``REPRO_SANITIZE=1`` at every factor (no
   violation; factor 8 must shed), and a ``FleetEngine`` at factors 2 and
   8 with the same verdicts, ledgers and stall events, latency within
   1e-9 s.  Every
   run: each tenant's offered ops = admitted + shed + throttled, the
   priority-0 tenant never shed; merge_path, overlap_scan and lindley_scan
   must have launched (counts zeroed at the start of each policy's run).
   Wall seconds of materialize, the admission pre-pass and the engine,
   goodput, shed share and the priority-0 tenant's p99/p99.9, and the peak
   device memory go into the report.
3e. ``ShardedStore`` on the card (run after phase 5): 4 hash shards
   (vlsm, 64 MiB scale), 400,000 keys loaded, then 100,000 ops (45% GET,
   45% PUT, 5% DELETE, 5% SCAN of at most 100 keys), 10,000 ops a batch,
   sealed between batches as a harness seals it, and the same with one
   shard (whose compactions the 4-shard store does not reach), each
   against the same store built on the CPU: every batch's per-op seqs,
   reads, probed and SCAN keys and seqnos, ``merged_view``, every shard's
   SSTs, Stats and chain ledger and the drained jobs identical; the
   one-shard store also against a bare ``LSMTree`` on the card,
   identical.
4. Serving paths: ``repro_torch.launch.serve.run(arch, smoke=False)`` with
   the reference's defaults (8 requests: two shared 128-token prefixes
   plus 8-63-token tails; 16 greedy tokens each; 32-token prefix blocks;
   max_seq 512), bf16 weights from a seeded generator, at full width and
   depth, for zamba2-1.2b (38 Mamba2 layers, d_model 2048, the shared
   attention block applied 6 times), qwen3-1.7b (28 GQA layers, d_model
   2048, 16 query heads over 8 kv heads of 128), gemma3-1b (26 layers,
   d_model 1152, 4 query heads over 1 kv head of 256, 5:1 local:global
   with a 512-token window), deepseek-v2-lite (27 layers, the first
   dense, MLA, 64 routed experts top-6 plus 2 shared; 15.7 B parameters,
   its peak memory recorded), llama3.2-3b (28 layers, 24 query heads over
   8 of 128), yi-6b (32 layers, 32 over 4 of 128), qwen2-vl-2b (28
   layers, 12 over 2 of 128, M-RoPE over token prompts as the reference
   serves it) and mamba2-130m (24 Mamba2 layers, N 128, no attention).  Launch counts are zeroed just before each
   run and read just after: lookup_probe (the prefix cache's lookups) must
   have launched, and flash_attention and paged_attention (and ssd_scan for zamba2) where
   the model has attention layers, paged_attention once per attention
   layer and decode step (6 x 15 x 8 = 720 for zamba2, 28 x 15 x 8 =
   3,360 for qwen3, llama3.2 and qwen2-vl, 26 x 15 x 8 = 3,120 for
   gemma3, 3,840 for yi, 0 for deepseek's MLA and mamba2) and
   flash_attention once per attention layer and request (48, 224, 208,
   256 for yi, 0 and 0; mamba2's ssd_scan must launch); and whisper-tiny (4 encoder and 4 decoder layers, d_model 384,
   6 heads of 64, 1,500 encoder frames from ``default_rng(request id)``):
   flash_attention 12 times a request (4 encoder, 4 self, 4 cross: 96)
   and paged_attention 8 times a decode step (self and cross: 960).
   Then gemma3-1b's long windowed decode: a 4,096-token prefill
   and 16 decode steps in bf16 at full size, ms a token (finite logits,
   26 flash and 416 paged launches).
4b. Training: qwen3-1.7b at full width and depth in bf16, 4 steps of
   ``make_train_step(remat=True)`` on B 8 x S 64 batches of
   ``TokenPipeline``: 56 flash_attention launches a step (a forward and its
   recomputation a layer) and 28 flash_attention_bwd, finite losses, fp32
   moments, ms a step and peak memory; the bytes requested from the
   card's allocator once the parameters, moments and first batch are on
   it, before the first step, must equal the dry-run's argument bytes for
   the cell (``launch.dryrun.plan_cell`` at mesh sizes data 1 x model 1,
   planned in the CPU worker) to the byte, and the bytes allocated be no
   fewer than those rounded to 512 a tensor (more where the allocator
   reuses a cached block without splitting it), printed beside the
   dry-run's roofline time, ``train_bound_ms``, the measured ms a step
   and the temporaries' estimate against the measured peak.  zamba2-1.2b at full width and
   depth in bf16, 5 steps of ``make_train_step(remat=True)`` at B 8 x S 64
   on one fixed batch of a stream it can learn (``learnable_batch``),
   repeated: 76 ssd_scan, 38 ssd_scan_bwd, 6 flash_attention and 6
   flash_attention_bwd launches a step, finite losses that fall from the
   first step to the last, fp32 moments, ms a step against its bound and
   peak memory.  gemma3-1b the same (5 steps, one repeated learnable
   batch): 52 flash_attention and 26 flash_attention_bwd launches a step
   at head_dim 256, the backward on its tensor-core kernels.
   deepseek-v2-lite at full width, depth cut to 4 layers (1 dense, 3
   MoE; the full 27 layers' weights, gradients and moments do not fit
   one card), 3 steps from ``TokenPipeline``: finite losses, no attention
   kernel launched (MLA is plain torch), ms a step and peak memory.
   (After phase 5 and 3e's card runs:) whisper-tiny at full
   size through
   ``launch.train.run(smoke=False, steps=40, ckpt_every=20, fail_at=30)``:
   one restart restoring the vLSM checkpoint of step 20 with its pipeline
   cursor (21), losses finite and within 0.25 of ln(vocab) (40 steps of
   512 tokens cannot learn a 51,865-token stream: train_whisper), the
   checkpoint's pages, segments and index statistics and the store
   kernels' launches recorded; then qwen3-1.7b cut to 2 layers,
   whisper-tiny at full size, zamba2-1.2b cut to 7 layers (one shared
   attention application), mamba2-130m at its full 24 layers (N 128),
   gemma3-1b cut to 6 layers (5 local, 1 global) and deepseek-v2-lite cut
   to 2 (its dense layer and one MoE layer), in float32, card against CPU: ``train_loss``, every gradient leaf and
   the parameters after 2 AdamW steps, mamba2-130m's parameters against a
   float64 run (``float64_tier``): the card no further from it than the
   CPU tier.
5. Kernel timings at the main paths' shapes: kernel, plain version and
   library call — ``ms``, the median of five CUDA-event-timed trials of
   back-to-back calls, and ``device_ms``, the kernels' own device time from
   torch.profiler, with the device events it recorded per call — beside
   the bound: the larger of the bytes at 3.35 TB/s
   and the operations at 989 TFLOP/s (bf16).  lookup_probe at vlsm's
   median GET batch beside the plain chain it replaced (no library call
   computes it; its bound counts every key, fence and seq entry the
   searches read once, ``probe_bytes``).  overlap_scan and merge_path
   are also held against their plain versions at the store's commonest
   call shape from phase 3, lindley_scan over a ragged batch of 4,096 rows
   (timed by ``scripts/probe.py merge rank lindley``; the fleet matrix's
   batch by ``probe.py fleet_matrix``), ssd_scan with and without its
   final-state run.  After whisper's training: flash_attention_bwd at the
   training shape (B 8, 16 query heads over 8 of 128, S 64) and at 4,096
   tokens beside SDPA's backward (bound: 10*D operations per unmasked
   pair), flash_attention at whisper's encoder (S 1,500) and cross
   attention (its longest prompt over 1,500 frames) beside SDPA,
   ssd_scan_bwd at zamba2's training shape (B 8, L 64, 64 heads, bf16)
   beside its plain version (no library call computes it; at 4,096 steps
   it is timed by ``scripts/probe.py ssd_bwd``).  The LM
   kernels are also
   timed at a 4,096-token prefill (ssd_scan), and gemma3-1b's attention:
   flash at its serving prefill and paged at its serving decode, beside
   SDPA with an explicit window mask.  flash_attention at a 4,096-token
   prefill (zamba2's and qwen3-1.7b's heads), paged_attention at 8 and at 1
   sequence of 4,096 tokens over a shuffled pool, and gemma3-1b's flash
   and paged at 4,096 tokens with its window and global are held against
   their plain versions here and timed by ``scripts/probe.py flash paged
   gemma3``.
6. Cross-checks: zamba2-1.2b in bf16 at full width and depth, every
   Mamba2 layer's final state from the kernel against a sequential fp32
   scan with fp32 dt (the reference's ``ssd_final_state``) on the layer's
   own inputs, within SSD_STATE_TOL; then 15 decode steps in float32
   (the weights widened): greedy tokens from the kernel's states equal to
   the fp32 scan's, and, fed an fp64 scan's tokens, logits within 1e-3 of
   max(1, max|logit|) of that scan's, where states from bf16 dt must fall
   outside; the store path of vlsm and rocksdb with
   ``compute_device="cpu"`` (per-op reads/probed and stall counts
   identical, latency within 1e-9 s); each
   serving model in float32 at full width, depth cut (zamba2 to 7 layers,
   one shared-attention application; qwen3, llama3.2-3b, yi-6b and
   qwen2-vl-2b to 2; deepseek-v2-lite to 2, its dense layer and one MoE
   layer, decoded absorbed and expanded; mamba2-130m at its full 24),
   card against CPU on the first request's prefill and 4 greedy decode
   steps (tokens identical, logits within 1e-3 of max(1, max|logit|));
   gemma3-1b the same at 6 layers, five local and one global, on a seeded
   1,000-token prompt with a 1,024-token cache and 16 greedy steps, so
   that its window bites in the prefill and in every step; whisper-tiny
   the same at full depth on the first request's prompt and frames.
7. Distributed (``repro_torch.distributed``), once the worker is idle:
   one NCCL rank, then four gloo ranks, each a spawned process on the
   card (gloo's collectives staged through the host by ``comm``'s table;
   NCCL will not put two ranks on one card), a failing rank failing the
   spawn's join.  NCCL: the sequence-sharded decode over one whole cache
   is paged_attention's output bitwise, ``compressed_psum`` of one rank is
   its int8 round trip bitwise, ``pipeline_apply`` of one stage is the
   stage bitwise.  gloo: the sequence-sharded decode at qwen3-1.7b's (16
   over 8 heads of 128) and gemma3-1b's (4 over 1 of 256) decode heads, B
   8 over decode_32k's 32,768 cache tokens in four slices of 8,192, bf16
   and fp32, with sequences ending in every slice (two in the first, so
   ranks 1-3 hold none of their tokens): one paged_attention launch a rank
   and call, the result within TOL of paged_attention over the whole cache
   and of the plain version on rank 0; whisper-tiny's gradients of one
   bf16 step on each rank's own batch through ``compress_tree`` and the
   int8 cross-pod mean: int8 payloads gathered, the mean bitwise rank 0's
   rank-order sum of every rank's dequantized payload, within 0.51 of the
   largest per-rank scale of the uncompressed mean; qwen3-1.7b's 28
   blocks at full width as 4 GPipe stages of 7 in bf16 over 4
   micro-batches of 2 x 189 tokens (28 flash_attention launches a rank)
   against ``unpipelined_reference``; whisper-tiny's train state
   (parameters and AdamW moments) checkpointed three times by the smoke's
   process while the ranks start, then restored by every rank of a (2, 2)
   ("data", "model") mesh (parameters by ``param_specs``, moments by
   ``zero1_specs``): opening the store replays its vLSM index
   (overlap_scan and merge_path must launch on every rank), and every
   shard is bitwise the saved slice.

Where the time goes is read outside the smoke, to keep its time:
``scripts/probe.py profiles`` (vlsm's store path under torch.profiler and
cProfile, phase 3d's admission-on serve of vlsm at factor 2) and
``serve_zamba2 serve_qwen3 serve_gemma3 serve_deepseek serve_whisper``
(the serving paths' 2-request profiles); ``probe.py flash_decode`` times
phase 7's decode, ``probe.py gemma3_bwd`` the backward at gemma3-1b's
shapes, ``probe.py train_gemma3_long`` a profiled 4,096-token gemma3 step.  Every phase's wall seconds go into the report.

The CPU tier's runs that phases 3e and 6 compare against are computed by
one spawned worker, started once phase 3's store path is done, beside
every later phase, queued behind the CPU halves of 4b's training
cross-checks (and mamba2-130m's float64 run; gemma3-1b's and
deepseek-v2-lite's halves are computed in the main process, whose
results would take longer to come back through the worker's pipe than
to compute) and the dry-run's plan, which are wanted sooner; vlsm's
store path, run once just before and once just after the worker
starts, records its toll on a host-bound wall.  db_bench (3b) and the fleet matrix (3c) run
in a second spawned process on the card from then on, beside 3c's
workers, 3d, 3e, 4b's whisper run and cross-checks and 6's serving
cross-checks (both sides host-bound, the card idle most of the time);
the serving paths (4), 4b's training steps and the kernel timings (5)
wait for it, so that none of their walls or device times is taken beside
it.  The order run: 1-3, 3b-3c in the bench process, 3c's workers, 3d,
3e, 4b's whisper and cross-checks, 6's serving checks, the wait, 4, 4b's
steps, 5, 6's store cross-checks, 7.

Prints the card line, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  ``--out DIR`` also writes every number
to ``DIR/chip_smoke.json``.  Exits non-zero without a result when torch
sees no CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor-core rate
LINDLEY_TOL_S = 1e-9
# Kernel against plain version, element by element: |got - want| <= atol +
# rtol * |want|.  The atols are the reference's own (tests/test_kernels.py)
# except the bf16 ones of flash and paged_attention: both sides compute in
# fp32 from the same inputs (the bf16 flash kernel keeps P to ~16 bits) and
# round once to bf16, so they differ by at most one bf16 ulp (< 2^-7 |want|)
# and ~1e-4 before rounding.
# ssd's fp32 rtol covers its cumsums over 64- vs 128-step chunks: exponents
# up to ~700 carry ~1e-5 relative error into y (a CPU emulation of the
# kernel's chunking reaches a quarter of it).  SSD_STATE_TOL holds the
# final state: fp32 arithmetic from fp32 or bf16 inputs; from bf16 inputs
# the kernel's y-state (no state_dt) carries ~16 significant bits of each
# chunk's (B * w)^T X (bf16 hi + lo parts), the final-state run (state_dt,
# the model's) ~24 (three parts).
# The backward's fp32 entry: dK and dV sum up to 8 heads x 384 queries or
# 1 head x 1,500 queries of products, dQ up to 1,500 keys, in another order than the plain version's
# einsums, and P is recomputed through expf on each side (~1e-6 relative
# each); its bf16 entry is the forward's: both sides accumulate in fp32 and
# round once to bf16, so a group of 8 needs no more.
TOL = {("flash_attention", "float32"): (2e-5, 0.0),
       ("flash_attention", "bfloat16"): (1e-3, 1e-2),
       ("flash_attention_bwd", "float32"): (1e-4, 1e-4),
       ("flash_attention_bwd", "bfloat16"): (1e-3, 1e-2),
       ("ssd_scan", "float32"): (2e-4, 1e-4),
       ("ssd_scan", "bfloat16"): (6e-2, 1e-2),
       ("paged_attention", "float32"): (2e-5, 0.0),
       ("paged_attention", "bfloat16"): (1e-3, 1e-2)}
SSD_STATE_TOL = (2e-4, 1e-4)
SERVE_REQUESTS = 8             # serve.run's default, the reference's
DECODE_TOKENS = 16             # serve.run's default, the reference's
PROFILE_REQUESTS = 2           # the profiled serving runs (probe.py serve_*)
# serving model -> (kernels its run must launch, depth of the float32
# card-vs-CPU cross-check); the prefix cache's lookups each launch
# lookup_probe, its index's GET path; deepseek-v2-lite's MLA and MoE run
# no kernel of their own, so only lookup_probe launches there;
# mamba2-130m is attention-free (ssd_scan in its prefill, the recurrence in
# plain torch in its decode) and is cross-checked at its full 24 layers
GQA_SERVE = ("flash_attention", "lookup_probe", "paged_attention")
SERVE_PATHS = {
    "zamba2_1_2b": (("flash_attention", "ssd_scan", "lookup_probe",
                     "paged_attention"), 7),
    "qwen3_1_7b": (GQA_SERVE, 2),
    "gemma3_1b": (GQA_SERVE, 6),
    "deepseek_v2_lite": (("lookup_probe",), 2),
    "whisper_tiny": (GQA_SERVE, 4),
    "llama3_2_3b": (GQA_SERVE, 2),
    "yi_6b": (GQA_SERVE, 2),
    "qwen2_vl_2b": (GQA_SERVE, 2),
    "mamba2_130m": (("ssd_scan", "lookup_probe"), 24)}
# cross-checks whose prompt is not the first serving request's: (seeded
# prompt tokens, cache length, greedy steps); gemma3's 1,000 tokens pass
# its 512-token window in the prefill and in every decode step (its 6
# layers are 5 local and 1 global)
CROSS_LONG = {"gemma3_1b": (1000, 1024, 16)}
LONG_WINDOW_DECODE = 16        # gemma3-1b's decode steps after 4,096 tokens
# whisper-tiny's encoder frames (its cross cache holds them in 1,504 rows)
WHISPER_FRAMES = 1500
# flash_attention's non-causal Sq != Sk edge cases (phase 2)
CROSS_SQ = (1, 63, 64, 65, 189)
CROSS_SK = (1, 65, WHISPER_FRAMES)
# flash_attention_bwd's edge cases: causal S, and non-causal (Sq, Sk)
BWD_S = (1, 17, 63, 64, 65, 130, 384)
BWD_CROSS = ((1, WHISPER_FRAMES), (63, 65), (65, 1), (64, 64),
             (189, WHISPER_FRAMES))
# the training phase: qwen3-1.7b at full size, and whisper-tiny through the
# training launcher with one injected failure
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3_1_7b", 8, 64, 4
# the caching allocator rounds every block up to a multiple of this
ALLOC_ROUND = 512
WHISPER_TRAIN = {"steps": 40, "ckpt_every": 20, "fail_at": 30, "batch": 8,
                 "seq": 64}
# its losses' band around ln(vocab): no divergence (see train_whisper)
WHISPER_LOSS_BAND = 0.25
# the float32 card-vs-CPU training cross-check: arch -> (depth, None for
# the full depth; batch; sequence; whether the parameters are held to a
# float64 run too); zamba2 at 7 layers has one shared-attention
# application, as its serving cross-check; gemma3 at 6 has five local
# layers and a global one (its D 256 backward), deepseek-v2-lite at 2 its
# dense first layer and one MoE layer (MLA, plain torch on both sides).  mamba2-130m (N 128) runs at
# its full 24 layers, where the fp32 rounding of either side is amplified
# the most: two AdamW steps, whose normalised update follows the sign of
# gradients at the rounding's level, leave from ~0.06% to ~0.5% of the
# parameters more than 1e-5 apart, depending on the weights' draw
# (``scripts/probe.py cross_depth``; PERF.md, section 6), so its
# parameters are also held to a float64 run.  The CPU halves run in the
# spawned worker (``cross_train_cpu``).
CROSS_TRAIN = {TRAIN_ARCH: (2, 2, 32, False),
               "whisper_tiny": (None, 2, 32, False),
               "zamba2_1_2b": (7, 2, 32, False),
               "mamba2_130m": (None, 2, 32, True),
               "gemma3_1b": (6, 2, 32, False),
               "deepseek_v2_lite": (2, 2, 32, False)}
# the cross-checks whose CPU half the main process computes itself: their
# results (3.7 and 8.7 GB of gradients and parameters) took 72 and 196 s
# to come back from the worker through its pipe, against 24 and 66 s of
# computing (``scripts/probe.py cross_train_worker``, PERF.md)
CROSS_TRAIN_HERE = ("gemma3_1b", "deepseek_v2_lite")
# the ssm/hybrid training phase: zamba2-1.2b at full size, TRAIN_BATCH x
# TRAIN_SEQ, on one fixed batch of a stream it can learn (learnable_batch)
SSM_TRAIN_ARCH, SSM_TRAIN_STEPS = "zamba2_1_2b", 5
# gemma3-1b's training at full size, as zamba2's (its flash_attention_bwd
# runs at D 256, its local layers with the 512-token window)
GEMMA_TRAIN_STEPS = 5
# deepseek-v2-lite's training at full width, depth cut to 4 layers (1 dense,
# 3 MoE; 2.25 B parameters, ~27 GB of bf16 weights and gradients and fp32
# moments, where the full 27 layers would take ~188 GB), on TokenPipeline
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = "deepseek_v2_lite", 4, 3
# ssd_scan_bwd's edge cases (phase 2): sequence lengths, and (N, P)
SSD_BWD_L = (0, 1, 63, 64, 65, 189, 300)
SSD_BWD_NP = ((64, 64), (128, 64), (16, 32), (64, 48))
# ssd_scan_bwd against its plain version, each output element by element:
# |got - want| <= atol * max|want| + rtol * |want|, check_ssd's TOL form
# with atol scaled to the gradient's largest |element| (gradients run from
# ~1e-4 to ~1e3 with dt from 1e-4 to 10).  float32: ssd_scan's own entry,
# for the same reason (64- against 128-step chunks: the cumsums' rounding
# moves the decays by ~1e-5 relatively).  bfloat16: both sides compute in
# fp32 from the same bf16 inputs and round dx, dB and dC once, which moves
# them by at most one bf16 ulp (2^-8 of |want| < rtol); atol keeps the
# float32 entry's margin over the chunking (a CPU mirror of the kernel's
# passes stays within 2e-5 of the largest element).
TOL_BWD = {"float32": (2e-4, 1e-4), "bfloat16": (1e-3, 1e-2)}
# flash_attention_bwd's edge cases at whisper-tiny's training shapes (B 8,
# 6 heads of 64): the encoder's 1,500 frames, the cross attention's 64
# tokens over them (both non-causal), the decoder's causal 64: (Sq, Sk,
# causal)
BWD_WHISPER = ((WHISPER_FRAMES, WHISPER_FRAMES, False),
               (WHISPER_TRAIN["seq"], WHISPER_FRAMES, False),
               (WHISPER_TRAIN["seq"], WHISPER_TRAIN["seq"], True))
# flash_attention_bwd's edge cases at gemma3-1b's long shapes: B 1, 4 query
# heads over 1 kv head of 256, 4,096 tokens, causal, with its local layers'
# 512-token window and global (the LONG_PREFILL and GEMMA_WINDOW below)
BWD_GEMMA = (1, 4, 1, 256)
CROSS_TOL = 1e-3               # of max(1, max|logit|), see serve_cross_check
LONG_PREFILL = 4096
GEMMA_WINDOW = 512             # gemma3-1b's local layers
GEMMA_WINDOWS = (1, 16, GEMMA_WINDOW)   # flash_attention's D 256 edge cases
LONG_DECODE = (8, 4096, 2048)  # sequences, tokens each, pages in the pool
STORE_KERNELS = ("merge_path", "overlap_scan", "lookup_probe", "lindley_scan")
# the serving path whose launches each LM kernel's row reports
# (flash_attention_bwd's row: qwen3-1.7b's training steps, the D 128 route
# it is timed at; gemma3-1b's D 256 launches are in the report's
# train_gemma3)
ROW_PATH = {"flash_attention": "zamba2_1_2b", "ssd_scan": "zamba2_1_2b",
            "flash_attention_bwd": "train_qwen3",
            "ssd_scan_bwd": "train_zamba2",
            "paged_attention": "qwen3_1_7b"}
SOURCES = {"merge_path": "kernels/merge_path/kernel.py:131",
           "overlap_scan": "kernels/overlap_scan/kernel.py:63",
           # no TPU kernel: XLA's fusion of the reference's GET chain
           # around _rank_kernel
           "lookup_probe": "core/lsm.py:539",
           "lindley_scan": "kernels/lindley_scan/kernel.py:61",
           "flash_attention": "kernels/flash_attention/kernel.py:108",
           # no TPU backward kernel: the gradient of this one
           "flash_attention_bwd": "kernels/flash_attention/kernel.py:108",
           "ssd_scan": "kernels/ssd_scan/kernel.py:81",
           # no TPU backward kernel: the gradient of this one
           "ssd_scan_bwd": "kernels/ssd_scan/kernel.py:81",
           "paged_attention": "kernels/paged_attention/kernel.py:102"}
# the CUDA file of a kernel not named after its own (csrc/<name>.cu)
CSRC = {"lookup_probe": "overlap_scan"}
# the store path's policies: every registered one (phase 3); the card-vs-CPU
# cross-check (phase 6) keeps to the first two
CROSS_POLICIES = ("vlsm", "rocksdb")
N_LOAD = 8_000_000             # uniform keys loaded (before de-duplication)
N_RUN = 2_000_000              # YCSB Run A ops after the settle
LINDLEY_ROWS = 4096            # the ragged batch lindley_scan is timed at
BENCH_WAIT_S = 900             # the wait for the bench process (before 4)
# db_bench rows against the reference's committed rows: the keys that may
# differ (timings and machine facts, as scripts/check_row_parity.py drops
# them, and the two keys naming the tier), the rounded simulated-time
# fields with the decimals db_bench keeps (one unit of the last may
# differ), and the fleet summary's parity gap, which is held to
# LINDLEY_TOL_S instead
# (perf_trajectory's task, cache-hit and cache-miss counts and its worker
# count are compared: tests/test_torch_db_bench.py shows them equal to the
# reference's)
ROW_VOLATILE = frozenset({
    "wall_clock_s", "fleet_wall_s", "serial_wall_s", "speedup",
    "structural_s", "temporal_s", "lindley_s", "finalize_s", "cache_hit",
    "executor_wall_s", "serial_equiv_s", "index_backend", "backend"})
ROW_ROUNDED = {"p50_get_ms": 3, "p99_get_ms": 3, "p999_get_ms": 3,
               "p99_ms": 3, "p999_ms": 3,
               "p99_put_ms": 3, "p999_put_ms": 3, "p50_scan_ms": 3,
               "p99_scan_ms": 3, "p999_scan_ms": 3, "stall_total_s": 4,
               "stall_max_ms": 2, "stall_s": 4, "chain_stall_s": 4,
               "stall_attributed_s": 4, "p50_critical_path_ms": 3,
               "p99_critical_path_ms": 3}
ROW_PARITY = "parity_max_abs_latency_s"
CARD_STATE = ("uuid,driver_version,clocks.sm,clocks.max.sm,clocks.mem,"
              "temperature.gpu,power.draw")
FLEET_OPS, FLEET_POP = 30_000, 40_000   # db_bench's fleet_sweep, full size
# phase 3d: db_bench's pinned serve spec at the paper's byte scale (2,000,000
# ops offered over 8,000,000 preloaded keys), at 4,000, 8,000 and 32,000
# ops/s: the last is past the admission knee (the pre-pass sheds the
# priority-1 and -2 tenants there), and the FleetEngine is held to the serial engine at the last two
SERVE_DURATION_S, SERVE_POPULATION = 500.0, 8_000_000
SERVE_OPEN_FACTORS = (1.0, 2.0, 8.0)
SERVE_FLEET_FACTORS = (2.0, 8.0)
SERVE_POLICIES = ("vlsm", "rocksdb")
# phase 3e: ShardedStore over 4 hash shards at the paper's byte scale
SHARD_COUNT, SHARD_LOAD, SHARD_OPS, SHARD_BATCH = 4, 400_000, 100_000, 10_000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_query(fields: str) -> str:
    """nvidia-smi's csv line of ``fields`` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return card_query("name,power.limit")


def cuda_ms(torch, fn, reps: int) -> float:
    """Per-call time: ``reps`` back-to-back calls between two CUDA events,
    median of five trials after two warm-up calls.  Where a call's host
    work outlasts its kernels, this is the host's launch rate."""
    fn()
    fn()
    trials = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        trials.append(start.elapsed_time(end) / reps)
    trials.sort()
    return trials[2]


def kernel_times_us(prof) -> list[tuple[str, float, int]]:
    """(name, total device microseconds, count) of every device-side event
    (kernels and copies) a torch.profiler run recorded."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def profiled_rows(torch, fn, reps: int) -> list[tuple[str, float, int]]:
    """``kernel_times_us`` of ``reps`` calls of ``fn`` under torch.profiler,
    after one call outside it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_times_us(prof)


def device_ms(torch, fn, reps: int) -> tuple[float | None, float]:
    """Device time per call: the durations of the kernels ``reps`` calls
    launch, from torch.profiler (None when it records no device time); and
    the device events recorded per call (a window that holds every call's
    kernels counts as many as one call launches)."""
    rows = profiled_rows(torch, fn, reps)
    total = sum(us for _, us, _ in rows)
    return (total / reps / 1e3 if total > 0 else None,
            sum(c for _, _, c in rows) / reps)


def pass_ms(torch, fn, reps: int) -> dict:
    """Per kernel ``fn`` launches (by its function name; copies by theirs):
    its device time per call from torch.profiler and the device events it
    recorded per call."""
    out: dict = {}
    for name, us, count in profiled_rows(torch, fn, reps):
        m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
        row = out.setdefault(m.group(1) if m else name,
                             {"ms": 0.0, "events": 0.0})
        row["ms"] += us / reps / 1e3
        row["events"] += count / reps
    return out


def time_all(torch, kernel, plain, library, reps: int) -> dict:
    """``*ms``: CUDA-event time per call of back-to-back calls, median of
    five trials, host launch work included; ``*device_ms``: the kernels' own
    device time per call from torch.profiler (None if it records none) and
    ``*device_events``, the device events it recorded per call."""
    out = {"library_ms": None, "library_device_ms": None}
    for key, fn, n in (("", kernel, reps), ("plain_", plain, max(1, reps // 4)),
                       ("library_", library, reps)):
        if fn is None:
            continue
        out[f"{key}ms"] = cuda_ms(torch, fn, n)
        out[f"{key}device_ms"], out[f"{key}device_events"] = device_ms(
            torch, fn, n)
    return out


def distinct_probes(torch, fences, keys, side: str) -> int:
    """Fence entries a binary search of every key reads, counted once: the
    bytes a rank of this run's keys must move, beside the keys and ranks."""
    n = int(fences.shape[0])
    lo = torch.zeros_like(keys)
    hi = torch.full_like(keys, n)
    seen = []
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        seen.append(mid[active])
        v = fences[mid.clamp(max=n - 1)]
        below = (v <= keys) if side == "right" else (v < keys)
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return int(torch.unique(torch.cat(seen)).numel())


class CallShapes:
    """Counts the sizes of every card call of a kernel's wrapper that
    launches, by wrapping its name in the store's modules that imported it;
    the package itself is left as it is.  ``shape(*args)`` gives a call's
    sizes, or None for a call that launches nothing."""

    def __init__(self, ops_module: str, name: str, modules, shape):
        self.counts: collections.Counter = collections.Counter()
        self._where = (ops_module, name, modules, shape)
        self._patched: list = []

    def __enter__(self):
        import importlib
        ops_module, name, modules, shape = self._where
        orig = getattr(importlib.import_module(ops_module), name)
        counts = self.counts

        def recorded(*args, **kwargs):
            key = shape(*args, **kwargs)
            if key is not None:
                counts[key] += 1
            return orig(*args, **kwargs)
        for mod_name in modules:
            mod = importlib.import_module(f"repro_torch.core.{mod_name}")
            if getattr(mod, name) is orig:
                setattr(mod, name, recorded)
                self._patched.append(mod)
        self._orig = orig
        return self

    def __exit__(self, *exc):
        for mod in self._patched:
            setattr(mod, self._where[1], self._orig)

    def report(self) -> dict:
        return {"calls": sum(self.counts.values()),
                "distinct_shapes": len(self.counts),
                "top": [[*k, c] for k, c in self.counts.most_common(12)]}


def rank_shapes() -> CallShapes:
    """(keys, fences) of every card call of fence_rank with keys."""
    def shape(fences, keys, side="right"):
        if keys.is_cuda and keys.numel():
            return int(keys.numel()), int(fences.shape[0])
        return None
    return CallShapes("repro_torch.kernels.overlap_scan.ops", "fence_rank",
                      ("lsm", "sst", "level_index", "memtable", "vsst"),
                      shape)


def merge_shapes() -> CallShapes:
    """(A's length, B's length) of every card call of merge_two_runs with
    a key to merge."""
    def shape(a_keys, a_seqs, b_keys, b_seqs):
        n_a, n_b = int(a_keys.shape[0]), int(b_keys.shape[0])
        return (n_a, n_b) if a_keys.is_cuda and n_a + n_b else None
    return CallShapes("repro_torch.kernels.merge_path.ops", "merge_two_runs",
                      ("merge",), shape)


class CompactionInputs:
    """The runs that each compaction merges: wraps ``LSMTree.merge_runs``
    (the one door of every compaction's merge) and counts, per call, the
    runs holding a key.  A call of r such runs launches merge_path r - 1
    times, and every input SST of the job log is one such run, so
    ``pairwise`` must equal merge_path's launches and ``runs`` the job
    log's input SSTs.  The package itself is left as it is."""

    def __enter__(self):
        from repro_torch.core.lsm import LSMTree
        self.runs = self.pairwise = 0
        self._orig = orig = LSMTree.merge_runs

        def recorded(tree, runs):
            r = sum(1 for k, _ in runs if k.shape[0])
            self.runs += r
            self.pairwise += max(r - 1, 0)
            return orig(tree, runs)
        LSMTree.merge_runs = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.core.lsm import LSMTree
        LSMTree.merge_runs = self._orig


class GetBatches:
    """The GET batches of a run: wraps ``LSMTree._lookup_batch`` (the one
    door of every GET batch) and counts the calls that hold a key, each of
    which launches lookup_probe once on the card, by their number of keys.
    The package itself is left as it is."""

    def __enter__(self):
        from repro_torch.core.lsm import LSMTree
        self.sizes: collections.Counter = collections.Counter()
        self._orig = orig = LSMTree._lookup_batch

        def recorded(tree, keys):
            if keys.shape[0]:
                self.sizes[int(keys.shape[0])] += 1
            return orig(tree, keys)
        LSMTree._lookup_batch = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.core.lsm import LSMTree
        LSMTree._lookup_batch = self._orig

    def median(self) -> int:
        """The median batch's number of keys (0 without a batch)."""
        calls = sorted(self.sizes.elements())
        return calls[len(calls) // 2] if calls else 0

    def report(self) -> dict:
        return {"calls": sum(self.sizes.values()),
                "keys": sum(k * c for k, c in self.sizes.items()),
                "median_keys": self.median(),
                "max_keys": max(self.sizes, default=0)}


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def roofline(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what sets it): bytes at 3.35 TB/s or bf16 operations at
    989 TFLOP/s, whichever takes longer."""
    b_ms, f_ms = bound_ms(nbytes), flops / BF16_FLOP_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


# --------------------------------------------------------------- workloads
def ycsb_trace(np, n_load: int, n_run: int, seed: int = 7):
    """Load (unique uniform keys, 500k ops/s), 10 s settle, Run A at 8k/s."""
    from repro_torch.bench_kv.workloads import load_keys, make_run_a
    pop = np.unique(load_keys(n_load, seed=seed))
    spec = make_run_a(pop, n_run, dist="zipfian")
    ops = np.concatenate([np.zeros(pop.shape[0], np.uint8), spec.op_types])
    keys = np.concatenate([pop, spec.keys])
    load = np.arange(pop.shape[0], dtype=np.float64) / 500_000.0
    run = load[-1] + 10.0 + np.arange(n_run, dtype=np.float64) / 8_000.0
    return ops, keys, np.concatenate([load, run]), pop.shape[0]


def run_main_path(torch, np, policy: str, trace, compute_device: str):
    from repro_torch.core import (DeviceModel, Simulator, UidNamespace,
                                  get_policy)
    cfg = get_policy(policy).default_config(scale=64 << 20)
    sim = Simulator(cfg, DeviceModel.scaled(1.0), uids=UidNamespace(),
                    compute_device=compute_device)
    ops, keys, arrivals, _ = trace
    t0 = time.perf_counter()
    res = sim.run(ops, keys, arrivals)
    if compute_device == "cuda":
        torch.cuda.synchronize()
    return sim, res, time.perf_counter() - t0


def summarize(np, sim, res, n_load: int, wall: float) -> dict:
    lat = res.latency[n_load:]
    kinds = res.op_types[n_load:]
    if lat.size == 0 or not np.all(np.isfinite(res.latency)) \
            or np.any(res.latency < 0):
        fail("latencies must be finite and non-negative")
    put, get = lat[kinds == 0], lat[kinds == 1]
    st = sim.stats
    run_stalls = [d for i, d in sim.stall_events if i >= n_load]
    return {
        "wall_s": wall,
        "levels_mb": [s / 1e6 for s in sim.trees[0].level_sizes()],
        "p99_put_ms": float(np.percentile(put, 99)) * 1e3,
        "p999_put_ms": float(np.percentile(put, 99.9)) * 1e3,
        "p99_get_ms": float(np.percentile(get, 99)) * 1e3,
        "p999_get_ms": float(np.percentile(get, 99.9)) * 1e3,
        "n_stalls": res.n_stalls, "stall_total_s": res.stall_total,
        "run_phase_stalls": len(run_stalls),
        "run_phase_stall_s": float(sum(run_stalls)),
        "n_chains": len(st.l0_chains),
        "mean_chain_width_ssts": st.mean_chain_fanin,
        "effective_chain_length": st.effective_chain_length,
        "io_amp": st.io_amp,
    }


# ------------------------------------------------------------ edge checks
def check_equal(torch, what: str, got, want) -> int:
    """Fails unless every pair is equal; returns the largest |got - want|."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"{what}: kernel's shape differs from its plain version's")
        if g.numel():
            err = max(err, int((g - w).abs().max()))
        if err or not torch.equal(g, w):
            fail(f"{what}: kernel disagrees with its plain version")
    return err


def edge_merge(torch, np, rng) -> int:
    """merge_path against its plain version, exactly: INT64_MIN/MAX, empty
    runs; then, around the kernel's tile T, outputs of T - 1, T, T + 1 and
    several tiles (one run alone and split between both); all-equal keys in
    both runs (ties on every tile's diagonal); duplicates within each run;
    1 key against 1,000,000 both ways; and a call on a side stream."""
    from repro_torch.kernels.merge_path.ops import (TILE, merge_two_runs,
                                                    merge_two_runs_plain)
    big = 2 ** 62
    cases = [
        (np.array([-big, 0, 5, big]), np.array([-big, 5, 6, big])),
        (np.array([], np.int64), np.array([1, 2, 3])),
        (np.array([1, 2, 3]), np.array([], np.int64)),
        (np.array([-2 ** 63, 7]), np.array([-2 ** 63, 2 ** 63 - 1])),
        (np.unique(rng.integers(-1000, 1000, 1500)),
         np.unique(rng.integers(-1000, 1000, 900))),
    ]
    more = np.random.default_rng(22)        # rng's draws stay as they were
    for n in (TILE - 1, TILE, TILE + 1, 5 * TILE + 3):
        keys = np.sort(more.integers(-2 ** 63, 2 ** 63 - 1, n))
        cases += [(keys, np.array([], np.int64)),
                  (np.array([], np.int64), keys),
                  (keys[::2], np.unique(keys[1::2]))]
    cases += [(np.full(3 * TILE + 7, 9), np.full(2 * TILE - 5, 9)),
              (np.full(TILE, -2 ** 63), np.full(TILE + 1, -2 ** 63)),
              (np.sort(more.integers(0, 50, 6000)),
               np.sort(more.integers(0, 50, 4000))),
              (np.array([500_000]), np.arange(1_000_000) * 2),
              (np.arange(1_000_000) * 2 + 1, np.array([-3]))]
    err = 0
    for a, b in cases:
        a = torch.tensor(np.asarray(a, np.int64), device="cuda")
        b = torch.tensor(np.asarray(b, np.int64), device="cuda")
        sa = torch.arange(a.shape[0], device="cuda") + 2 ** 40
        sb = torch.arange(b.shape[0], device="cuda") + 2 ** 41
        err = max(err, check_equal(
            torch, f"merge_path edge case {a.shape[0]} + {b.shape[0]}",
            merge_two_runs(a, sa, b, sb), merge_two_runs_plain(a, sa, b, sb)))
    side_stream = torch.cuda.Stream()
    side_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side_stream):
        got = merge_two_runs(a, sa, b, sb)
    side_stream.synchronize()
    return max(err, check_equal(torch, "merge_path on a side stream",
                                [t.cpu() for t in got],
                                [t.cpu() for t in merge_two_runs_plain(
                                    a, sa, b, sb)]))


def edge_rank(torch, np, rng) -> int:
    """overlap_scan against its plain version and np.searchsorted, exactly:
    empty, duplicate and INT64_MIN/MAX fences, random fences around 2^12 - 1
    (4,094-4,097: where a search staging the top of the tree in shared
    memory would change paths), 6,143-6,145 (a former shared-memory path's
    limit) and 7,000; 1, 255,
    257 and 3,007 keys (partial blocks); non-contiguous keys; and a call on
    a side stream."""
    from repro_torch.kernels.overlap_scan.ops import (fence_rank,
                                                      fence_rank_plain)
    lo, hi = -2 ** 63, 2 ** 63 - 1
    fence_sets = [np.array([], np.int64), np.array([3, 3, 3, 9, 9]),
                  np.array([lo, 0, hi]),
                  np.sort(rng.integers(-50, 50, 7000)),
                  np.sort(rng.integers(-50, 50, 6144))]
    keys = np.concatenate([[lo, hi, lo + 1, hi - 1, 0, 3, 9],
                           rng.integers(-60, 60, 3000)]).astype(np.int64)
    sizes = np.random.default_rng(21)       # rng's draws stay as they were
    fence_sets += [np.sort(sizes.integers(-50, 50, n))
                   for n in (4094, 4095, 4096, 4097, 6143, 6145)]
    fence_sets.append(np.array([lo] * 40 + [3] * 5000 + [hi] * 90, np.int64))
    k_all = torch.tensor(keys, device="cuda")
    err = 0
    for fences in fence_sets:
        f = torch.tensor(np.asarray(fences, np.int64), device="cuda")
        for m in (1, 255, 257, keys.size):
            k = k_all[:m]
            for side in ("right", "left"):
                got = fence_rank(f, k, side)
                want = torch.from_numpy(np.searchsorted(
                    fences, keys[:m], side).astype(np.int64)).to("cuda")
                err = max(err, check_equal(
                    torch, f"overlap_scan edge case n={fences.size} m={m} "
                    f"({side})", [got, got],
                    [fence_rank_plain(f, k, side), want]))
    f = torch.tensor(fence_sets[3], device="cuda")
    strided = k_all[1::2]
    want = torch.from_numpy(np.searchsorted(fence_sets[3], keys[1::2],
                                            "left").astype(np.int64))
    err = max(err, check_equal(torch, "overlap_scan, strided keys",
                               [fence_rank(f, strided, "left").cpu()], [want]))
    side_stream = torch.cuda.Stream()
    side_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side_stream):
        got = fence_rank(f, strided, "left")
    side_stream.synchronize()
    return max(err, check_equal(torch, "overlap_scan on a side stream",
                                [got.cpu()], [want]))


def check_lindley(torch, what: str, s, a, offsets, d0=None) -> float:
    """lindley_scan called twice: within LINDLEY_TOL_S of its plain version
    and bitwise equal to itself; returns the largest |err|."""
    from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                      lindley_batch_plain)
    got = lindley_batch(s, a, offsets, d0)
    again = lindley_batch(s, a, offsets, d0)
    err = float((got - lindley_batch_plain(s, a, offsets, d0)).abs().max()) \
        if got.numel() else 0.0
    if not err <= LINDLEY_TOL_S:
        fail(f"lindley_scan {what}: max |err| {err} > {LINDLEY_TOL_S}")
    if not torch.equal(got.view(torch.int64), again.view(torch.int64)):
        fail(f"lindley_scan {what}: two calls differ")
    return err


def edge_lindley(torch, np, rng) -> float:
    """lindley_scan against its plain version (within 1e-9 s) and against
    itself (bitwise, two calls): a ragged batch with empty rows, rows of
    1,023-1,025 ops and a 1.5 M-op row; rows of T - 1, T,
    T + 1 and 3T + 5 ops around the kernel's tile T (one row alone and
    all together, unaligned offsets); 10,000 rows of 0-3 ops; a row of 5
    tiles whose running max is d0 throughout; and a row of 5 tiles with a
    NaN of all-ones bits in its service and its arrivals, which must end
    and agree with the plain version before the NaN."""
    from repro_torch.kernels.lindley_scan.ops import TILE
    lens = [0, 1, 1023, 1024, 1025, 0, 5000, 1_500_000]
    d0 = [0.0, 3.0, -np.inf, 1.0, -np.inf, 2.0, 0.5, -np.inf]
    n = sum(lens)
    service = rng.exponential(2e-6, n)
    arrivals = np.concatenate([np.sort(rng.uniform(0, 300, m)) for m in lens])
    offsets = np.concatenate([[0], np.cumsum(lens)])
    s = torch.from_numpy(service).to("cuda")
    a = torch.from_numpy(arrivals).to("cuda")
    err = check_lindley(torch, "edge cases", s, a, offsets, d0)
    more = np.random.default_rng(23)        # rng's draws stay as they were
    lens = [TILE - 1, TILE, TILE + 1, 3 * TILE + 5]
    service = more.exponential(1e-3, sum(lens))
    arrivals = np.concatenate([np.sort(more.uniform(0, 10, m)) for m in lens])
    s = torch.from_numpy(service).to("cuda")
    a = torch.from_numpy(arrivals).to("cuda")
    offsets = np.concatenate([[0], np.cumsum(lens)])
    err = max(err, check_lindley(torch, "rows around the tile", s, a,
                                 offsets, [-np.inf, 1.0, 5.0, -np.inf]))
    for r, m in enumerate(lens):
        lo = int(offsets[r])
        err = max(err, check_lindley(torch, f"one row of {m} ops",
                                     s[lo:lo + m], a[lo:lo + m], [0, m]))
    lens = more.integers(0, 4, 10_000)
    service = more.exponential(1e-3, int(lens.sum()))
    arrivals = more.uniform(0, 1, int(lens.sum()))
    offsets = np.concatenate([[0], np.cumsum(lens)])
    for r in range(lens.size):
        arrivals[offsets[r]:offsets[r + 1]].sort()
    err = max(err, check_lindley(
        torch, "10,000 rows of 0-3 ops", torch.from_numpy(service).cuda(),
        torch.from_numpy(arrivals).cuda(), offsets,
        more.uniform(-1, 1, lens.size)))
    m = 5 * TILE
    s = torch.from_numpy(more.exponential(1e-6, m)).cuda()
    a = torch.from_numpy(np.sort(more.uniform(0, 1, m))).cuda()
    err = max(err, check_lindley(torch, "d0 above every arrival", s, a,
                                 [0, m], [1000.0]))
    # a NaN whose bits are all ones (the kernel's unpublished word) in the
    # service and the arrivals of a 5-tile row: the call must end, and the
    # departures before it agree with the plain version's
    from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                      lindley_batch_plain)
    service = more.exponential(1e-3, m)
    arrivals = np.sort(more.uniform(0, 10, m))
    first = 2 * TILE + 7
    service[first] = arrivals[3 * TILE + 1] = \
        np.array([-1], np.int64).view(np.float64)[0]
    s = torch.from_numpy(service).cuda()
    a = torch.from_numpy(arrivals).cuda()
    got = lindley_batch(s, a, [0, m])[:first]
    torch.cuda.synchronize()
    nan_err = float((got - lindley_batch_plain(s, a, [0, m])[:first])
                    .abs().max())
    if not nan_err <= LINDLEY_TOL_S:
        fail(f"lindley_scan before an all-ones NaN: max |err| {nan_err}")
    return max(err, nan_err)


# ---------------------------------------------------- main-shape timings
def time_merge(torch, sim) -> dict:
    from repro_torch.kernels.merge_path.ops import (merge_two_runs,
                                                    merge_two_runs_plain)
    tree = sim.trees[0]
    if tree.levels[0]:
        a_k, a_s = tree.levels[0][0].keys, tree.levels[0][0].seqs
    else:
        a_k, a_s = tree.memtable.to_sorted()
    b_k, b_s = tree._flat_level(1)
    got = merge_two_runs(b_k, b_s, a_k, a_s)
    err = check_equal(torch, "merge_path at the main path's shape", got,
                      merge_two_runs_plain(b_k, b_s, a_k, a_s))
    n = int(a_k.shape[0] + b_k.shape[0])
    return {
        "shape": f"L1 run {int(b_k.shape[0])} + L0 run {int(a_k.shape[0])}",
        "max_abs_err": err, "bound_ms": bound_ms(32 * n),
        **time_all(torch, lambda: merge_two_runs(b_k, b_s, a_k, a_s),
                   lambda: merge_two_runs_plain(b_k, b_s, a_k, a_s),
                   lambda: torch.sort(torch.cat([b_k, a_k]), stable=True),
                   40)}


def check_merge_at(torch, np, trace, n_a: int, n_b: int):
    """merge_path at the store's commonest merge shape: n_a and n_b of the
    loaded keys, each run sorted and unique, drawn apart (seeded); held
    against its plain version.  Returns the row and the four run tensors."""
    from repro_torch.kernels.merge_path.ops import (merge_two_runs,
                                                    merge_two_runs_plain)
    _, keys, _, n_load = trace
    pick = np.random.default_rng(24)
    runs = []
    for m, base in ((n_a, 2 ** 40), (n_b, 2 ** 41)):
        k = np.sort(pick.choice(keys[:n_load], m, replace=False))
        runs += [torch.from_numpy(k).to("cuda"),
                 torch.arange(m, device="cuda") + base]
    err = check_equal(torch, f"merge_path at {n_a} + {n_b}",
                      merge_two_runs(*runs), merge_two_runs_plain(*runs))
    return ({"shape": f"{n_a} + {n_b} keys (the store's commonest merge)",
             "max_abs_err": err, "bound_ms": bound_ms(32 * (n_a + n_b))},
            runs)


def time_merge_at(torch, np, trace, n_a: int, n_b: int) -> dict:
    """check_merge_at's row, timed beside torch.sort."""
    from repro_torch.kernels.merge_path.ops import (merge_two_runs,
                                                    merge_two_runs_plain)
    out, runs = check_merge_at(torch, np, trace, n_a, n_b)
    a_k, _, b_k, _ = runs
    return {
        **out,
        **time_all(torch, lambda: merge_two_runs(*runs),
                   lambda: merge_two_runs_plain(*runs),
                   lambda: torch.sort(torch.cat([a_k, b_k]), stable=True),
                   200)}


def time_rank(torch, np, sim, trace) -> dict:
    from repro_torch.kernels.overlap_scan.ops import (fence_rank,
                                                      fence_rank_plain)
    tree = sim.trees[0]
    deep = max(lv for lv in range(1, len(tree.levels)) if tree.levels[lv])
    fences, _ = tree._flat_level(deep)
    ops, keys, _, n_load = trace
    gets = keys[n_load:][ops[n_load:] == 1][:sim.cfg.keys_per_memtable]
    k = torch.from_numpy(np.ascontiguousarray(gets)).to("cuda")
    got = fence_rank(fences, k, "left")
    want = fence_rank_plain(fences, k, "left")
    lib = torch.searchsorted(fences, k, side="left")
    err = check_equal(torch, "overlap_scan at the main path's shape",
                      [got, got], [want, lib])
    m, n = int(k.shape[0]), int(fences.shape[0])
    return {
        "shape": f"{m} GET keys over flat L{deep} of {n} keys",
        "max_abs_err": err,
        "bound_ms": bound_ms(16 * m + 8 * distinct_probes(torch, fences, k,
                                                          "left")),
        "all_fences_bound_ms": bound_ms(8 * m + 8 * n + 8 * m),
        **time_all(torch, lambda: fence_rank(fences, k, "left"),
                   lambda: fence_rank_plain(fences, k, "left"),
                   lambda: torch.searchsorted(fences, k, side="left"), 40)}


def check_rank_at(torch, np, trace, m: int, n: int):
    """overlap_scan at the store's commonest call shape (m keys over n
    fences): n of the loaded keys, evenly spaced (sorted, unique), and the
    run's first m GET keys; held against its plain version and
    torch.searchsorted.  Returns the row, the fences and the keys."""
    from repro_torch.kernels.overlap_scan.ops import (fence_rank,
                                                      fence_rank_plain)
    ops, keys, _, n_load = trace
    pos = np.linspace(0, n_load - 1, n).astype(np.int64)
    fences = torch.from_numpy(np.ascontiguousarray(keys[:n_load][pos])) \
        .to("cuda")
    gets = keys[n_load:][ops[n_load:] == 1][:m]
    k = torch.from_numpy(np.ascontiguousarray(gets)).to("cuda")
    got = fence_rank(fences, k, "left")
    err = check_equal(torch, f"overlap_scan at {m} keys over {n}",
                      [got, got], [fence_rank_plain(fences, k, "left"),
                                   torch.searchsorted(fences, k,
                                                      side="left")])
    return ({"shape": f"{m} GET keys over {n} fences (the store's commonest "
                      "call)", "max_abs_err": err,
             "bound_ms": bound_ms(16 * m + 8 * distinct_probes(
                 torch, fences, k, "left"))}, fences, k)


def time_rank_at(torch, np, trace, m: int, n: int) -> dict:
    """check_rank_at's row, timed beside torch.searchsorted."""
    from repro_torch.kernels.overlap_scan.ops import (fence_rank,
                                                      fence_rank_plain)
    out, fences, k = check_rank_at(torch, np, trace, m, n)
    return {
        **out,
        **time_all(torch, lambda: fence_rank(fences, k, "left"),
                   lambda: fence_rank_plain(fences, k, "left"),
                   lambda: torch.searchsorted(fences, k, side="left"), 200)}


def probe_bytes(torch, keys, runs) -> int:
    """The bytes a GET walk of ``keys`` through ``runs`` must move, each
    counted once: 8 in and 24 out a key, every key and fence entry that a
    binary search over each run it reaches reads (``distinct_probes``: the
    tops of the searches, shared by many keys, once) and each hit's seq.
    The keys each run's searches see are the plain chain's own
    (``plain_walk``)."""
    from repro_torch.kernels.overlap_scan.ops import LEVEL, plain_walk
    entries = 0
    for step in plain_walk(keys, runs):
        run = step.run
        if run.kind == LEVEL:   # the fence ranks of every key reaching it
            reached = keys[step.active]
            entries += distinct_probes(torch, run.largest, reached, "left")
            entries += distinct_probes(torch, run.smallest, reached, "right")
        entries += distinct_probes(torch, run.keys, keys[step.cand], "left")
        entries += int(step.found.sum())
    return 32 * int(keys.shape[0]) + 8 * entries


def probe_keys(np, tree, trace, m: int):
    """The run phase's first m GET keys, then every fence of ``tree``, one
    below and one above each, and the int64 extremes."""
    ops, keys, _, n_load = trace
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    fences = np.concatenate([np.concatenate([tree.index.smallest[lv],
                                             tree.index.largest[lv]])
                             for lv in range(tree.cfg.max_levels)])
    return np.concatenate([
        keys[n_load:][ops[n_load:] == 1][:m], fences,
        fences[fences > lo] - 1, fences[fences < hi] + 1,
        [lo, lo + 1, hi - 1, hi]]).astype(np.int64)


def check_probe_at(torch, np, tree, trace, m: int, what: str) -> dict:
    """lookup_probe on a main path's tree as the run left it, held against
    its plain chain on the same runs, element for element: the run phase's
    first m GET keys (m, the run's median GET batch) with every fence edge
    and the int64 extremes (``probe_keys``), and the m keys alone."""
    from repro_torch.kernels.overlap_scan.ops import (
        L0_SST, LEVEL, MEMTABLE, lookup_probe, lookup_probe_plain)
    runs, fpr = tree.probe_runs(), tree.cfg.bloom_fpr
    dev = torch.device("cuda")
    edges = probe_keys(np, tree, trace, m)
    err = 0
    for batch in (edges, edges[:m]):
        err = max(err, check_equal(
            torch, f"lookup_probe on {what}'s main-path tree",
            lookup_probe(batch, runs, fpr, dev),
            lookup_probe_plain(torch.from_numpy(batch).to(dev), runs, fpr)))
    kinds = [r.kind for r in runs]
    return {"shape": f"{m} GET keys + {edges.shape[0] - m} fence edges "
                     f"over {len(runs)} runs",
            "runs": {"memtables": kinds.count(MEMTABLE),
                     "l0": kinds.count(L0_SST), "levels": kinds.count(LEVEL)},
            "max_abs_err": err}


def time_probe(torch, np, tree, trace, m: int) -> dict:
    """lookup_probe at the main path's median GET batch (m keys from the
    host, the copy in included) on vlsm's tree, beside its plain chain on
    the same runs (the chain it replaced, from keys on the card)."""
    from repro_torch.kernels.overlap_scan.ops import (lookup_probe,
                                                      lookup_probe_plain)
    runs, fpr = tree.probe_runs(), tree.cfg.bloom_fpr
    dev = torch.device("cuda")
    keys = probe_keys(np, tree, trace, m)[:m]
    k_dev = torch.from_numpy(keys).to(dev)
    err = check_equal(torch, "lookup_probe at the main path's shape",
                      lookup_probe(keys, runs, fpr, dev),
                      lookup_probe_plain(k_dev, runs, fpr))
    return {
        "shape": f"{m} GET keys over {len(runs)} runs",
        "max_abs_err": err,
        "bound_ms": bound_ms(probe_bytes(torch, k_dev, runs)),
        **time_all(torch, lambda: lookup_probe(keys, runs, fpr, dev),
                   lambda: lookup_probe_plain(k_dev, runs, fpr), None, 200)}


def lindley_queue(np, sim, res):
    """The main path's one queue: its real arrivals and its base service
    (per-kind CPU cost plus block reads at the device's block time),
    before busy inflation and stalls."""
    from repro_torch.core.sim import GET_CPU, PUT_SERVICE
    dev = sim.device
    block_t = dev.io_latency + dev.block_size / dev.read_bw
    service = np.where(res.op_types == 1, GET_CPU, PUT_SERVICE) \
        + res.get_reads * block_t
    return service, res.arrivals.astype(np.float64)


def time_lindley(torch, np, service, arrivals) -> dict:
    """One queue of float64 ``service`` and ``arrivals`` (numpy)."""
    from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                      lindley_batch_plain)
    n = int(service.shape[0])
    s = torch.from_numpy(service).to("cuda")
    a = torch.from_numpy(arrivals).to("cuda")
    offsets = [0, n]
    err = check_lindley(torch, "at the main path's shape", s, a, offsets)
    return {
        "shape": f"1 queue of {n} ops",
        "max_abs_err": err, "bound_ms": bound_ms(24 * n),
        **time_all(torch, lambda: lindley_batch(s, a, offsets),
                   lambda: lindley_batch_plain(s, a, offsets), None, 20)}


def check_lindley_ragged(torch, np, arrivals, rows: int):
    """A ragged batch of ``rows`` queues, as a fleet of shards sends:
    ``arrivals`` (the main path's) cut at ``rows - 1`` seeded points into
    contiguous rows (mean ~2,400 ops), service exponential with a 20 us
    mean; held against the plain version.  Returns the row and the
    kernel's arguments."""
    n = int(arrivals.shape[0])
    cut = np.random.default_rng(25)
    offsets = np.concatenate([[0], np.sort(cut.choice(np.arange(1, n),
                                                      rows - 1, False)), [n]])
    s = torch.from_numpy(cut.exponential(2e-5, n)).to("cuda")
    a = torch.from_numpy(arrivals.astype(np.float64)).to("cuda")
    err = check_lindley(torch, f"over {rows} rows", s, a, offsets)
    return ({"shape": f"{rows} rows, {n} ops", "max_abs_err": err,
             "bound_ms": bound_ms(24 * n + 8 * (2 * rows + 1))},
            (s, a, offsets))


def time_lindley_ragged(torch, np, arrivals, rows: int) -> dict:
    """check_lindley_ragged's row, timed."""
    from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                      lindley_batch_plain)
    out, args = check_lindley_ragged(torch, np, arrivals, rows)
    return {**out, **time_all(torch, lambda: lindley_batch(*args),
                              lambda: lindley_batch_plain(*args), None, 8)}


# ----------------------------------------------------- where time goes
def profile_main_path(torch, np, trace) -> dict:
    """vlsm's store path once more under torch.profiler for the device's
    busy time by kernel (only the device's activity is recorded: sorting
    the host's events of a store path takes the profiler minutes), and
    once more under cProfile for the host's hot spots."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_main_path(torch, np, "vlsm", trace, "cuda")
    rows = kernel_times_us(prof)
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    out = {
        "profiled_wall_s": wall,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / 1e3 / wall,
        "top_device": [{"name": n[:90], "ms": us / 1e3, "count": c}
                       for n, us, c in rows[:12]],
    }
    host = cProfile.Profile()
    host.enable()
    _, _, host_wall = run_main_path(torch, np, "vlsm", trace, "cuda")
    host.disable()
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
    out["cprofile_wall_s"] = host_wall
    out["top_host"] = [{"fn": f"{Path(f).name}:{line}:{fn}", "tottime_s": tt,
                        "calls": nc}
                       for (f, line, fn), (_cc, nc, tt, _ct, _cl) in top]
    return out


def profile_serve_open(torch, np) -> dict:
    """Phase 3d's admission-on ``Simulator.serve`` of vlsm at load factor 2
    once more under torch.profiler: the device's busy share of the whole call
    (materialize and the admission pre-pass included) by kernel.  Only the
    device's activity is recorded: the host's events of a call this long
    take the profiler minutes to sort."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bench_kv.db_bench import make_serve_spec
    from repro_torch.core import (DeviceModel, Simulator, UidNamespace,
                                  get_policy)
    policy, factor = "vlsm", 2.0
    cfg = get_policy(policy).default_config(scale=64 << 20).with_(
        n_shards=2)
    spec = make_serve_spec(duration_s=SERVE_DURATION_S,
                           population=SERVE_POPULATION, admission=True)
    sim = Simulator(cfg, DeviceModel.scaled(1.0), uids=UidNamespace())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.serve(spec, load_factor=factor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_times_us(prof)
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    return {"policy": policy, "load_factor": factor,
            "profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall,
            "top_device": [{"name": n[:90], "ms": us / 1e3, "count": c}
                           for n, us, c in rows[:8]]}


# ------------------------------------------------------- store benches
def strip_volatile(row):
    """A bench row without the keys a run may change (ROW_VOLATILE)."""
    if isinstance(row, dict):
        return {k: strip_volatile(v) for k, v in row.items()
                if k not in ROW_VOLATILE}
    if isinstance(row, list):
        return [strip_volatile(v) for v in row]
    return row


def compare_row(got, want, where: str, flips: list) -> None:
    """Fails unless ``got`` equals ``want`` (both stripped): every integer,
    string and structural field exactly; a rounded simulated-time field
    (ROW_ROUNDED) within one unit of its last kept digit, each such
    difference appended to ``flips``; the parity gap within
    LINDLEY_TOL_S."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            fail(f"row {where}: {got!r} does not have the keys "
                 f"{sorted(want)}")
        for k, w in want.items():
            g = got[k]
            if k == ROW_PARITY:
                if not g <= LINDLEY_TOL_S:
                    fail(f"row {where}: {k} {g} > {LINDLEY_TOL_S}")
            elif k in ROW_ROUNDED and not isinstance(w, bool) \
                    and isinstance(w, (int, float)):
                diff = abs(g - w)
                if diff > 10.0 ** -ROW_ROUNDED[k] * (1 + 1e-6):
                    fail(f"row {where}: {k} {g} != {w}")
                if diff:
                    flips.append(f"{where}.{k}: {g} vs {w}")
            else:
                compare_row(g, w, f"{where}.{k}", flips)
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            fail(f"row {where}: list lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            compare_row(g, w, f"{where}[{i}]", flips)
    elif type(got) is not type(want) and not (
            isinstance(got, (int, float)) and isinstance(want, (int, float))
            and not isinstance(got, bool) and not isinstance(want, bool)):
        fail(f"row {where}: {got!r} != {want!r}")
    elif got != want:
        fail(f"row {where}: {got!r} != {want!r}")


class RecordLindley:
    """Records every call of the list-of-queues Lindley front end the fleet
    engine makes (queues in, departures out), by wrapping its name in
    ``repro_torch.core.fleet``; the package is left as it is.  ``benches``
    (a ``BenchLaunches``) tags each call with the db_bench bench that made
    it (``calls[i][0]``; None without)."""

    def __init__(self, benches=None):
        self.benches = benches

    def __enter__(self):
        from repro_torch.core import fleet
        self.calls: list = []
        self._orig = orig = fleet.lindley_batch_np
        calls, benches = self.calls, self.benches

        def recorded(services, arrivals, d0=None, compute_device="cuda"):
            deps = orig(services, arrivals, d0, compute_device)
            calls.append((benches and benches.current, services, arrivals,
                          deps))
            return deps
        fleet.lindley_batch_np = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.core import fleet
        fleet.lindley_batch_np = self._orig


class BenchLaunches:
    """Kernel launches per db_bench bench: wraps the bench functions that
    ``db_bench.main`` calls by their module names and adds each call's
    launches to its bench (``fill_sim``'s to fillrandom, whose runs
    chain_report reuses); ``current`` names the bench running (None
    between benches).  The package is left as it is."""

    BENCH_OF = {"fill_sim": "fillrandom", "fillrandom": "fillrandom",
                "read_path": "read_path", "ycsb_a": "ycsb_a",
                "seekrandom": "seekrandom", "chain_report": "chain_report",
                "shard_sweep": "shard_sweep",
                "fleet_sweep_bench": "fleet_sweep",
                "serve_sweep_bench": "serve_sweep"}

    def __enter__(self):
        from repro_torch import kernels
        from repro_torch.bench_kv import db_bench
        self.per_bench: dict = {}
        self.current = None
        self._orig = {f: getattr(db_bench, f) for f in self.BENCH_OF}
        per_bench = self.per_bench

        def counted(bench, fn):
            def call(*a, **kw):
                before = kernels.launch_counts()
                self.current = bench
                try:
                    out = fn(*a, **kw)
                finally:
                    self.current = None
                after = kernels.launch_counts()
                tally = per_bench.setdefault(bench, dict.fromkeys(after, 0))
                for k in after:
                    tally[k] += after[k] - before[k]
                return out
            return call
        for f, bench in self.BENCH_OF.items():
            setattr(db_bench, f, counted(bench, self._orig[f]))
        return self

    def __exit__(self, *exc):
        from repro_torch.bench_kv import db_bench
        for f, fn in self._orig.items():
            setattr(db_bench, f, fn)


class SchemaGate:
    """The schema gate over ``db_bench.main``'s rows: its closing
    ``paranoid_validate_rows`` runs under ``REPRO_PARANOID_CHECKS=1``, and
    each row it holds to the schemas the port's lint extracts from its
    emitter is counted (both wrapped by their module names).  The switch
    is set around that call only: set for the whole run it also arms the
    store's invariant checks (``LSMConfig.paranoid_checks``, read as each
    config is made), which doubled db_bench's time on the card.  The
    schemas must not be empty, or the gate would pass every row unread."""

    def __enter__(self):
        from repro_torch.analysis import schemas
        self.families = sorted(schemas.load_schemas())
        if not self.families:
            fail("db_bench: no row schema extracted from the port's emitter")
        self.validated = 0
        self._orig = (schemas.paranoid_validate_rows,
                      schemas.validate_emitted_row)
        validate_rows, validate_row = self._orig

        def gated(rows, *a, **kw):
            env = os.environ.get("REPRO_PARANOID_CHECKS")
            os.environ["REPRO_PARANOID_CHECKS"] = "1"
            try:
                validate_rows(rows, *a, **kw)
            finally:
                if env is None:
                    os.environ.pop("REPRO_PARANOID_CHECKS")
                else:
                    os.environ["REPRO_PARANOID_CHECKS"] = env

        def counted(row, *a, **kw):
            validate_row(row, *a, **kw)
            self.validated += 1
        schemas.paranoid_validate_rows = gated
        schemas.validate_emitted_row = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.analysis import schemas
        schemas.paranoid_validate_rows, schemas.validate_emitted_row = \
            self._orig


def db_bench_rows(torch, out: Path | None) -> tuple[dict, list]:
    """db_bench's eight benches at the reference's full sizes for every
    registered policy, on the card (``db_bench.main``, from rewound uid
    counters as in a fresh process), their rows held in order against
    every committed ``BENCH_dbbench.json`` row (``compare_row``), each
    through the schema gate (``SchemaGate``); at least one row must stall.
    Returns the report and fleet_sweep's per-pass Lindley calls
    (``RecordLindley``)."""
    from repro_torch import kernels
    from repro_torch.bench_kv import db_bench
    from repro_torch.core import DEFAULT_CACHE
    from repro_torch.core.uids import reset_uid_counters
    want = json.loads((ROOT / "BENCH_dbbench.json").read_text())
    argv = [] if out is None else ["--json", str(out / "db_bench.json")]
    reset_uid_counters()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with BenchLaunches() as by_bench, RecordLindley(by_bench) as rec, \
            SchemaGate() as gate:
        rows = db_bench.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    DEFAULT_CACHE.clear()           # its prepared engines hold card memory
    if len(rows) != len(want):
        fail(f"db_bench: {len(rows)} rows, the committed file has "
             f"{len(want)}")
    if gate.validated != len(rows):
        fail(f"db_bench: {gate.validated} of {len(rows)} rows through the "
             f"schema gate")
    flips: list[str] = []
    for i, (g, w) in enumerate(zip(rows, want)):
        if g["bench"] != w["bench"]:
            fail(f"db_bench row {i}: bench {g['bench']} != {w['bench']}")
        compare_row(strip_volatile(g), strip_volatile(w),
                    f"{i}:{w['bench']}:{w.get('policy', '')}", flips)
    stalled = [f"{r['bench']}:{r['policy']}:x{r.get('n_shards', 1)}"
               for r in rows if r.get("n_stalls", 0) > 0]
    if not stalled:
        fail("db_bench: no row stalls")
    if min(launches[k] for k in STORE_KERNELS) <= 0:
        fail(f"db_bench: a store kernel never launched: {launches}")
    for k in launches:
        if sum(t[k] for t in by_bench.per_bench.values()) != launches[k]:
            fail(f"db_bench: {k}'s launches outside the benches: "
                 f"{launches[k]} in all, {by_bench.per_bench} by bench")
    per_bench: dict = collections.defaultdict(float)
    for r in rows:
        if r["bench"] != "fleet_sweep" or r.get("engine") == "summary":
            per_bench[r["bench"]] += r["wall_clock_s"]
    summary = next(r for r in rows if r.get("engine") == "summary")
    serve = [r for r in rows if r["bench"] == "serve_sweep"]
    return {"rows": len(rows), "schema_validated_rows": gate.validated,
            "schema_families": gate.families,
            "last_digit_flips": len(flips),
            "flips": flips[:20], "stalled_rows": len(stalled),
            "stalled": stalled[:12], "wall_s": wall,
            "row_wall_s": dict(per_bench),
            "fleet_summary": {k: summary[k] for k in (
                "fleet_wall_s", "serial_wall_s", "speedup",
                ROW_PARITY, "parity_stalls_equal") if k in summary},
            "serve_rows": len(serve),
            "serve_shedding_rows": sum(1 for r in serve
                                       if r["shed_frac"] > 0),
            "perf_trajectory": {k: rows[-1][k] for k in (
                "tasks", "cache_hits", "cache_misses", "workers")},
            "launches": launches,
            "launches_per_bench": by_bench.per_bench}, \
        [c[1:] for c in rec.calls if c[0] == "fleet_sweep"]


def bench_phase(out: str | None) -> tuple[dict, dict]:
    """Phases 3b and 3c's fleet matrix in the spawned bench process on the
    card: ``db_bench_rows``, then ``fleet_matrix`` against db_bench's
    per-pass calls.  A failed check comes back to the caller as a
    RuntimeError (a pool worker that exits would leave it waiting)."""
    import numpy as np
    import torch
    try:
        report, pass_calls = db_bench_rows(
            torch, None if out is None else Path(out))
        matrix, batch = fleet_matrix(torch, np, pass_calls)
    except SystemExit as e:
        raise RuntimeError(str(e)) from None
    del batch, pass_calls
    return report, matrix


def fleet_matrix(torch, np, pass_calls: list) -> tuple[dict, tuple]:
    """db_bench's fleet matrix (every policy x shard counts 1, 2, 4, 16 x
    32 rates) through ``fleet.fleet_sweep`` on the card, which must scan
    every pending queue of the matrix in ONE lindley_scan launch; its
    queues and departures must equal bit for bit those of ``pass_calls``,
    the per-pass calls (one launch each) of ``sweep_execute`` on the same
    matrix in the db_bench phase.  Returns the report and the matrix's
    batch (service, arrivals, offsets) on the card, held within
    LINDLEY_TOL_S of the plain version."""
    from repro_torch import kernels
    from repro_torch.bench_kv import db_bench
    from repro_torch.core import fleet, policies
    points, _ = db_bench.fleet_points(policies.names(), FLEET_OPS, FLEET_POP)
    with RecordLindley() as rec:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fleet.fleet_sweep(points, compute_device="cuda")
        torch.cuda.synchronize()
        t_matrix = time.perf_counter() - t0
        launches = kernels.launch_counts()
    if launches["lindley_scan"] != 1 or len(rec.calls) != 1:
        fail(f"fleet_sweep: {launches['lindley_scan']} lindley_scan launches "
             f"in {len(rec.calls)} calls for the matrix, not 1")
    _, services, arrivals, deps = rec.calls[0]
    queues = [q for c in pass_calls for q in zip(*c)]
    if len(queues) != len(services):
        fail(f"fleet_sweep: {len(services)} rows, the passes scanned "
             f"{len(queues)}")
    bits = np.int64
    for i, (s, a, d) in enumerate(queues):
        if not (np.array_equal(s.view(bits), services[i].view(bits))
                and np.array_equal(a.view(bits), arrivals[i].view(bits))):
            fail(f"fleet_sweep: queue {i} differs from its pass's")
        if not np.array_equal(d.view(bits), deps[i].view(bits)):
            fail(f"fleet_sweep: departures of row {i} are not bit-equal "
                 "to its pass's")
    lens = np.array([q.shape[0] for q in services], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    s = torch.from_numpy(np.concatenate(services)).to("cuda")
    a = torch.from_numpy(np.concatenate(arrivals)).to("cuda")
    del rec, queues
    err = check_lindley(torch, "over the fleet matrix", s, a, offsets)
    report = {"points": len(points), "rates": len(points[0].grid),
              "rows": int(lens.size), "ops": int(offsets[-1]),
              "empty_rows": int((lens == 0).sum()),
              "lindley_launches": launches["lindley_scan"],
              "per_pass_calls": len(pass_calls),
              "launches": launches, "bit_equal_to_passes": True,
              "max_abs_err": err, "fleet_sweep_wall_s": t_matrix,
              "device_bytes": 3 * 8 * int(offsets[-1])}
    return report, (s, a, offsets)


def time_lindley_matrix(torch, batch) -> dict:
    """lindley_scan over the fleet matrix's batch, beside its plain version."""
    from repro_torch.kernels.lindley_scan.ops import (lindley_batch,
                                                      lindley_batch_plain)
    s, a, offsets = batch
    n, rows = int(s.shape[0]), len(offsets) - 1
    return {
        "shape": f"{rows} rows, {n} ops (the fleet matrix)",
        "bound_ms": bound_ms(24 * n + 8 * (2 * rows + 1)),
        **time_all(torch, lambda: lindley_batch(s, a, offsets),
                   lambda: lindley_batch_plain(s, a, offsets), None, 8)}


def workers_rows(torch) -> dict:
    """db_bench's fleet_sweep at its quick size with 1 and with 2 spawned
    workers on the card: the rows must be identical but for the volatile
    keys and the rows' worker counts."""
    from repro_torch.bench_kv import db_bench
    got, walls = {}, {}
    for w in (1, 2):
        t0 = time.perf_counter()
        got[w] = db_bench.main(["--quick", "--bench", "fleet_sweep",
                                "--workers", str(w)])
        walls[w] = time.perf_counter() - t0
    def rows(w):
        return [{k: v for k, v in r.items() if k != "workers"}
                for r in strip_volatile(got[w])]
    if rows(1) != rows(2):
        fail("fleet_sweep: rows of 1 and 2 workers differ")
    return {"rows": len(got[1]), "identical": True,
            "wall_s": {f"workers_{w}": t for w, t in walls.items()}}


# ------------------------------------------------- open-loop serving (3d)
class ServeClock:
    """Wall seconds spent in ``materialize`` and in the admission pre-pass
    (``admit``) under ``repro_torch.serving.traffic``, by wrapping the two
    names in that module; the package is left as it is.

    ``memo`` (a dict the caller keeps) holds each stream ``materialize``
    made, under its spec without the admission config (which it does not
    read) and its load factor, and every call gets a copy of it (timed
    apart, ``copy_s``), so that phase 3d makes each of its two streams once
    for both policies and both arms."""

    def __init__(self, memo: dict):
        self.memo = memo

    def __enter__(self):
        import dataclasses

        import numpy as np
        from repro_torch.serving import traffic
        self.s = {"materialize": 0.0, "admit": 0.0, "copy_s": 0.0}
        self.hits = 0
        self._orig = {k: getattr(traffic, k) for k in ("materialize",
                                                        "admit")}
        make, admit = self._orig["materialize"], self._orig["admit"]

        def materialize(spec, load_factor=1.0):
            t0 = time.perf_counter()
            key = (dataclasses.replace(spec, admission=None), load_factor)
            if key not in self.memo:
                self.memo[key] = make(spec, load_factor)
                self.s["materialize"] += time.perf_counter() - t0
                t0 = time.perf_counter()
            else:
                self.hits += 1
            st = self.memo[key]
            out = dataclasses.replace(st, **{
                f.name: getattr(st, f.name).copy()
                for f in dataclasses.fields(st)
                if isinstance(getattr(st, f.name), np.ndarray)})
            self.s["copy_s"] += time.perf_counter() - t0
            return out

        def admitted(*a, **kw):
            t0 = time.perf_counter()
            out = admit(*a, **kw)
            self.s["admit"] += time.perf_counter() - t0
            return out
        traffic.materialize, traffic.admit = materialize, admitted
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import traffic
        for k, fn in self._orig.items():
            setattr(traffic, k, fn)


def serve_summary(np, sr) -> dict:
    """One open-loop run's result, checked: every tenant's offered ops got
    exactly one verdict, the priority-0 tenant was never shed, every
    admitted op has a finite, non-negative latency."""
    lat = sr.res.latency
    if lat.shape[0] != int((sr.verdicts == 0).sum()) \
            or not np.all(np.isfinite(lat)) or np.any(lat < 0):
        fail("serve: admitted latencies must be finite and non-negative, "
             "one per admitted op")
    for led in sr.tenants:
        if led.ops_offered != led.ops_admitted + led.ops_shed \
                + led.ops_throttled:
            fail(f"serve: tenant {led.name} does not conserve its offered "
                 f"ops: {led}")
        if led.priority == 0 and led.ops_shed:
            fail(f"serve: the priority-0 tenant {led.name} was shed "
                 f"{led.ops_shed} times")
    prio = [i for i, led in enumerate(sr.tenants) if led.priority == 0]
    out = {"offered_ops": sr.offered_ops,
           "offered_ops_s": sr.offered_ops_s,
           "goodput_ops_s": sr.goodput_ops_s, "shed_frac": sr.shed_frac,
           "throttled_frac": sr.throttled_frac,
           "slo_violation_frac": sr.slo_violation_frac,
           "run_stalls": sum(1 for i, _ in sr.res.stall_events
                             if i >= sr.stream.n_load)}
    for i in prio:
        p = sr.tenant_latency(i)
        out[f"{sr.tenants[i].name}_p99_ms"] = float(np.percentile(p, 99)) * 1e3
        out[f"{sr.tenants[i].name}_p999_ms"] = \
            float(np.percentile(p, 99.9)) * 1e3
    return out


def check_same_run(np, what: str, got, want) -> float:
    """Two engines' results on one op stream: per-op reads and probed
    counts and the stall events identical, latency within LINDLEY_TOL_S;
    returns the latency gap."""
    if not (np.array_equal(got.get_reads, want.get_reads)
            and np.array_equal(got.get_probed, want.get_probed)):
        fail(f"{what}: per-op reads/probed differ")
    if got.stall_events != want.stall_events:
        fail(f"{what}: stall events differ ({got.n_stalls} vs "
             f"{want.n_stalls})")
    gap = float(np.max(np.abs(got.latency - want.latency))) \
        if got.latency.size else 0.0
    if not gap <= LINDLEY_TOL_S:
        fail(f"{what}: latency gap {gap} s > {LINDLEY_TOL_S}")
    return gap


def serve_open(torch, np, policy: str, memo: dict) -> dict:
    """Phase 3d for one policy: db_bench's pinned three-tenant spec
    (``make_serve_spec``) over 2 hash shards at the paper's byte scale,
    at load factors SERVE_OPEN_FACTORS.  Admission off: ``serve_grid``
    (one structural replay, one temporal pass and one lindley_scan launch
    a factor), its factor-1.0 run against a serial ``Simulator.run`` on
    the same materialized stream.  Admission on: ``Simulator.serve`` under
    ``REPRO_SANITIZE=1`` (the sanitizer must have checked every event and
    job and raised nothing) at each factor, the last of which must shed,
    and at SERVE_FLEET_FACTORS a ``FleetEngine`` on the same spec:
    verdicts, ledgers and stall events identical, latency within
    LINDLEY_TOL_S.  Launch counts are zeroed at the start and read at the
    end: merge_path, overlap_scan and lindley_scan must each have
    launched.  ``memo`` is ``ServeClock``'s."""
    from repro_torch import kernels
    from repro_torch.bench_kv.db_bench import make_serve_spec
    from repro_torch.core import (DeviceModel, FleetEngine, Simulator,
                                  UidNamespace, get_policy)
    from repro_torch.serving import serve_grid
    cfg = get_policy(policy).default_config(scale=64 << 20).with_(
        n_shards=2)
    dev = DeviceModel.scaled(1.0)
    spec_off, spec_on = (make_serve_spec(duration_s=SERVE_DURATION_S,
                                         population=SERVE_POPULATION,
                                         admission=adm)
                         for adm in (False, True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_phase = time.perf_counter()
    report: dict = {"policy": policy, "factors": list(SERVE_OPEN_FACTORS)}

    with ServeClock(memo) as clock:
        t0 = time.perf_counter()
        grid = serve_grid(cfg, dev, spec_off, SERVE_OPEN_FACTORS,
                          compute_device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if launches["lindley_scan"] != len(SERVE_OPEN_FACTORS):
        fail(f"serve {policy}: the grid launched lindley_scan "
             f"{launches['lindley_scan']} times for "
             f"{len(SERVE_OPEN_FACTORS)} factors")
    report["off"] = {
        "wall_s": wall, "materialize_s": clock.s["materialize"],
        "memo_hits": clock.hits, "copy_s": clock.s["copy_s"],
        "engine_s": wall - clock.s["materialize"] - clock.s["copy_s"],
        "timing": [sr.timing for sr in grid],
        "ops": int(grid[0].stream.op_types.shape[0]),
        "n_load": grid[0].stream.n_load, "launches": launches,
        **{f"x{f}": serve_summary(np, sr)
           for f, sr in zip(SERVE_OPEN_FACTORS, grid)}}
    stream = grid[0].stream
    t0 = time.perf_counter()
    serial = Simulator(cfg, dev, uids=UidNamespace(),
                       compute_device="cuda").run(
        stream.op_types, stream.keys, stream.arrivals, stream.scan_lens)
    torch.cuda.synchronize()
    report["off"]["serial_run_s"] = time.perf_counter() - t0
    report["off"]["closed_open_gap_s"] = check_same_run(
        np, f"serve {policy}: grid at x{SERVE_OPEN_FACTORS[0]} vs serial "
        "run", grid[0].res, serial)
    del grid, serial, stream

    saved = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        report["on"] = {}
        for f in SERVE_OPEN_FACTORS:
            with ServeClock(memo) as clock:
                t0 = time.perf_counter()
                sim = Simulator(cfg, dev, uids=UidNamespace(),
                                compute_device="cuda")
                sr = sim.serve(spec_on, load_factor=f)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            san = sim.sanitizer
            if san is None or san.events_checked == 0 \
                    or san.jobs_checked != len(sr.res.job_log):
                fail(f"serve {policy}: the sanitizer did not check the run")
            if f == SERVE_OPEN_FACTORS[-1] and not sr.shed_frac:
                fail(f"serve {policy}: nothing shed at x{f}, past the knee")
            on = report["on"][f"x{f}"] = {
                "wall_s": wall, "materialize_s": clock.s["materialize"],
                "memo_hits": clock.hits, "copy_s": clock.s["copy_s"],
                "admit_s": clock.s["admit"],
                "engine_s": wall - clock.s["materialize"] - clock.s["copy_s"]
                - clock.s["admit"],
                "sanitizer_events": san.events_checked,
                "sanitizer_jobs": san.jobs_checked,
                **serve_summary(np, sr)}
            if f in SERVE_FLEET_FACTORS:
                t0 = time.perf_counter()
                eng = FleetEngine(cfg, dev, uids=UidNamespace(),
                                  compute_device="cuda")
                fsr = eng.serve(spec_on, load_factor=f)
                torch.cuda.synchronize()
                if not np.array_equal(fsr.verdicts, sr.verdicts):
                    fail(f"serve {policy}: fleet and serial verdicts differ "
                         f"at x{f}")
                if [vars(t) for t in fsr.tenants] != \
                        [vars(t) for t in sr.tenants]:
                    fail(f"serve {policy}: fleet and serial ledgers differ "
                         f"at x{f}")
                on["fleet_serve_s"] = time.perf_counter() - t0
                on["fleet_serial_gap_s"] = check_same_run(
                    np, f"serve {policy}: fleet vs serial at x{f}",
                    fsr.res, sr.res)
                on["fleet_sanitizer_events"] = eng.sanitizer.events_checked
                del eng, fsr
            del sim, sr
    finally:
        if saved is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = saved
    report["launches"] = kernels.launch_counts()
    report["wall_s"] = time.perf_counter() - t_phase
    report["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    if min(report["launches"][k] for k in STORE_KERNELS) <= 0:
        fail(f"serve {policy}: a store kernel never launched: "
             f"{report['launches']}")
    return report


# ----------------------------------------------------- ShardedStore (3e)
def shard_batches(np) -> list:
    """Phase 3e's op stream as (kinds, keys, scan_lens) batches: the
    unique uniform keys of ``load_keys(SHARD_LOAD)`` as PUTs, then
    SHARD_OPS mixed ops — 45% GET, 45% PUT, 5% DELETE, 5% SCAN of 1-100
    keys, each key drawn from the loaded ones — SHARD_BATCH ops a batch."""
    from repro_torch.bench_kv.workloads import load_keys
    from repro_torch.core import OpKind
    r = np.random.default_rng(7)
    pop = np.unique(load_keys(SHARD_LOAD, seed=7))
    batches = [(np.full(k.shape[0], OpKind.PUT, np.uint8), k,
                np.zeros(k.shape[0], np.int32))
               for k in np.array_split(pop, -(-pop.shape[0] // SHARD_BATCH))]
    kinds = r.choice(np.array([OpKind.GET, OpKind.PUT, OpKind.DELETE,
                               OpKind.SCAN], np.uint8), SHARD_OPS,
                     p=[0.45, 0.45, 0.05, 0.05])
    keys = r.choice(pop, SHARD_OPS)
    lens = np.where(kinds == OpKind.SCAN,
                    r.integers(1, 101, SHARD_OPS), 0).astype(np.int32)
    for lo in range(0, SHARD_OPS, SHARD_BATCH):
        sl = slice(lo, lo + SHARD_BATCH)
        batches.append((kinds[sl], keys[sl], lens[sl]))
    return batches


def drive_store(cfg, batches: list, compute_device: str):
    """A ``ShardedStore`` fed every batch, sealed between batches as a
    harness seals it; returns the store, its results and every background
    job it drained (its own memtable rolls' and the seals')."""
    from repro_torch.core import RequestBatch, ShardedStore
    store = ShardedStore(cfg, compute_device=compute_device)
    results, sealed = [], []
    for kinds, keys, lens in batches:
        results.append(store.apply_batch(RequestBatch(kinds, keys,
                                                      scan_lens=lens)))
        sealed.extend(store.seal_full_memtables())
    sealed.extend(store.drain_jobs())
    return store, results, store.job_log + sealed


def drive_tree(cfg, batches: list):
    """A bare ``LSMTree`` on the card fed the same batches with the store's
    cadence: writes chunked at the memtable's room (a full memtable rolls
    through flush and the background triggers), then the batch's reads,
    then the seal of a full memtable; returns the tree and the reads'
    results scattered to their batch positions."""
    from repro_torch.core import LSMTree, OpKind, RequestBatch

    def roll():
        tree.seal_memtable()
        while tree.immutables:
            tree.flush_immutable()
        tree.background_triggers()
        tree.drain_jobs()
    tree = LSMTree(cfg, compute_device="cuda")
    out = []
    for kinds, keys, lens in batches:
        w = (kinds == OpKind.PUT) | (kinds == OpKind.DELETE)
        wk, wt = keys[w], kinds[w] == OpKind.DELETE
        i = 0
        while i < wk.shape[0]:
            if tree.memtable.room == 0:
                roll()
            take = min(tree.memtable.room, wk.shape[0] - i)
            tree._write_batch(wk[i:i + take], wt[i:i + take])
            i += take
            if tree.memtable.full:
                roll()
        out.append((~w, tree.apply_batch(RequestBatch(
            kinds[~w], keys[~w], scan_lens=lens[~w]))))
        if tree.memtable.full:
            roll()
    return tree, out


def tree_levels(tree) -> list:
    """A tree's SSTs, level by level: uid, keys and seqnos as bytes."""
    return [[(sst.uid, sst.keys.cpu().numpy().tobytes(),
              sst.seqs.cpu().numpy().tobytes()) for sst in lvl]
            for lvl in tree.levels]


def tree_state(tree) -> dict:
    """A tree's SSTs, its Stats counters and its chain ledger."""
    import dataclasses
    st = tree.stats
    return {"levels": tree_levels(tree),
            "stats": {f.name: getattr(st, f.name)
                      for f in dataclasses.fields(st)
                      if f.name not in ("chains", "chain_index")},
            "chains": [dataclasses.asdict(c) for c in st.chains]}


def store_state(store, jobs: list) -> dict:
    """Everything a ``ShardedStore`` holds that two runs must agree on:
    each shard's ``tree_state`` and the store's drained jobs."""
    return {"jobs": [(j.kind, j.level, j.uid, j.shard, j.n_in_ssts)
                     for j in jobs],
            "shards": [tree_state(tree) for tree in store.shards]}


RESULT_FIELDS = ("kinds", "seqs", "reads", "probed", "scan_offsets",
                 "scan_keys", "scan_seqs")


def shard_run(np, compute_device: str, n_shards: int) -> tuple:
    """Phase 3e's store of ``n_shards`` hash shards (vlsm, 64 MiB scale)
    on ``compute_device``, from rewound uid counters, as plain data: its
    wall seconds, every batch's results as RESULT_FIELDS arrays,
    ``merged_view`` and ``store_state``; and the store itself."""
    from repro_torch.core import get_policy
    from repro_torch.core.uids import reset_uid_counters
    cfg = get_policy("vlsm").default_config(scale=64 << 20).with_(
        n_shards=n_shards)
    batches = shard_batches(np)
    reset_uid_counters()
    t0 = time.perf_counter()
    store, results, jobs = drive_store(cfg, batches, compute_device)
    return {"wall_s": time.perf_counter() - t0,
            "results": [{f: getattr(r, f) for f in RESULT_FIELDS}
                        for r in results],
            "merged_view": store.merged_view(),
            "state": store_state(store, jobs)}, store


def cpu_worker_init() -> None:
    """The CPU worker's two threads, beside the host-bound phases."""
    import torch
    torch.set_num_threads(2)


def cpu_runs() -> dict:
    """The CPU tier's runs that phases 6 and 3e hold the card against,
    computed in a spawned worker: the store path of CROSS_POLICIES (per-op
    reads, probed counts, latencies, stall count, wall seconds) and phase
    3e's stores of SHARD_COUNT shards and of one (``shard_run``)."""
    import numpy as np
    import torch
    trace = ycsb_trace(np, N_LOAD, N_RUN)
    out: dict = {}
    for policy in CROSS_POLICIES:
        _, res, wall = run_main_path(torch, np, policy, trace, "cpu")
        out[policy] = (res.get_reads, res.get_probed, res.latency,
                       res.n_stalls, wall)
    del trace, res
    out["shard_store"] = {n: shard_run(np, "cpu", n)[0]
                          for n in (SHARD_COUNT, 1)}
    return out


def shard_card_runs(torch, np) -> dict:
    """Phase 3e's card side: the stores of SHARD_COUNT shards and of one
    on the card (``shard_run``), each with its launches, and the one-shard
    store against a bare ``LSMTree`` on the card fed the same batches:
    per-op seqs, reads, probed and SCAN keys and seqnos, SSTs, Stats,
    chains and ``merged_view`` identical."""
    from repro_torch import kernels
    from repro_torch.core import get_policy
    from repro_torch.core.uids import reset_uid_counters
    out: dict = {}
    for n in (SHARD_COUNT, 1):
        kernels.reset_launch_counts()
        out[n], store = shard_run(np, "cuda", n)
        torch.cuda.synchronize()
        out[n]["launches"] = kernels.launch_counts()
        store.check_invariants()
    batches = shard_batches(np)
    reset_uid_counters()
    t0 = time.perf_counter()
    tree, t_res = drive_tree(get_policy("vlsm").default_config(
        scale=64 << 20), batches)
    torch.cuda.synchronize()
    out["tree_s"] = time.perf_counter() - t0
    for i, (sr, (reads, tr)) in enumerate(zip(out[1]["results"], t_res,
                                              strict=True)):
        for f in ("seqs", "reads", "probed"):
            if not np.array_equal(sr[f][reads], getattr(tr, f)):
                fail(f"ShardedStore x1: batch {i}'s {f} differ from the "
                     "bare tree's")
        if not (np.array_equal(sr["scan_keys"], tr.scan_keys)
                and np.array_equal(sr["scan_seqs"], tr.scan_seqs)):
            fail(f"ShardedStore x1: batch {i}'s scans differ from the "
                 "bare tree's")
    if out[1]["state"]["shards"][0] != tree_state(tree) \
            or out[1]["merged_view"] != tree.merged_view():
        fail("ShardedStore x1: SSTs, Stats, chains or merged_view differ "
             "from the bare tree's")
    return out


def shard_store_check(np, card: dict, want: dict) -> dict:
    """Phase 3e: each of ``shard_card_runs``'s stores against the same
    store built on the CPU (``want``, by shard count, from ``cpu_runs``):
    every batch's per-op seqs, reads, probed and SCAN keys and seqnos,
    ``merged_view``, every shard's SSTs, Stats and chain ledger and the
    drained jobs identical."""
    report: dict = {"load_keys": int(sum(
        r["kinds"].shape[0] for r in card[1]["results"]) - SHARD_OPS),
                    "ops": SHARD_OPS, "tree_s": card["tree_s"]}
    for n in (SHARD_COUNT, 1):
        got, cpu = card[n], want[n]
        for i, (g, w) in enumerate(zip(got["results"], cpu["results"],
                                       strict=True)):
            for f in RESULT_FIELDS:
                if not np.array_equal(g[f], w[f]):
                    fail(f"ShardedStore x{n}: batch {i}'s {f} differ card "
                         "vs cpu")
        if got["merged_view"] != cpu["merged_view"]:
            fail(f"ShardedStore x{n}: merged_view differs card vs cpu")
        if got["state"] != cpu["state"]:
            fail(f"ShardedStore x{n}: SSTs, Stats or jobs differ card vs "
                 "cpu")
        jobs = got["state"]["jobs"]
        report[f"x{n}"] = {
            "card_s": got["wall_s"], "cpu_s": cpu["wall_s"],
            "launches": got["launches"], "batches": len(got["results"]),
            "live_keys": len(got["merged_view"]),
            "scan_keys": int(sum(r["scan_keys"].shape[0]
                                 for r in got["results"])),
            "device_reads": int(sum(r["reads"].sum()
                                    for r in got["results"])),
            "flushes": sum(1 for j in jobs if j[0] == "flush"),
            "compactions": sum(1 for j in jobs if j[0] == "compact")}
    report["identical"] = True
    return report

# ------------------------------------------------------ LM kernels: edges
def _randn(torch, gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def check_close(what: str, kernel: str, got, want, tol=None) -> float:
    """Fails unless dtype and shape match, got is finite and every element
    is within ``tol`` (default TOL[kernel, dtype]) of want; returns the
    largest |got - want|."""
    atol, rtol = tol or TOL[kernel, str(want.dtype).split(".")[1]]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if w.numel() else 0.0
    if not (got.dtype == want.dtype and got.shape == want.shape
            and bool(g.isfinite().all())
            and bool(((g - w).abs() <= atol + rtol * w.abs()).all())):
        fail(f"{what}: max |err| {err} (atol {atol}, rtol {rtol}, max|want| "
             f"{float(w.abs().max()) if w.numel() else 0.0})")
    return err


def check_paged_lse(torch, what: str, got, card_args, clean_args,
                    window=None) -> float:
    """paged_attention with ``return_lse`` on ``card_args``: its output
    bitwise ``got`` (the call without it), every row with length 0 at lse
    exactly -1e30, and lse within the fp32 TOL of the plain version's on
    ``clean_args``.  Returns the largest |lse err|."""
    from repro_torch.kernels.paged_attention.ops import (
        NEG_INF, paged_attention, paged_attention_plain)
    out, lse = paged_attention(*card_args, window=window, return_lse=True)
    if not torch.equal(out, got):
        fail(f"{what}: return_lse changed the output")
    if not bool((lse[card_args[4] <= 0] == NEG_INF).all()):
        fail(f"{what}: an empty row's lse is not -1e30")
    _, want = paged_attention_plain(*clean_args, window=window,
                                    return_lse=True)
    return check_close(f"{what}, lse", "paged_attention", lse, want)


def edge_flash(torch) -> float:
    """flash_attention against its plain version: S 1, 63, 64, 65, 127,
    128, 130, 384; head_dim 64 and 128; GQA rep 1 and 2; window None and
    128; fp32 and bf16; plus two non-causal cases and two at S 4,096 (a
    128-token window at D 64, GQA rep 2 at D 128).  Then, in bf16, B 8 grids
    of 512 to 1,024 blocks: ragged S 777 and 1,000, windows, GQA and a
    non-causal case.  Then head_dim 256 (gemma3: 4 query heads over 1 kv
    head) in fp32 and bf16: the same S with window None and 16, a
    non-causal case, windows 1, 16 and 512 at S 1,000 and 4,096 and global
    at 4,096.  Returns the largest |err|."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    worst = 0.0
    cases = [(s, d, rep, win, dt, True)
             for s in (1, 63, 64, 65, 127, 128, 130, 384) for d in (64, 128)
             for rep in (1, 2) for win in (None, 128)
             for dt in ("float32", "bfloat16")]
    cases += [(130, 64, 2, None, "float32", False),
              (384, 128, 1, 128, "bfloat16", False),
              (LONG_PREFILL, 64, 1, 128, "bfloat16", True),
              (LONG_PREFILL, 128, 2, None, "bfloat16", True)]
    cases = [(2, 2 * rep, 2, s, d, win, dt, causal)
             for s, d, rep, win, dt, causal in cases]
    cases += [(8, hq, hkv, s, d, win, "bfloat16", causal)
              for hq, hkv, s, d, win, causal in (
                  (16, 8, 1000, 128, None, True), (16, 8, 1000, 128, 128, True),
                  (8, 8, 777, 64, 128, True), (8, 8, 1000, 64, None, False))]
    for dt in ("float32", "bfloat16"):
        cases += [(2, 4, 1, s, 256, win, dt, True)
                  for s in (1, 63, 64, 65, 127, 128, 130, 384)
                  for win in (None, 16)]
        cases += [(2, 4, 1, 130, 256, None, dt, False)]
        cases += [(1, 4, 1, s, 256, win, dt, True)
                  for s in (1000, LONG_PREFILL) for win in GEMMA_WINDOWS]
        cases += [(1, 4, 1, LONG_PREFILL, 256, None, dt, True)]
    for b, hq, hkv, s, d, win, dt, causal in cases:
        dtype = getattr(torch, dt)
        rep = hq // hkv
        q = _randn(torch, gen, (b, hq, s, d), dtype)
        k = _randn(torch, gen, (b, hkv, s, d), dtype)
        v = _randn(torch, gen, (b, hkv, s, d), dtype)
        got = flash_attention(q, k, v, causal=causal, window=win)
        want = flash_attention_plain(q, k, v, causal=causal, window=win)
        worst = max(worst, check_close(
            f"flash_attention edge case B={b} S={s} D={d} rep={rep} "
            f"window={win} {dt} causal={causal}", "flash_attention", got,
            want))
    return worst


def edge_flash_cross(torch) -> float:
    """flash_attention, non-causal with Sk keys for Sq queries (whisper's
    cross attention and bidirectional encoder), against its plain version:
    Sq 1, 63, 64, 65 and 189 against Sk 1, 65 and 1,500, at whisper's
    head_dim 64 (and 128 and 256 at Sq 65 over Sk 1,500), GQA rep 1 and 2,
    fp32 and bf16; every call also writes the rows' log-sum-exp, held
    against the plain version's under TOL's fp32 entry.  Returns the
    largest |err|."""
    from repro_torch.kernels.flash_attention.ops import (
        _forward, flash_attention, flash_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    worst = 0.0
    cases = [(sq, sk, 64, rep) for sq in CROSS_SQ for sk in CROSS_SK
             for rep in (1, 2)]
    cases += [(65, WHISPER_FRAMES, d, 2) for d in (128, 256)]
    for sq, sk, d, rep in cases:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            q = _randn(torch, gen, (2, 2 * rep, sq, d), dtype)
            k = _randn(torch, gen, (2, 2, sk, d), dtype)
            v = _randn(torch, gen, (2, 2, sk, d), dtype)
            what = f"flash_attention Sq={sq} Sk={sk} D={d} rep={rep} {dt}"
            got, lse = _forward(q, k, v, False, None, None, want_lse=True)
            want, want_lse = flash_attention_plain(q, k, v, causal=False,
                                                   return_lse=True)
            worst = max(worst, check_close(what, "flash_attention", got,
                                           want))
            check_close(what + " lse", "flash_attention", lse, want_lse,
                        TOL["flash_attention", "float32"])
            check_close(what + " (no lse)", "flash_attention",
                        flash_attention(q, k, v, causal=False), want)
    return worst


def bwd_cases() -> list:
    """(b, hq, hkv, sq, sk, d, causal, window, dtype) of flash_attention's
    backward edge cases: every S of BWD_S at head_dim 64, 128 and 256,
    causal and with windows 1, 16 and 512, fp32 and bf16, GQA rep cycling
    through 1, 2, 4 and 8; then non-causal Sq != Sk (whisper's cross
    attention) the same way; then BWD_WHISPER at whisper-tiny's training
    batch and heads, fp32 and bf16; then gemma3-1b's long shapes
    (BWD_GEMMA at LONG_PREFILL tokens, its window and global), fp32 and
    bf16."""
    cases, i = [], 0
    for d in (64, 128, 256):
        for dt in ("float32", "bfloat16"):
            for s in BWD_S:
                for win in (None,) + GEMMA_WINDOWS:
                    rep = (1, 2, 4, 8)[i % 4]
                    i += 1
                    cases.append((2, 2 * rep, 2, s, s, d, True, win, dt))
            for sq, sk in BWD_CROSS:
                rep = (1, 2, 4, 8)[i % 4]
                i += 1
                cases.append((2, 2 * rep, 2, sq, sk, d, False, None, dt))
    b = WHISPER_TRAIN["batch"]
    cases += [(b, 6, 6, sq, sk, 64, causal, None, dt)
              for sq, sk, causal in BWD_WHISPER
              for dt in ("float32", "bfloat16")]
    gb, ghq, ghkv, gd = BWD_GEMMA
    cases += [(gb, ghq, ghkv, LONG_PREFILL, LONG_PREFILL, gd, True, win, dt)
              for win in (GEMMA_WINDOW, None)
              for dt in ("float32", "bfloat16")]
    return cases


# the kernels of flash_attention_bwd's bf16 route at head_dim 256 (and
# bwd_dkdv_sum where dK and dV's blocks are split over the query heads):
# the CUDA-core bwd_dq<__nv_bfloat16, 256> and bwd_dkdv<...> it replaced
# must never run there
BWD_D256_KERNELS = {"bwd_dq_wgmma<256>", "bwd_dkdv_wgmma2<256>"}
BWD_HEAD_SUM = "bwd_dkdv_sum"


def bwd_kernel_names(torch, fn) -> set:
    """The ``bwd_*`` names (with their template arguments) of the kernels
    one call of ``fn`` runs (torch.profiler, device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {m.group(0) for n, _, _ in kernel_times_us(prof)
            for m in [re.search(r"bwd_\w+(<[^>]*>)?", n)] if m}


def edge_flash_bwd(torch) -> float:
    """flash_attention's backward kernel (dQ, dK, dV) against
    ``flash_attention_bwd_plain`` on the same q, k, v, output, log-sum-exp
    (the forward kernel's) and dO, over ``bwd_cases()``, within TOL's
    ``flash_attention_bwd`` entries; every case is launched twice and the
    two results must be bitwise equal (the kernel sums in a fixed order).
    gemma3's bf16 cases are also profiled: their kernels must be
    BWD_D256_KERNELS, the tensor-core route, and BWD_HEAD_SUM (its one kv
    head splits dK and dV's blocks over the query heads).  Returns the
    largest |err|."""
    from repro_torch.kernels.flash_attention.ops import (
        _forward, flash_attention_bwd, flash_attention_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    worst = 0.0
    for b, hq, hkv, sq, sk, d, causal, win, dt in bwd_cases():
        dtype = getattr(torch, dt)
        q = _randn(torch, gen, (b, hq, sq, d), dtype)
        k = _randn(torch, gen, (b, hkv, sk, d), dtype)
        v = _randn(torch, gen, (b, hkv, sk, d), dtype)
        do = _randn(torch, gen, (b, hq, sq, d), dtype)
        o, lse = _forward(q, k, v, causal, win, None, want_lse=True)
        args = (q, k, v, o, lse, do)
        got = flash_attention_bwd(*args, causal=causal, window=win)
        again = flash_attention_bwd(*args, causal=causal, window=win)
        want = flash_attention_bwd_plain(*args, causal=causal, window=win)
        what = (f"flash_attention_bwd B={b} H={hq}/{hkv} Sq={sq} Sk={sk} "
                f"D={d} causal={causal} window={win} {dt}")
        if (b, hq, hkv, d) == BWD_GEMMA and dt == "bfloat16":
            names = bwd_kernel_names(torch, lambda: flash_attention_bwd(
                *args, causal=causal, window=win))
            if names != BWD_D256_KERNELS | {BWD_HEAD_SUM}:
                fail(f"{what}: ran {sorted(names)}, not "
                     f"{sorted(BWD_D256_KERNELS | {BWD_HEAD_SUM})}")
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(g, a):
                fail(f"{what}: {name} differs between two calls")
            worst = max(worst, check_close(f"{what} {name}",
                                           "flash_attention_bwd", g, w))
    return worst


def edge_paged_cross(torch) -> float:
    """paged_attention over whisper's cross cache: 1,500 live rows of
    1,504 (B 2, 6 heads of 64, the identity page table of 47 pages of 32),
    fp32 and bf16, with NaN in the 4 pad rows of the card's input (the
    kernel must not read them) and zeros there in the plain version's.
    Returns the largest |err|."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    b, h, d, ps = 2, 6, 64, 32
    rows = -(-WHISPER_FRAMES // ps) * ps
    table = torch.arange(b * rows // ps, dtype=torch.int32,
                         device="cuda").reshape(b, -1)
    lengths = torch.full((b,), WHISPER_FRAMES, dtype=torch.int32,
                         device="cuda")
    worst = 0.0
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        q = _randn(torch, gen, (b, h, d), dtype)
        kv = [_randn(torch, gen, (b, rows, h, d), dtype) for _ in range(2)]
        for t in kv:
            t[:, WHISPER_FRAMES:] = 0
        clean = [t.view(b * rows // ps, ps, h, d) for t in kv]
        want = paged_attention_plain(q, *clean, table, lengths)
        poisoned = [t.clone() for t in kv]
        for t in poisoned:
            t[:, WHISPER_FRAMES:] = float("nan")
        got = paged_attention(q, *(t.view(b * rows // ps, ps, h, d)
                                   for t in poisoned), table, lengths)
        worst = max(worst, check_close(
            f"paged_attention over the cross cache ({WHISPER_FRAMES} of "
            f"{rows} rows, NaN pads) {dt}", "paged_attention", got, want))
    return worst


def ssd_inputs(torch, gen, b, L, h, g, n, p, dtype, strided=False,
               dt_range=(-4, 1)):
    """x, dt, a, B, C for ssd_scan (seeded); strided: x, B and C are views
    of one [b, L, h*p + 2*g*n] buffer, as ``models/ssd.py`` cuts ``xbc``;
    dt log-uniform over 10**dt_range."""
    di = h * p
    if strided:
        xbc = torch.randn((b, L, di + 2 * g * n), generator=gen,
                          device="cuda")
        xbc[..., di:] *= 0.3
        xbc = xbc.to(dtype)
        x = xbc[..., :di].reshape(b, L, h, p)
    else:
        x = _randn(torch, gen, (b, L, h, p), dtype)
    lo, hi = dt_range
    dt = (10.0 ** (torch.rand((b, L, h), generator=gen, device="cuda")
                   * (hi - lo) + lo)).to(dtype)
    a = -(torch.rand(h, generator=gen, device="cuda") + 0.1)
    if strided:
        bm = xbc[..., di:di + g * n].reshape(b, L, g, n)
        cm = xbc[..., di + g * n:].reshape(b, L, g, n)
    else:
        bm = _randn(torch, gen, (b, L, g, n), dtype, 0.3)
        cm = _randn(torch, gen, (b, L, g, n), dtype, 0.3)
    return x, dt, a, bm, cm


def edge_ssd(torch) -> float:
    """ssd_scan against its plain version, y and final state: L 1, 100,
    128, 300; H 4 over G 1 and 2; (N, P) (64, 64), (128, 64), (16, 32) and
    (64, 48); fp32 and bf16; dt log-uniform from 1e-4 to 10.  Then the
    chunk edges and the serving length, L 63, 64, 65 and 189, with (N, P)
    (64, 64) and (16, 32), contiguous and as strided views of one xbc
    buffer; and L 4,096 strided, at B 2 x H 4 and at zamba2-1.2b's B 1 x
    H 64 (bf16, dt in the softplus range).  All at B 2 unless said; every
    other case, and zamba2's both ways, with an fp32 ``state_dt`` (the
    final state's run).  Then bf16 x, B and C with fp32 dt, as the model
    passes them (strided views of xbc; the reference's default route), at
    L 65 and 189 (B 2 x H 4) and at zamba2's heads at 4,096, each with
    ``state_dt`` omitted and given as that same dt.  Returns the largest
    |err| of y."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    worst = 0.0
    cases = [(2, L, 4, g, n, p, dt, False)
             for L in (1, 100, 128, 300) for g in (1, 2)
             for n, p in ((64, 64), (128, 64), (16, 32), (64, 48))
             for dt in ("float32", "bfloat16")]
    cases += [(2, L, 4, g, n, p, dt, strided)
              for L in (63, 64, 65, 189) for g in (1, 2)
              for n, p in ((64, 64), (16, 32))
              for dt in ("float32", "bfloat16") for strided in (False, True)]
    cases += [(2, LONG_PREFILL, 4, 1, 64, 64, dt, True)
              for dt in ("float32", "bfloat16")]
    for i, (b, L, h, g, n, p, dt_name, strided) in enumerate(cases):
        args = ssd_inputs(torch, gen, b, L, h, g, n, p,
                          getattr(torch, dt_name), strided)
        # every other case as the model calls it: the final state from an
        # fp32 dt that y's dt rounds
        kw = {"state_dt": args[1].float() * (1 + 2 ** -10)} if i % 2 else {}
        worst = max(worst, check_ssd(
            f"ssd_scan edge case B={b} L={L} H={h} G={g} N={n} P={p} "
            f"{dt_name} strided={strided} state_dt={bool(kw)}",
            ssd_scan(*args, **kw), ssd_scan_plain(*args, **kw)))
    args = ssd_inputs(torch, gen, 1, LONG_PREFILL, 64, 1, 64, 64,
                      torch.bfloat16, True, (-1, 0.5))
    for kw in ({}, {"state_dt": args[1].float() * (1 + 2 ** -10)}):
        worst = max(worst, check_ssd(
            f"ssd_scan edge case zamba2 heads, L={LONG_PREFILL}, strided, "
            f"state_dt={bool(kw)}",
            ssd_scan(*args, **kw), ssd_scan_plain(*args, **kw)))
    for b, L, h in ((2, 65, 4), (2, 189, 4), (1, LONG_PREFILL, 64)):
        x, _, a, bm, cm = ssd_inputs(torch, gen, b, L, h, 1, 64, 64,
                                     torch.bfloat16, True)
        dt = 10.0 ** (torch.rand((b, L, h), generator=gen, device="cuda")
                      * 1.5 - 1)      # fp32, log-uniform from 0.1 to 3.2
        for kw in ({}, {"state_dt": dt}):
            worst = max(worst, check_ssd(
                f"ssd_scan edge case B={b} L={L} H={h} bfloat16 strided, "
                f"fp32 dt, state_dt={bool(kw)}",
                ssd_scan(x, dt, a, bm, cm, **kw),
                ssd_scan_plain(x, dt, a, bm, cm, **kw)))
    return worst


def check_ssd(what: str, got, want) -> float:
    """y and the final state against the plain version's; returns the
    largest |err| of y."""
    (y, state), (y_want, state_want) = got, want
    check_close(f"{what}, final state", "ssd_scan", state, state_want,
                SSD_STATE_TOL)
    return check_close(what, "ssd_scan", y, y_want)


def ssd_bwd_cases() -> list:
    """(b, L, h, g, n, p, dtype, strided) of ssd_scan_bwd's edge cases:
    every L of SSD_BWD_L at B 2, H 4 over G 1 and 2, every (N, P) of
    SSD_BWD_NP, fp32 and bf16, contiguous, and at the chunk edges and the
    serving length (63, 64, 65, 189) also as strided views of one xbc
    buffer; then 4,096 steps, strided, at B 1: H 4 over G 1, zamba2's 64
    heads (N 64) and mamba2-130m's 24 (N 128); then zamba2-1.2b's training
    shape (B 8, L 64, 64 heads), fp32 and bf16."""
    cases = [(2, L, 4, g, n, p, dt, strided)
             for L in SSD_BWD_L for g in (1, 2) for n, p in SSD_BWD_NP
             for dt in ("float32", "bfloat16")
             for strided in ((False, True) if L in (63, 64, 65, 189)
                             else (False,))]
    for dt in ("float32", "bfloat16"):
        cases += [(1, LONG_PREFILL, 4, 1, 64, 64, dt, True),
                  (1, LONG_PREFILL, 64, 1, 64, 64, dt, True),
                  (1, LONG_PREFILL, 24, 1, 128, 64, dt, True),
                  (TRAIN_BATCH, TRAIN_SEQ, 64, 1, 64, 64, dt, True)]
    return cases


def check_ssd_bwd(what: str, dtype: str, got, want) -> tuple[float, float]:
    """(dx, ddt, da, db, dc) against the plain version's under TOL_BWD;
    returns the largest |err| and the largest |err| over its gradient's
    largest |element|."""
    atol, rtol = TOL_BWD[dtype]
    worst = worst_rel = 0.0
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        scale = float(w.float().abs().max()) if w.numel() else 0.0
        err = check_close(f"{what} {name}", "ssd_scan_bwd", g, w,
                          (atol * scale, rtol))
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    return worst, worst_rel


def edge_ssd_bwd(torch) -> tuple[float, float]:
    """ssd_scan's backward kernel (dx, d(dt), da, dB, dC) against
    ``ssd_scan_bwd_plain`` over ``ssd_bwd_cases()``: seeded x, B, C and dy
    in the case's dtype, fp32 dt log-uniform from 1e-4 to 10 (the
    exponentials reach exp(-10) a step); every case is launched twice and
    the two results must be bitwise equal (fixed-order sums, no atomics).
    Then x as a view whose innermost stride is not 1 and dy expanded from
    one element, as ``y.sum()`` and ``y.mean()`` hand it to
    ``SsdScanFn``'s backward (through the Function too), and the smallest
    N at P 64 past a block's shared memory, N 240 in bf16 and N 144 in
    fp32, which the kernel's entry must refuse with a ValueError.  Returns
    the largest |err| and, per dtype, the largest relative to its
    gradient's largest |element|."""
    from repro_torch.kernels.ssd_scan.ops import (ssd_scan, ssd_scan_bwd,
                                                  ssd_scan_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    worst, worst_rel = 0.0, {"float32": 0.0, "bfloat16": 0.0}
    for b, L, h, g, n, p, dt_name, strided in ssd_bwd_cases():
        dtype = getattr(torch, dt_name)
        x, _, a, bm, cm = ssd_inputs(torch, gen, b, L, h, g, n, p, dtype,
                                     strided)
        dt = 10.0 ** (torch.rand((b, L, h), generator=gen, device="cuda")
                      * 5 - 4)
        dy = _randn(torch, gen, (b, L, h, p), dtype)
        args = (x, dt, a, bm, cm, dy)
        got, again = ssd_scan_bwd(*args), ssd_scan_bwd(*args)
        what = (f"ssd_scan_bwd B={b} L={L} H={h} G={g} N={n} P={p} "
                f"{dt_name} strided={strided}")
        for name, g1, g2 in zip(("dx", "ddt", "da", "db", "dc"), got,
                                again):
            if not torch.equal(g1, g2):
                fail(f"{what}: {name} differs between two calls")
        err, rel = check_ssd_bwd(what, dt_name, got,
                                 ssd_scan_bwd_plain(*args))
        worst = max(worst, err)
        worst_rel[dt_name] = max(worst_rel[dt_name], rel)
    # views whose innermost stride is not 1: x transposed in its last two
    # dimensions and dy expanded from one element, directly and as
    # y.sum()/y.mean() hand it to SsdScanFn's backward
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        x, dt, a, bm, cm = ssd_inputs(torch, gen, 2, 189, 4, 2, 64, 64,
                                      dtype, True)
        dt = dt.float()
        xt = x.transpose(2, 3).contiguous().transpose(2, 3)
        for reduce, scale in (("sum", 1.0), ("mean", 1.0 / x.numel())):
            dy = torch.full((1, 1, 1, 1), scale, dtype=dtype,
                            device="cuda").expand_as(x)
            want = ssd_scan_bwd_plain(x, dt, a, bm, cm, dy.contiguous())
            what = f"ssd_scan_bwd {dt_name} y.{reduce}()"
            got = ssd_scan_bwd(xt, dt, a, bm, cm, dy)
            if not all(torch.equal(g1, g2) for g1, g2 in zip(
                    got, ssd_scan_bwd(xt, dt, a, bm, cm, dy))):
                fail(f"{what}: differs between two calls")
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (x, dt, a, bm, cm)]
            y = ssd_scan(*leaves)[0]
            fn = torch.autograd.grad(getattr(y, reduce)(), leaves)
            for name, g in zip(("x, x^T view", "function"), (got, fn)):
                err, rel = check_ssd_bwd(f"{what} ({name})", dt_name, g,
                                         want)
                worst = max(worst, err)
                worst_rel[dt_name] = max(worst_rel[dt_name], rel)
    # the smallest N at P 64 past a block's shared memory: the kernel's
    # entry refuses it
    for n, dtype in ((240, torch.bfloat16), (144, torch.float32)):
        x, dt, a, bm, cm = ssd_inputs(torch, gen, 1, 64, 2, 1, n, 64, dtype)
        try:
            ssd_scan_bwd(x, dt.float(), a, bm, cm, torch.zeros_like(x))
            fail(f"ssd_scan_bwd took N {n} with P 64 in {dtype}, past a "
                 "block's shared memory")
        except ValueError:
            pass
    return worst, worst_rel


def edge_paged(torch, np) -> float:
    """paged_attention against its plain version: B 1-3 (cycling), G 1, 2,
    3, 6 and 8 query heads per kv head (2 kv heads), head_dim 64 and 128,
    page sizes 16 and 32, fp32 and bf16; page tables drawn with repeats
    from a 3*MAXP-page pool, entries past each sequence's last page set to
    -1 or 2**30 (never followed); lengths cycling through 0, 1, PS, PS+1
    and MAXP*PS.  Then the serving paths' kv-head counts the same way:
    qwen3-1.7b's 8 kv heads (G 2, D 128) and zamba2-1.2b's 32 (G 1, D 64),
    PS 32.  Then the kernel's split of a sequence over blocks: lengths
    split-1, split, split+1 and 2*split (qwen3's heads, MAXP*PS 4,096), an
    all-empty batch, and one sequence of 4,096 tokens over a shuffled
    pool, each of which must take more than one split.  Returns the
    largest |err|."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_plain, split_plan)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    rng = np.random.default_rng(15)
    maxp, worst, i = 5, 0.0, 0
    cases = [(2, g, d, ps) for d in (64, 128) for g in (1, 2, 3, 6, 8)
             for ps in (16, 32)] + [(8, 2, 128, 32), (32, 1, 64, 32)]
    for hkv, g, d, ps in cases:
        for dt in ("float32", "bfloat16"):
            b = 1 + i % 3
            edges = [0, 1, ps, ps + 1, maxp * ps]
            lengths = [edges[(i + j) % 5] for j in range(b)]
            i += 1
            n_pages = 3 * maxp
            table = rng.integers(0, n_pages, (b, maxp))
            for row, n in enumerate(lengths):
                table[row, -(-n // ps):] = (-1, 2 ** 30)[row % 2]
            dtype = getattr(torch, dt)
            q = _randn(torch, gen, (b, g * hkv, d), dtype)
            kp = _randn(torch, gen, (n_pages, ps, hkv, d), dtype)
            vp = _randn(torch, gen, (n_pages, ps, hkv, d), dtype)
            pt = torch.tensor(table, dtype=torch.int32, device="cuda")
            ln = torch.tensor(lengths, dtype=torch.int32,
                              device="cuda")
            got = paged_attention(q, kp, vp, pt, ln)
            want = paged_attention_plain(q, kp, vp, pt, ln)
            what = (f"paged_attention edge case B={b} Hkv={hkv} G={g} "
                    f"D={d} PS={ps} lengths={lengths} {dt}")
            worst = max(worst, check_close(what, "paged_attention", got,
                                           want),
                        check_paged_lse(torch, what, got,
                                        (q, kp, vp, pt, ln),
                                        (q, kp, vp, pt, ln)))

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per = split_plan(128 * 32, 4, 8, n_sm)[1]
    split_cases = [  # (hkv, g, d, ps, maxp, pool pages, lengths, dtypes)
        (8, 2, 128, 32, 128, 600, [per - 1, per, per + 1, 2 * per],
         ("float32", "bfloat16")),
        (2, 3, 64, 16, 40, 120, [0, 0, 0], ("float32", "bfloat16")),
        (8, 2, 128, 32, 128, 2048, [4096], ("bfloat16",))]
    for hkv, g, d, ps, maxp, n_pages, lengths, dts in split_cases:
        b = len(lengths)
        ns, per = split_plan(maxp * ps, b, hkv, n_sm)
        if ns < 2 or (max(lengths) > 0 and -(-max(lengths) // per) < 2):
            fail(f"paged_attention split case lengths={lengths}: the plan "
                 f"({ns} x {per} tokens) does not split it")
        pt = torch.randperm(n_pages, generator=gen, device="cuda")[
            :b * maxp].view(b, maxp).to(torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for dt in dts:
            dtype = getattr(torch, dt)
            q = _randn(torch, gen, (b, g * hkv, d), dtype)
            kp = _randn(torch, gen, (n_pages, ps, hkv, d), dtype)
            vp = _randn(torch, gen, (n_pages, ps, hkv, d), dtype)
            got = paged_attention(q, kp, vp, pt, ln)
            want = paged_attention_plain(q, kp, vp, pt, ln)
            if max(lengths) == 0 and bool(got.any()):
                fail("paged_attention: an all-empty batch must give zeros")
            what = (f"paged_attention split case B={b} Hkv={hkv} G={g} "
                    f"D={d} PS={ps} lengths={lengths} ({ns} splits of "
                    f"{per}) {dt}")
            worst = max(worst, check_close(what, "paged_attention", got,
                                           want),
                        check_paged_lse(torch, what, got,
                                        (q, kp, vp, pt, ln),
                                        (q, kp, vp, pt, ln)))

    # sliding windows, poisoned before the window: head_dim 256 (gemma3's
    # G 4 over 1 kv head, and G 1 and 8 over 2) at every window, then the
    # D 64/128 cases above again, each with a window
    for g, hkv in ((1, 2), (4, 1), (8, 2)):
        for w in (1, 31, 32, 33, GEMMA_WINDOW, 10 ** 6):
            for dt in ("float32", "bfloat16"):
                worst = max(worst, paged_window_case(
                    torch, np, gen, rng, n_sm, hkv, g, 256, 32, 24, w, dt))
    for i, (hkv, g, d, ps) in enumerate(cases):
        w = (1, ps - 1, ps, ps + 1, 2 * ps + 3, 10 ** 6)[i % 6]
        for dt in ("float32", "bfloat16"):
            worst = max(worst, paged_window_case(
                torch, np, gen, rng, n_sm, hkv, g, d, ps, 5, w, dt))
    for w in (GEMMA_WINDOW, None):      # gemma3's long decode, B 1
        worst = max(worst, paged_window_case(
            torch, np, gen, rng, n_sm, 1, 4, 256, 32, LONG_PREFILL // 32, w,
            "bfloat16", lengths=[LONG_PREFILL]))
    return worst


def paged_window_case(torch, np, gen, rng, n_sm, hkv, g, d, ps, maxp,
                      window, dt, lengths=None) -> float:
    """paged_attention with ``window`` over 18 sequences (or ``lengths``)
    whose lengths sit at the kernel's edges: 0, 1, a page (PS, PS+1), a
    split of the window's span (per-1, per, per+1), the window (w-1, w,
    w+1), the first live token at a page edge (w+PS-1, w+PS, w+PS+1), a
    split past the window and MAXP*PS.  Every page is some sequence's once
    (a shuffled pool).  The kernel gets poisoned inputs: NaN in every row
    before the window's first token (the rest of its first live page's
    and every page wholly before it) and page-table entries -1 or 2**30
    for those pages and for those past the length; it must match the plain
    version on the clean inputs, so it read nothing before the window."""
    from repro_torch.kernels.paged_attention.ops import (
        RESIDENT_BLOCKS_D256, RESIDENT_BLOCKS_PER_SM, paged_attention,
        paged_attention_plain, split_plan)
    dtype = getattr(torch, dt)
    cap = maxp * ps
    w = window or 0
    b = 18 if lengths is None else len(lengths)
    _, per = split_plan(min(cap, w) if w else cap, b, hkv, n_sm,
                        RESIDENT_BLOCKS_D256[dtype] if d == 256
                        else RESIDENT_BLOCKS_PER_SM)
    if lengths is None:
        edges = {0, 1, ps, ps + 1, per - 1, per, per + 1, cap}
        if w:
            edges |= {w + x for x in (-1, 0, 1, ps - 1, ps, ps + 1,
                                      per - 1, per, per + 1)}
        lengths = sorted(x for x in edges if 0 <= x <= cap)[:b]
        lengths += [int(x) for x in rng.integers(0, cap + 1,
                                                 b - len(lengths))]
    n_pages = b * maxp
    table = rng.permutation(n_pages).reshape(b, maxp)
    bad = table.copy()
    q = _randn(torch, gen, (b, g * hkv, d), dtype)
    kp = _randn(torch, gen, (n_pages, ps, hkv, d), dtype)
    vp = _randn(torch, gen, (n_pages, ps, hkv, d), dtype)
    kp_bad, vp_bad = kp.clone(), vp.clone()
    for row, n in enumerate(lengths):
        fill = (-1, 2 ** 30)[row % 2]
        table[row, -(-n // ps):] = fill
        bad[row, -(-n // ps):] = fill
        lo = max(0, n - w) if w else 0
        dead = [int(p) for p in bad[row, :lo // ps]]
        bad[row, :lo // ps] = fill
        for x in (kp_bad, vp_bad):
            x[dead] = float("nan")
            if lo % ps:
                x[int(table[row, lo // ps]), :lo % ps] = float("nan")
    pt, pt_bad = (torch.tensor(t, dtype=torch.int32, device="cuda")
                  for t in (table, bad))
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = paged_attention(q, kp_bad, vp_bad, pt_bad, ln, window=window)
    want = paged_attention_plain(q, kp, vp, pt, ln, window=window)
    what = (f"paged_attention window case B={b} Hkv={hkv} G={g} D={d} "
            f"PS={ps} MAXP={maxp} window={window} lengths={lengths} {dt}, "
            "poisoned before the window")
    return max(check_close(what, "paged_attention", got, want),
               check_paged_lse(torch, what, got,
                               (q, kp_bad, vp_bad, pt_bad, ln),
                               (q, kp, vp, pt, ln), window))


# --------------------------------------------------------- serving path
def attention_layers(cfg) -> int:
    """Attention layers a decode step runs through the attention kernels:
    every layer of a GQA decoder, none of an MLA one (its attention is
    plain torch, as the reference's), each shared-block application of a
    hybrid, none of a pure SSM (``attn_every`` 0), whisper's self and cross
    attention of every decoder layer."""
    if cfg.family == "decoder":
        return cfg.n_layers if cfg.attn_kind == "gqa" else 0
    if cfg.family == "encdec":
        return 2 * cfg.n_layers
    if not cfg.attn_every:
        return 0
    return len(range(cfg.attn_every, cfg.n_layers, cfg.attn_every))


def prefill_attention_layers(cfg) -> int:
    """flash_attention calls of one request's prefill: the decode step's
    attention layers, and whisper's encoder layers."""
    return attention_layers(cfg) + (cfg.enc_layers
                                    if cfg.family == "encdec" else 0)


def serve_path(torch, np, arch: str) -> dict:
    """The serving entry point at ``arch``'s full size, with the
    reference's defaults (8 requests, 16 decode tokens, 32-token blocks,
    max_seq 512, 50 req/s offered, no admission limit)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    t0 = time.perf_counter()
    out = serve.run(arch, smoke=False, compute_device="cuda")
    wall = time.perf_counter() - t0
    s = out["stats"]
    lens = [len(r) for r in serve.make_requests(SERVE_REQUESTS,
                                                cfg.vocab_size)]
    outs = out["outputs"]
    if not (len(outs) == s["requests_admitted"] == SERVE_REQUESTS
            and all(len(o) == DECODE_TOKENS
                    and all(0 <= t < cfg.vocab_size for t in o)
                    for o in outs)):
        fail(f"serving path {arch}: every request must get {DECODE_TOKENS} "
             "tokens in the vocab")
    # two shared 128-token prefixes: every request after the first two
    # finds its prefix (four 32-token blocks) in the vLSM index
    if s["prefix_hits"] != SERVE_REQUESTS - 2 \
            or s["tokens_reused"] != 128 * (SERVE_REQUESTS - 2):
        fail(f"serving path {arch}: prefix hits {s['prefix_hits']}, reused "
             f"{s['tokens_reused']}")
    steps = DECODE_TOKENS - 1
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "param_dtype": cfg.param_dtype, "params": cfg.param_count(),
        "wall_s": wall, "requests_served": s["requests_admitted"],
        "requests_rejected": s["requests_rejected"],
        "prefix_hits": s["prefix_hits"], "tokens_reused": s["tokens_reused"],
        "prompt_tokens": lens, "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
        "latency_ms": s["latency_ms"], "prefill_ms": s["prefill_ms"],
        "decode_ms": s["decode_ms"],
        "prefill_tok_s": sum(lens) / (sum(s["prefill_ms"]) / 1e3),
        "prefill_tok_s_after_first": sum(lens[1:])
        / (sum(s["prefill_ms"][1:]) / 1e3),
        "decode_tok_s": steps * len(outs) / (sum(s["decode_ms"]) / 1e3),
        "decode_ms_per_token_after_first": sum(s["decode_ms"][1:])
        / (steps * (len(outs) - 1)),
        "paged_launches_expected": attention_layers(cfg) * steps * len(outs),
        "flash_launches_expected": prefill_attention_layers(cfg) * len(outs),
        "prefix_cache": s["prefix_cache"], "outputs": outs,
    }


def serve_phase(torch, np, arch: str) -> dict:
    """``serve_path`` with the launch counts zeroed just before and read
    just after, and the device's peak memory: every kernel of
    SERVE_PATHS[arch] must have launched, paged_attention once per
    attention layer and decode step, flash_attention once per attention
    layer and request."""
    import gc
    from repro_torch import kernels
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the card's free memory (every process's) and this process's tracked
    # objects before the run: deepseek-v2-lite's serve stalled mid-run in
    # the whole smoke and not alone (PERF.md, PR 24)
    before = {"device_free_gb": torch.cuda.mem_get_info()[0] / 1e9,
              "gc_tracked_objects": len(gc.get_objects()),
              "gc_counts": gc.get_count()}
    kernels.reset_launch_counts()
    srv = serve_path(torch, np, arch)
    srv["before"] = before
    counts = srv["launches"] = kernels.launch_counts()
    srv["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    if not all(counts[k] > 0 for k in SERVE_PATHS[arch][0]):
        fail(f"serving path {arch}: a kernel never launched: {counts}")
    for name in ("paged", "flash"):
        want = srv[f"{name}_launches_expected"]
        if counts[f"{name}_attention"] != want:
            fail(f"serving path {arch}: {name}_attention launched "
                 f"{counts[f'{name}_attention']} times, not {want}")
    return srv


def long_window_decode(torch, np) -> dict:
    """gemma3-1b at full size in bf16 on the card: a 4,096-token prefill
    (seeded tokens), then LONG_WINDOW_DECODE greedy steps, each through 26
    paged_attention calls of which the local layers' read their 512-token
    window.  Logits must be finite, flash_attention launch once a layer and
    paged_attention once a layer and step.  Reports ms a decode token."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_model
    cfg = get_config("gemma3_1b")
    params = init_model(cfg, 0, compute_device="cuda")
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, LONG_PREFILL)).astype(np.int32)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = forward(cfg, params, {"tokens": tokens},
                            cache_len=LONG_PREFILL + LONG_WINDOW_DECODE,
                            compute_device="cuda")
    tok = torch.argmax(logits[:, -1:], -1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    finite = bool(logits.float().isfinite().all())
    pos = torch.tensor([LONG_PREFILL], device="cuda")
    step_ms = []
    for t in range(LONG_WINDOW_DECODE):
        s0 = time.perf_counter()
        logits, cache = decode_step(cfg, params, tok, pos + t, cache,
                                    compute_device="cuda")
        tok = torch.argmax(logits[:, -1:], -1)
        finite &= bool(logits.float().isfinite().all())   # waits
        step_ms.append((time.perf_counter() - s0) * 1e3)
    counts = kernels.launch_counts()
    want = {"flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * LONG_WINDOW_DECODE}
    if not finite or any(counts[k] != v for k, v in want.items()):
        fail(f"long windowed decode: finite logits {finite}, launches "
             f"{counts} (want {want})")
    local = sum(1 for w in cfg.layer_windows() if w > 0)
    return {"prefill_tokens": LONG_PREFILL, "steps": LONG_WINDOW_DECODE,
            "local_layers": local, "global_layers": cfg.n_layers - local,
            "prefill_s": t1 - t0, "decode_ms_per_token": step_ms,
            "decode_ms_per_token_after_first":
                sum(step_ms[1:]) / (len(step_ms) - 1),
            "launches": counts}


def serve_cross_check(torch, np, arch: str, layers: int) -> dict:
    """The serving model ``arch`` in float32 at full width, depth cut to
    ``layers`` (zamba2's 7 keep one shared-attention application, gemma3's
    6 five local layers and a global one, deepseek-v2-lite's 2 its dense
    layer and one MoE layer), card against the CPU tier with the same
    weights: the first request's prefill and 4 greedy decode steps (or
    CROSS_LONG's seeded prompt, cache and steps), MLA in both decode forms
    from the one prefill.  Tokens must be identical and logits within
    CROSS_TOL of max(1, max|logit|): fp32 sums over 2048-10944 terms taken
    in another order on each side (the smoke-size CPU parity, 128 wide,
    measured 3.5e-6), while a wrong kernel moves logits by O(0.1)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import decode_step, forward, init_model
    cfg = get_config(arch).with_(n_layers=layers, param_dtype="float32")
    params = init_model(cfg, 0, compute_device="cuda")

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}
    cpu_params = to_cpu(params)
    tokens = make_requests(SERVE_REQUESTS, cfg.vocab_size)[0]
    cache_len, n_steps = 512, 4
    if arch in CROSS_LONG:
        n_tok, cache_len, n_steps = CROSS_LONG[arch]
        tokens = np.random.default_rng(6).integers(
            0, cfg.vocab_size, n_tok).astype(np.int32)
    forms = (True, False) if cfg.attn_kind == "mla" else (True,)
    batch = {"tokens": tokens[None]}
    if cfg.family == "encdec":      # the first request's frames, as served
        batch["encoder_embeds"] = np.random.default_rng(0).standard_normal(
            (1, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    runs = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        logits0, cache0 = forward(cfg, p, batch, cache_len=cache_len,
                                  compute_device=dev)
        steps = [logits0.float().cpu()]
        toks = [int(torch.argmax(logits0[0, -1]))]
        for absorbed in forms:
            cache = {k: v.clone() for k, v in cache0.items()}
            tok = torch.argmax(logits0[:, -1:], -1)
            pos = torch.tensor([len(tokens)], device=dev)
            for t in range(n_steps):
                logits, cache = decode_step(cfg, p, tok, pos + t, cache,
                                            absorbed_mla=absorbed,
                                            compute_device=dev)
                steps.append(logits.float().cpu())
                tok = torch.argmax(logits[:, -1:], -1)
                toks.append(int(tok[0, 0]))
        runs[dev] = (steps, toks, time.perf_counter() - t0)
    (c_steps, c_toks, c_wall), (h_steps, h_toks, h_wall) = \
        runs["cuda"], runs["cpu"]
    errs = [float((a - b).abs().max()) for a, b in zip(c_steps, h_steps)]
    scale = max(1.0, max(float(b.abs().max()) for b in h_steps))
    if c_toks != h_toks or max(errs) > CROSS_TOL * scale:
        fail(f"serving cross-check {arch}: tokens {c_toks} vs {h_toks}, "
             f"logits max |err| per step {errs} (scale {scale})")
    return {"layers": layers, "prompt_tokens": len(tokens),
            "cache_len": cache_len, "decode_forms": len(forms),
            "tokens": c_toks, "max_abs_logit_err": errs,
            "max_abs_logit": scale, "card_s": c_wall, "cpu_s": h_wall}


def sequential_state(torch, x, dt, a, bm):
    """Mamba2's final state by the reference's own formulation
    (``ssd_final_state``): a sequential fp32 scan, fp32 dt, fp32 products
    of B and x.  x [B, L, H, P], dt [B, L, H] fp32, a [H], bm [B, L, G, N]
    -> [B, H, N, P]."""
    b, L, h, p = x.shape
    bf = bm.repeat_interleave(h // bm.shape[2], dim=2)
    s = torch.zeros((b, h, bm.shape[3], p), dtype=torch.float32,
                    device=x.device)
    lam = torch.exp(dt * a[None, None, :])
    for t in range(L):
        s = lam[:, t, :, None, None] * s + dt[:, t, :, None, None] * (
            bf[:, t, :, :, None] * x[:, t, :, None, :].float())
    return s


def serve_state_check(torch, np) -> dict:
    """zamba2-1.2b at full width and depth in bf16 (seeded weights), the
    first request's prefill on the card: every Mamba2 layer's final state
    from the kernel, held under SSD_STATE_TOL to ``sequential_state`` (fp32)
    on that layer's own scan inputs (recorded by wrapping the model's
    ``ssd_scan``).  Then the hand-off to decode, in float32 (the same
    weights and caches widened: bf16 decode turns any rounding-level change
    of a state into whole ulps of the logits, which then spread, so it
    cannot tell a right state from a wrong one): from the prefill's first
    token, 15 greedy steps from the kernel's states must give the tokens
    the fp32 sequential scan's give; fed the tokens of an fp64 sequential
    scan's states, their logits must stay within CROSS_TOL of max(1,
    max|logit|) of that scan's at every step, and those of states from dt
    rounded to bf16 (the fault this check guards against, in the same
    sequential scan) must not."""
    import repro_torch.models.ssd as ssd_mod
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import decode_step, forward, init_model
    cfg = get_config("zamba2_1_2b")
    params = init_model(cfg, 0, compute_device="cuda")
    tokens = make_requests(SERVE_REQUESTS, cfg.vocab_size)[0]
    orig, calls = ssd_mod.ssd_scan, []

    def recorded(x, dt, a, b, c, **kw):
        y, state = orig(x, dt, a, b, c, **kw)
        calls.append((x, kw.get("state_dt"), a, b, state))
        return y, state
    ssd_mod.ssd_scan = recorded
    try:
        logits, cache = forward(cfg, params, {"tokens": tokens[None]},
                                cache_len=512, compute_device="cuda")
    finally:
        ssd_mod.ssd_scan = orig
    if len(calls) != cfg.n_layers or any(c[1] is None for c in calls):
        fail("zamba2 state check: every Mamba2 layer must scan with the "
             "fp32 state_dt")
    if not torch.equal(cache["state"], torch.stack([c[4] for c in calls])):
        fail("zamba2 state check: the cache holds other states")
    errs, sets = [], {"kernel": [], "seq32": [], "seq64": [], "bf16_dt": []}
    for i, (x, dt, a, bm, state) in enumerate(calls):
        sets["kernel"].append(state)
        sets["seq32"].append(sequential_state(torch, x, dt, a, bm))
        sets["seq64"].append(sequential_state(
            torch, x.double(), dt.double(), a.double(), bm.double()).float())
        sets["bf16_dt"].append(sequential_state(
            torch, x, dt.to(x.dtype).float(), a, bm))
        errs.append(check_close(f"zamba2 bf16 layer {i} final state",
                                "ssd_scan", state, sets["seq32"][-1],
                                SSD_STATE_TOL))

    def widen(tree):
        return {k: widen(v) if isinstance(v, dict) else
                v.float() if v.is_floating_point() else v
                for k, v in tree.items()}
    params32, cache32 = widen(params), widen(cache)
    del params
    tok0 = torch.argmax(logits[:, -1:], -1)
    pos = torch.tensor([len(tokens)], device="cuda")

    def decode(states, feed=None):
        """(greedy tokens, logits of each step) in float32 from ``states``,
        fed ``feed`` if given."""
        c = {k: v.clone() for k, v in cache32.items()}
        c["state"] = torch.stack(states)
        tok, toks, steps = tok0, [int(tok0[0, 0])], []
        for t in range(DECODE_TOKENS - 1):
            lg, c = decode_step(cfg, params32, tok, pos + t, c,
                                compute_device="cuda")
            steps.append(lg[0, -1])
            toks.append(int(torch.argmax(steps[-1])))
            tok = torch.full_like(tok, feed[t + 1] if feed else toks[-1])
        return toks, steps
    toks = {name: decode(sets[name])[0] for name in ("kernel", "seq32")}
    if toks["kernel"] != toks["seq32"]:
        fail(f"zamba2 state check: greedy tokens from the kernel's states "
             f"{toks['kernel']}, from the fp32 scan's {toks['seq32']}")
    ref_toks, ref_steps = decode(sets["seq64"])
    scale = max(1.0, max(float(p.abs().max()) for p in ref_steps))
    dist = {name: [float((p - q).abs().max()) for p, q in
                   zip(decode(sets[name], ref_toks)[1], ref_steps)]
            for name in ("kernel", "seq32", "bf16_dt")}
    bound = CROSS_TOL * scale
    if max(dist["kernel"]) > bound:
        fail(f"zamba2 state check: float32 decode logits from the kernel's "
             f"states move up to {max(dist['kernel'])} from the fp64 scan's, "
             f"more than {bound}")
    if max(dist["bf16_dt"]) <= bound:
        fail(f"zamba2 state check: states from bf16 dt move the logits only "
             f"{max(dist['bf16_dt'])}, within {bound}: the check cannot see "
             "the fault")
    return {"layers": len(calls), "prompt_tokens": len(tokens),
            "max_abs_state_err": max(errs), "per_layer_err": errs,
            "max_abs_state": max(float(p.abs().max()) for p in sets["seq32"]),
            "bf16_dt_state_err": max(float((p - q).abs().max()) for p, q in
                                     zip(sets["bf16_dt"], sets["seq32"])),
            "tokens": toks["kernel"], "tokens_fp64": ref_toks,
            "max_abs_logit": scale, "logit_bound": bound,
            **{f"logit_dist_{k}": v for k, v in dist.items()}}


# ----------------------------------------------------- LM kernel timings
def attn_pairs(sq: int, sk: int, causal: bool,
               window: int | None = None) -> int:
    """Unmasked (query, key) pairs of one head: S(S+1)/2 causal, each
    query's min(i + 1, window) with a window, Sq x Sk non-causal."""
    if not causal:
        return sq * sk
    w = min(window or sq, sq)
    return w * (w + 1) // 2 + (sq - w) * w


def flash_bound(bh: int, s: int, d: int, bkv: int | None = None,
                nbytes_el: int = 2, window: int | None = None):
    """q, k, v read and o written once (k and v of ``bkv`` heads); 4*D
    operations per unmasked (query, key) pair: S(S+1)/2 pairs per head
    (causal), each query's min(i + 1, window) with a window."""
    bkv = bh if bkv is None else bkv
    return roofline((2 * bh + 2 * bkv) * s * d * nbytes_el,
                    4 * d * attn_pairs(s, s, True, window) * bh)


def paged_bound(b: int, hq: int, hkv: int, d: int, length: int,
                maxp: int, nbytes_el: int = 2, window: int | None = None):
    """q read and o written once, the K and V rows of each sequence's live
    tokens (``length``, or the last ``window`` of them) read once, the page
    table and lengths read once; 4*D operations per (query head, live
    token)."""
    live = min(length, window) if window else length
    nbytes = nbytes_el * (2 * b * hq * d + 2 * b * live * hkv * d) \
        + 4 * b * (maxp + 1)
    return roofline(nbytes, 4 * d * b * hq * live)


def ssd_bound(b: int, L: int, h: int, g: int, n: int, p: int,
              nbytes_el: int = 2):
    """x, B, C and the fp32 dt read and y written once, the fp32 final
    state written once (a negligible); the recurrence's 4*N*P operations
    per step and head (state update and readout)."""
    nbytes = nbytes_el * (2 * b * L * h * p + 2 * b * L * g * n) \
        + 4 * b * L * h + 4 * b * h * n * p
    return roofline(nbytes, 4 * n * p * L * b * h)


def check_flash(torch, s: int, hq: int = 32, hkv: int = 32, d: int = 64,
                window: int | None = None):
    """A serving model's attention prefill, B 1, bf16, causal, at S tokens
    (seeded random inputs): zamba2-1.2b's shared block by default (32 heads
    of 64, kv 32), qwen3-1.7b's with hq 16, hkv 8, d 128, gemma3-1b's with
    hq 4, hkv 1, d 256 (a local layer's with window 512).  Library: SDPA
    (``enable_gqa``), with an explicit causal and window mask for a
    window.  Held against its plain version; returns the row and the
    kernel, plain and library calls."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    q = _randn(torch, gen, (1, hq, s, d), torch.bfloat16)
    k, v = (_randn(torch, gen, (1, hkv, s, d), torch.bfloat16)
            for _ in range(2))
    err = check_close(f"flash_attention at S={s} H={hq}/{hkv} D={d} "
                      f"window={window}", "flash_attention",
                      flash_attention(q, k, v, window=window),
                      flash_attention_plain(q, k, v, window=window))
    bound, by = flash_bound(hq, s, d, hkv, window=window)
    if window is None:
        def library():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=hq != hkv)
    else:
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=hq != hkv)
    return ({"shape": f"BH {hq} (kv {hkv}), S {s}, D {d}, bf16, causal"
                      + (f", window {window}" if window else ""),
             "max_abs_err": err, "bound_ms": bound, "bound_by": by},
            lambda: flash_attention(q, k, v, window=window),
            lambda: flash_attention_plain(q, k, v, window=window), library)


def time_flash(torch, s: int, reps: int, hq: int = 32, hkv: int = 32,
               d: int = 64, window: int | None = None) -> dict:
    """check_flash's row, timed beside SDPA."""
    row, *calls = check_flash(torch, s, hq, hkv, d, window)
    return {**row, **time_all(torch, *calls, reps)}


def check_paged(torch, length: int, hq: int = 16, hkv: int = 8,
                d: int = 128, window: int | None = None, smax: int = 512):
    """A serving model's decode attention as its serving path calls it:
    B 1, bf16, the ``smax``-token decode cache (the serving path's 512 by
    default) viewed as pages of 32 through the identity table, ``length``
    live tokens (seeded random cache): qwen3-1.7b's by default (16 query
    heads over 8 kv heads of 128), zamba2-1.2b's shared block with hq 32,
    hkv 32, d 64, gemma3-1b's with hq 4, hkv 1, d 256 (a local layer's
    with window 512: the last 512 tokens are live).  Library: SDPA over the
    dense cache with a length (and window) mask, transposes included (the
    same function only because the table is the identity).  Held against
    its plain version; returns the row and the kernel, plain and library
    calls."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    ps = 32
    bf = torch.bfloat16
    q = _randn(torch, gen, (1, hq, d), bf)
    kc, vc = (_randn(torch, gen, (1, smax, hkv, d), bf) for _ in range(2))
    kp, vp = (c.view(smax // ps, ps, hkv, d) for c in (kc, vc))
    pt = torch.arange(smax // ps, dtype=torch.int32,
                      device="cuda").view(1, -1)
    ln = torch.tensor([length], dtype=torch.int32, device="cuda")
    tok = torch.arange(smax, device="cuda")
    live = tok < length
    if window:
        live &= tok >= length - window
    mask = live.view(1, 1, 1, smax)

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=hq != hkv)[:, :, 0]

    def kernel():
        return paged_attention(q, kp, vp, pt, ln, window=window)

    def plain():
        return paged_attention_plain(q, kp, vp, pt, ln, window=window)
    got = kernel()
    err = check_close(f"paged_attention at length {length} H={hq}/{hkv} "
                      f"D={d} window={window}", "paged_attention", got,
                      plain())
    bound, by = paged_bound(1, hq, hkv, d, length, smax // ps,
                            window=window)
    return ({"shape": f"B 1, H {hq} (kv {hkv}), D {d}, PS {ps}, MAXP "
                      f"{smax // ps}, length {length}, bf16, identity table"
                      + (f", window {window}" if window else ""),
             "max_abs_err": err, "bound_ms": bound, "bound_by": by,
             "library_max_abs_err": float((library() - got).float().abs()
                                          .max())},
            kernel, plain, library)


def time_paged(torch, length: int, reps: int, hq: int = 16, hkv: int = 8,
               d: int = 128, window: int | None = None,
               smax: int = 512) -> dict:
    """check_paged's row, timed beside SDPA."""
    row, *calls = check_paged(torch, length, hq, hkv, d, window, smax)
    return {**row, **time_all(torch, *calls, reps)}


def check_paged_long(torch, b: int = LONG_DECODE[0]):
    """Long decode: ``b`` sequences (LONG_DECODE's 8 by default) of 4,096
    tokens each over a pool of 2,048 pages of 32 (H 16 over kv 8, D 128,
    bf16), the sequences' pages drawn without repeats from a shuffled pool.
    Library: SDPA over the same KV laid out contiguously (gathered outside
    the timing).  Held against its plain version; returns the row and the
    kernel, plain and library calls."""
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    _, length, n_pages = LONG_DECODE
    hq, hkv, d, ps = 16, 8, 128, 32
    maxp = length // ps
    bf = torch.bfloat16
    q = _randn(torch, gen, (b, hq, d), bf)
    kp, vp = (_randn(torch, gen, (n_pages, ps, hkv, d), bf)
              for _ in range(2))
    pt = torch.randperm(n_pages, generator=gen, device="cuda")[:b * maxp] \
        .view(b, maxp).to(torch.int32)
    ln = torch.full((b,), length, dtype=torch.int32, device="cuda")
    kc, vc = (x[pt.long()].view(b, length, hkv, d).transpose(1, 2)
              .contiguous() for x in (kp, vp))
    got = paged_attention(q, kp, vp, pt, ln)
    err = check_close("paged_attention, long decode", "paged_attention",
                      got, paged_attention_plain(q, kp, vp, pt, ln))
    bound, by = paged_bound(b, hq, hkv, d, length, maxp)
    return ({"shape": f"B {b}, H {hq} (kv {hkv}), D {d}, PS {ps}, length "
                      f"{length}, shuffled table over {n_pages} pages, bf16",
             "max_abs_err": err, "bound_ms": bound, "bound_by": by},
            lambda: paged_attention(q, kp, vp, pt, ln),
            lambda: paged_attention_plain(q, kp, vp, pt, ln),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, enable_gqa=True))


def time_paged_long(torch, reps: int, b: int = LONG_DECODE[0]) -> dict:
    """check_paged_long's row, timed beside SDPA."""
    row, *calls = check_paged_long(torch, b)
    return {**row, **time_all(torch, *calls, reps)}


def time_ssd(torch, L: int, reps: int) -> dict:
    """zamba2-1.2b's Mamba2 prefill: B 1, 64 heads of P 64, one group of
    N 64, bf16, at L tokens, x, B and C as strided views of one xbc buffer
    and fp32 dt for y and the final state (``state_dt`` that same dt), as
    ``models/ssd.py`` calls it (seeded random inputs, dt in the softplus
    range); also timed without ``state_dt`` (y's scan alone), the cost of
    the state's run.  The kernel pads nothing."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    bf = torch.bfloat16
    xbc = torch.randn((1, L, 64 * 64 + 2 * 64), generator=gen,
                      device="cuda")
    xbc[..., 64 * 64:] *= 0.3
    xbc = xbc.to(bf)
    x = xbc[..., :64 * 64].reshape(1, L, 64, 64)
    bm = xbc[..., 64 * 64:64 * 64 + 64].reshape(1, L, 1, 64)
    cm = xbc[..., 64 * 64 + 64:].reshape(1, L, 1, 64)
    dt = torch.nn.functional.softplus(
        torch.randn((1, L, 64), generator=gen, device="cuda"))
    a = -torch.ones(64, device="cuda")
    err = check_ssd(f"ssd_scan at L={L}",
                    ssd_scan(x, dt, a, bm, cm, state_dt=dt),
                    ssd_scan_plain(x, dt, a, bm, cm, state_dt=dt))
    state_err = float((ssd_scan(x, dt, a, bm, cm, state_dt=dt)[1]
                       - sequential_state(torch, x, dt, a, bm)).abs().max())
    bound, by = ssd_bound(1, L, 64, 1, 64, 64)
    return {"shape": f"BH 64, L {L}, P 64, N 64, bf16, strided xbc views, "
                     "fp32 dt and state_dt",
            "max_abs_err": err, "bound_ms": bound, "bound_by": by,
            "state_err_vs_sequential": state_err,
            "without_state_dt_ms": cuda_ms(
                torch, lambda: ssd_scan(x, dt, a, bm, cm), reps),
            "without_state_dt_device_ms": device_ms(
                torch, lambda: ssd_scan(x, dt, a, bm, cm), reps)[0],
            **time_all(torch, lambda: ssd_scan(x, dt, a, bm, cm,
                                               state_dt=dt),
                       lambda: ssd_scan_plain(x, dt, a, bm, cm,
                                              state_dt=dt), None, reps)}


def ssd_bwd_bound(b: int, L: int, h: int, g: int, n: int, p: int,
                  nbytes_el: int = 2):
    """x, dy, B, C and the fp32 dt read and dx, dB, dC and the fp32 d(dt)
    written once (a and da negligible); 14*N*P operations per step and
    head (the state's update and readout recomputed, the adjoint's update,
    dC, dx, dB and <G_t, s_{t-1}>)."""
    nbytes = nbytes_el * (3 * b * L * h * p + 4 * b * L * g * n) \
        + 8 * b * L * h
    return roofline(nbytes, 14 * n * p * L * b * h)


def time_ssd_bwd(torch, b: int, L: int, reps: int) -> dict:
    """ssd_scan's backward at zamba2-1.2b's heads (64 of P 64, one group of
    N 64), bf16, B x L steps, as its training step calls it: x, B and C
    strided views of one xbc buffer, fp32 softplus dt, seeded bf16 dy.
    Against its plain version; no PyTorch call computes it.  ``passes``:
    each of its kernels' device time and events a call (a sequence of one
    chunk launches three kernels, a longer one five)."""
    from repro_torch.kernels.ssd_scan.ops import (ssd_scan_bwd,
                                                  ssd_scan_bwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(44)
    bf = torch.bfloat16
    di = 64 * 64
    xbc = torch.randn((b, L, di + 2 * 64), generator=gen, device="cuda")
    xbc[..., di:] *= 0.3
    xbc = xbc.to(bf)
    x = xbc[..., :di].reshape(b, L, 64, 64)
    bm = xbc[..., di:di + 64].reshape(b, L, 1, 64)
    cm = xbc[..., di + 64:].reshape(b, L, 1, 64)
    dt = torch.nn.functional.softplus(
        torch.randn((b, L, 64), generator=gen, device="cuda"))
    a = -torch.ones(64, device="cuda")
    dy = _randn(torch, gen, (b, L, 64, 64), bf)
    args = (x, dt, a, bm, cm, dy)
    err, rel = check_ssd_bwd(f"ssd_scan_bwd at B={b} L={L}", "bfloat16",
                             ssd_scan_bwd(*args), ssd_scan_bwd_plain(*args))
    bound, by = ssd_bwd_bound(b, L, 64, 1, 64, 64)
    return {"shape": f"B {b}, L {L}, 64 heads of P 64, N 64, G 1, bf16, "
                     "strided xbc views, fp32 dt",
            "max_abs_err": err, "max_rel_err": rel, "bound_ms": bound,
            "bound_by": by,
            **time_all(torch, lambda: ssd_scan_bwd(*args),
                       lambda: ssd_scan_bwd_plain(*args), None, reps),
            "passes": pass_ms(torch, lambda: ssd_scan_bwd(*args), reps)}


def dryrun_train_plan(arch: str = TRAIN_ARCH, batch: int = TRAIN_BATCH,
                      seq: int = TRAIN_SEQ) -> dict:
    """The dry-run's plan of the training cell at the smoke's own shape
    on one card (``launch.dryrun.plan_cell`` at mesh sizes data 1 x model
    1; its fake trace on the CPU), with the argument tensors' bytes each
    rounded up to ``ALLOC_ROUND`` as the card's allocator rounds them."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    cfg, sizes = get_config(arch), {"data": 1, "model": 1}
    shape = ShapeSpec("smoke", seq, batch, "train")
    plan = dryrun.plan_cell(cfg, shape, sizes)
    args = dryrun.cell_args(cfg, shape, sizes, fsdp=plan["fsdp"])
    plan["argument_bytes_rounded"] = sum(
        -(-dryrun.leaf_bytes(sizes, leaf) // ALLOC_ROUND) * ALLOC_ROUND
        for leaf in dryrun.arg_leaves(args))
    return plan


def card_bytes(torch) -> tuple[int, int]:
    """(bytes the caching allocator has handed out, bytes its callers
    asked for): ``memory_allocated`` and ``requested_bytes.all.current``."""
    stats = torch.cuda.memory_stats()
    if "requested_bytes.all.current" not in stats:
        fail("the allocator reports no requested_bytes")
    return (torch.cuda.memory_allocated(),
            stats["requested_bytes.all.current"])


def dryrun_against_card(plan: dict, allocated: int, requested: int,
                        temp_peak: int, out: dict) -> dict:
    """The dry-run's plan beside what the card held and took: its
    argument bytes against the bytes requested for the parameters,
    moments and first batch (equal, to the byte) and the bytes allocated
    for them (each tensor rounded up to ``ALLOC_ROUND``, or more where
    the allocator hands out a cached block without splitting it), its
    roofline time beside ``train_bound_ms`` and the measured step, its
    temporaries' estimate beside the measured peak."""
    mem, roof = plan["memory"], plan["roofline"]
    raw, n = mem["argument_bytes"], mem["argument_tensors"]
    if requested != raw or allocated < plan["argument_bytes_rounded"]:
        fail(f"dry-run: {requested} bytes requested and {allocated} "
             f"allocated for the arguments, the plan's {raw} "
             f"({plan['argument_bytes_rounded']} rounded) over {n} tensors")
    return {"argument_bytes": raw, "argument_tensors": n,
            "requested_bytes": requested,
            "argument_bytes_rounded": plan["argument_bytes_rounded"],
            "allocated_bytes": allocated,
            "allocated_minus_rounded": allocated
            - plan["argument_bytes_rounded"],
            "within_rounding": allocated - raw <= ALLOC_ROUND * n,
            "roofline_ms": (roof["t_compute_s"] + roof["t_memory_s"]) * 1e3,
            "t_compute_ms": roof["t_compute_s"] * 1e3,
            "t_memory_ms": roof["t_memory_s"] * 1e3,
            "train_bound_ms": out["bound_ms"],
            "step_ms_after_first": out["step_ms_after_first"],
            "temp_bytes_estimate": mem["temp_bytes"],
            "temp_peak_bytes_measured": temp_peak,
            "flops_per_device": plan["flops_per_device"],
            "useful_flops_ratio": plan["useful_flops_ratio"],
            "trace_s": plan["trace_s"]}


def train_qwen3(torch, np, plan: dict | None = None) -> dict:
    """The training phase's qwen3-1.7b check: ``train_steps`` at B
    TRAIN_BATCH x S TRAIN_SEQ for TRAIN_STEPS steps, held to the dry-run's
    ``plan`` of the cell (``dryrun_train_plan``, made here when not
    given)."""
    if plan is None:
        plan = dryrun_train_plan()
    out, state = train_steps(torch, np, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
                             plan=plan)
    del state
    torch.cuda.empty_cache()
    return out


def train_launches(cfg) -> dict:
    """Kernel launches a training step with remat must make: per GQA
    decoder layer flash_attention's backward once and its forward twice
    (the forward and remat's recomputation), but once in each of the
    ``first_dense_layers`` dense layers before the MoE stack, which run
    outside remat as the reference's unscanned layers do (no GQA decoder
    of the registry has any: the term counts for an MoE one); none in an
    MLA decoder, whose attention is plain torch as the reference's; per
    Mamba2 layer ssd_scan twice and ssd_scan_bwd once; per application of
    the hybrid's shared attention block, which runs outside remat as in
    the reference, flash_attention and its backward once each; whisper's
    backward once per attention (an encoder layer's self attention, a
    decoder layer's self and cross), its forward twice in the decoder
    layers, which run under remat, and once in the encoder, which does
    not (the reference's ``encode`` is not checkpointed either)."""
    from repro_torch.models.blocks import segments
    if cfg.family == "decoder":
        if cfg.attn_kind != "gqa":
            return {"flash_attention": 0, "flash_attention_bwd": 0}
        return {"flash_attention": 2 * cfg.n_layers - cfg.first_dense_layers,
                "flash_attention_bwd": cfg.n_layers}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.enc_layers + 4 * cfg.n_layers,
                "flash_attention_bwd": cfg.enc_layers + 2 * cfg.n_layers}
    apps = sum(1 for _, end in segments(cfg)
               if cfg.attn_every and end < cfg.n_layers)
    return {"ssd_scan": 2 * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers,
            "flash_attention": apps, "flash_attention_bwd": apps}


def train_bound_ms(params: int, tokens: int) -> float:
    """A training step's least time: 8 x params x tokens operations (the
    forward, remat's second forward and the backward's two products) at
    989 TFLOP/s, plus AdamW's ~22 bytes a parameter (bf16 weight and
    gradient read, weight written, fp32 moments read and written) at
    3.35 TB/s."""
    return (8 * params * tokens / BF16_FLOP_S
            + 22 * params / HBM_BYTES_PER_S) * 1e3


def learnable_batch(np, vocab: int, batch: int, seq: int,
                    seed: int = 0) -> dict:
    """B x S tokens with their next tokens as labels, from a stream a model
    can learn: every token has one fixed successor (a permutation of the
    vocabulary drawn from ``default_rng(seed)``), each row starting at a
    random token."""
    rng = np.random.default_rng(seed)
    succ = rng.permutation(vocab)
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, batch)
    for t in range(seq):
        toks[:, t + 1] = succ[toks[:, t]]
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def train_steps(torch, np, batch: int, seq: int, steps: int,
                arch: str = TRAIN_ARCH, fixed: dict | None = None,
                plan: dict | None = None, layers: int | None = None):
    """``arch`` (qwen3-1.7b by default) at full width and depth (or
    ``layers`` deep) in bf16 (seeded weights): ``steps`` steps of ``make_train_step(remat=True)``
    with the reference's AdamW defaults on batch x seq batches from
    ``TokenPipeline``, or on the one batch ``fixed`` repeated, whose loss
    must then fall from the first step to the last.  Launch counts are
    zeroed just before each step and read just after; they must be
    ``train_launches``'.  The losses and grad norms must be finite and the
    moments fp32.  Given the dry-run's ``plan`` of the cell, the first
    batch goes to the card with the parameters and moments, and the bytes
    then allocated are held to it (``dryrun_against_card``).  Returns the
    report (ms a step against ``train_bound_ms``, the peak memory) and the
    run's state, ``(step, params, opt, pipe)``, for a caller that goes on
    stepping."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineState, TokenPipeline
    from repro_torch.models import init_model
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.training.tree import leaves
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base, base_requested = card_bytes(torch)
    params = init_model(cfg, 0, compute_device="cuda")
    opt = init_opt_state(params)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch,
                         PipelineState(seed=0, rank=0, world=1))
    first = None
    if plan is not None:
        first = {k: torch.as_tensor(v, device="cuda") for k, v in (
            pipe.next_batch() if fixed is None else fixed).items()}
        torch.cuda.synchronize()
        allocated, requested = card_bytes(torch)
        allocated, requested = allocated - base, requested - base_requested
    step = make_train_step(cfg, AdamWConfig(), remat=True,
                           compute_device="cuda")
    want = train_launches(cfg)
    losses, gnorms, step_ms, total = [], [], [], collections.Counter()
    for i in range(steps):
        if i == 0 and first is not None:
            tokens = first
        else:
            tokens = pipe.next_batch() if fixed is None else fixed
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, tokens)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        total.update(counts)
        if any(counts[k] != v for k, v in want.items()):
            fail(f"training {arch} step {i}: launches {counts}, want "
                 f"{want} a step")
    moments = leaves(opt["m"]) + leaves(opt["v"])
    if not (all(math.isfinite(x) for x in losses + gnorms)
            and all(m.dtype == torch.float32 for m in moments)
            and int(opt["step"]) == steps
            and (fixed is None or losses[-1] < losses[0])):
        fail(f"training {arch}: losses {losses}, grad norms {gnorms}, "
             f"moment dtypes {set(str(m.dtype) for m in moments)}, step "
             f"{int(opt['step'])}")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "full_n_layers": get_config(arch).n_layers,
           "params": cfg.param_count(), "param_dtype": cfg.param_dtype,
           "batch": batch, "seq": seq, "steps": steps,
           "stream": "one fixed learnable batch" if fixed is not None
           else "TokenPipeline",
           "remat": True, "losses": losses, "grad_norms": gnorms,
           "step_ms": step_ms,
           "step_ms_after_first": sum(step_ms[1:]) / (len(step_ms) - 1),
           "bound_ms": train_bound_ms(cfg.param_count(), batch * seq),
           "launches_per_step": want, "launches": dict(total),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 1e9}
    if plan is not None:
        out["dryrun"] = dryrun_against_card(
            plan, allocated, requested,
            torch.cuda.max_memory_allocated() - base - allocated, out)
    return out, (step, params, opt, pipe)


def train_zamba2(torch, np) -> dict:
    """The ssm/hybrid training phase: zamba2-1.2b at full width and depth
    in bf16, ``train_steps`` at B TRAIN_BATCH x S TRAIN_SEQ for
    SSM_TRAIN_STEPS steps on one ``learnable_batch`` repeated: 76 ssd_scan
    (38 layers, each recomputed under remat), 38 ssd_scan_bwd and 6
    flash_attention and flash_attention_bwd launches a step (the shared
    block's 6 applications), a loss that falls, fp32 moments."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_TRAIN_ARCH)
    out, state = train_steps(
        torch, np, TRAIN_BATCH, TRAIN_SEQ, SSM_TRAIN_STEPS,
        arch=SSM_TRAIN_ARCH,
        fixed=learnable_batch(np, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ))
    del state
    torch.cuda.empty_cache()
    return out


def train_gemma3(torch, np) -> dict:
    """gemma3-1b's training at full width and depth in bf16, as
    ``train_zamba2``'s: GEMMA_TRAIN_STEPS steps at B TRAIN_BATCH x S
    TRAIN_SEQ on one ``learnable_batch`` repeated, 52 flash_attention (26
    layers, each recomputed under remat) and 26 flash_attention_bwd
    launches a step at head_dim 256 (the local layers with their 512-token
    window, which S 64 does not reach), a loss that falls, fp32 moments."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3_1b")
    out, state = train_steps(
        torch, np, TRAIN_BATCH, TRAIN_SEQ, GEMMA_TRAIN_STEPS,
        arch="gemma3_1b",
        fixed=learnable_batch(np, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ))
    del state
    torch.cuda.empty_cache()
    return out


def train_deepseek(torch, np) -> dict:
    """deepseek-v2-lite's training at full width in bf16, depth cut to
    MOE_TRAIN_LAYERS (its dense first layer and 3 MoE layers; the full
    depth's weights, gradients and moments do not fit one card):
    MOE_TRAIN_STEPS steps at B TRAIN_BATCH x S TRAIN_SEQ from
    TokenPipeline, finite losses, fp32 moments, no attention kernel
    launched (MLA is plain torch, as the reference's).  Its
    ``train_bound_ms`` counts every expert's parameters, not the 6 of 64
    a token is routed to."""
    out, state = train_steps(torch, np, TRAIN_BATCH, TRAIN_SEQ,
                             MOE_TRAIN_STEPS, arch=MOE_TRAIN_ARCH,
                             layers=MOE_TRAIN_LAYERS)
    del state
    torch.cuda.empty_cache()
    return out


def train_whisper(torch, np) -> dict:
    """whisper-tiny at full size (4 + 4 layers, d_model 384, 1,500 encoder
    frames, bf16) through the training launcher,
    ``launch.train.run(smoke=False, **WHISPER_TRAIN)`` with the reference's
    B 8 x S 64 and lr: an injected failure at step 30 must restore the
    vLSM checkpoint of step 20 (its pipeline cursor 21) once, and every
    loss must be finite and within WHISPER_LOSS_BAND of ln(vocab), the
    uniform prediction's (a guard against divergence only).  The loss is
    not required to fall: at 51,865 tokens the synthetic stream (next =
    3 tok + noise) cannot be learnt from 50 steps of 512 tokens, each
    token seen about once, nor does the reference's loss fall (PERF.md,
    PR 20); the mean of the first and of the last 5 losses is reported.
    The gradients this run takes are held to the CPU's by
    ``train_cross_check``.  Launch counts are zeroed just before the run
    and read just after:
    flash_attention, flash_attention_bwd and the checkpoint index's
    overlap_scan must have launched.  Reports every checkpoint's pages
    written of pages in all, the restore's segments, the index's stats and
    the store kernels' launches."""
    import shutil

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    ln_v = math.log(get_config("whisper_tiny").vocab_size)
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.run("whisper_tiny", smoke=False, ckpt_dir=str(ckpt),
                    compute_device="cuda", **WHISPER_TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = out["losses"]
    every, fail_at = WHISPER_TRAIN["ckpt_every"], WHISPER_TRAIN["fail_at"]
    restored = fail_at // every * every
    restores = out["restores"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    n_steps = WHISPER_TRAIN["steps"] + fail_at - restored
    # the first save writes every page; the same step saved again after
    # the restore, and the last, only the pages that changed
    saves = out["saves"]
    if not (len(saves) == 3
            and saves[0]["pages_written"] == saves[0]["pages_total"] > 0
            and [x["step"] for x in saves] == [restored, restored,
                                               WHISPER_TRAIN["steps"]]):
        fail(f"training whisper-tiny: checkpoints {saves}")
    if not (out["restarts"] == 1 and len(restores) == 1
            and restores[0]["step"] == restored
            and restores[0]["pipe_cursor"] == restored + 1
            and len(losses) == n_steps
            and all(abs(x - ln_v) < WHISPER_LOSS_BAND for x in losses)):
        fail(f"training whisper-tiny: restarts {out['restarts']}, restores "
             f"{restores}, {len(losses)} losses (want {n_steps}), losses "
             f"{min(losses)}..{max(losses)} against ln V {ln_v}")
    need = ("flash_attention", "flash_attention_bwd", "overlap_scan")
    if min(counts[k] for k in need) <= 0:
        fail(f"training whisper-tiny: a kernel never launched: {counts}")
    return {"wall_s": wall, "steps_run": len(losses), "losses": losses,
            "loss_first5": first, "loss_last5": last, "ln_vocab": ln_v,
            "restarts": out["restarts"], "restores": restores,
            "saves": saves, "final_ckpt": out["final_ckpt"],
            "index_stats": out["index_stats"], "launches": counts,
            "stragglers": out["stragglers"],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
            / 1e9}


def cross_setup(torch, np, arch: str):
    """(cfg, parameters on the CPU, batch) of ``arch``'s training
    cross-check: float32 at full width, depth as CROSS_TRAIN says, the
    parameters drawn from seed 0 on the CPU (both sides start from them,
    in either process), one batch of ``TokenPipeline`` (an encdec model's
    encoder frames seeded too, on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineState, TokenPipeline
    from repro_torch.models import init_model
    layers, b, seq, _ = CROSS_TRAIN[arch]
    cfg = get_config(arch).with_(param_dtype="float32")
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    params = init_model(cfg, 0, compute_device="cpu")
    batch = TokenPipeline(cfg.vocab_size, seq, b,
                          PipelineState(seed=1, rank=0, world=1)).next_batch()
    if cfg.family == "encdec":
        batch = {**batch, "encoder_embeds": torch.from_numpy(
            np.random.default_rng(1).standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
    return cfg, params, batch


def cross_steps(torch, cfg, params, batch, dev: str) -> tuple:
    """(loss, [(path, gradient)], parameters after 2 AdamW steps (lr
    3e-4), seconds) of ``train_loss`` on ``dev``: the first step takes the
    gradient just returned (``make_train_step`` would take it again from
    the same parameters and batch), the second is ``make_train_step``'s."""
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      init_opt_state, make_train_step)
    from repro_torch.training.step import value_and_grad
    from repro_torch.training.tree import leaf_paths, leaves
    t0 = time.perf_counter()
    if "encoder_embeds" in batch:
        batch = {**batch, "encoder_embeds": batch["encoder_embeds"].to(dev)}
    opt_cfg = AdamWConfig()
    loss, grads = value_and_grad(cfg, params, batch, compute_device=dev)
    opt = init_opt_state(params)
    params, opt, _ = adamw_update(opt_cfg, params, grads, opt)
    params, opt, _ = make_train_step(cfg, opt_cfg, compute_device=dev)(
        params, opt, batch)
    return (float(loss), leaf_paths(grads), leaves(params),
            time.perf_counter() - t0)


def scan_sequential(torch, x, dt, a, b, c):
    """y and the final state of ssd_scan's recurrence taken one step at a
    time in the inputs' dtype, ``s_t = exp(dt_t a) s_{t-1} + dt_t B_t
    x_t^T``, ``y_t = C_t s_t``: the float64 run's scan (autograd takes its
    gradient), independent of the chunked form and the hand-written
    adjoint."""
    bsz, L, h, p = x.shape
    rep = h // b.shape[2]
    bf, cf = b.repeat_interleave(rep, 2), c.repeat_interleave(rep, 2)
    s = x.new_zeros((bsz, h, b.shape[3], p))
    ys = []
    for t in range(L):
        s = (torch.exp(dt[:, t] * a)[..., None, None] * s
             + (dt[:, t, :, None, None] * bf[:, t, :, :, None])
             * x[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], s))
    return torch.stack(ys, 1), s


class float64_tier:
    """The port's CPU tier in float64, for the float64 run of a training
    cross-check: ``Tensor.float()`` leaves a float64 tensor as it is (the
    norms', the ssm block's dt, the loss's and AdamW's casts to fp32, whose
    moments alone stay fp32), and the ssm block's scan is
    ``scan_sequential``.  Only the worker process and
    ``scripts/probe.py`` enter it."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import repro_torch.models.ssd as ssd_mod
        torch = self.torch
        self.saved = f32, _ = torch.Tensor.float, ssd_mod.ssd_scan
        torch.Tensor.float = lambda t, *a, **k: (
            t if t.dtype is torch.float64 else f32(t, *a, **k))
        ssd_mod.ssd_scan = lambda x, dt, a, b, c, **_: scan_sequential(
            torch, x, dt, a, b, c)
        return self

    def __exit__(self, *exc):
        import repro_torch.models.ssd as ssd_mod
        self.torch.Tensor.float, ssd_mod.ssd_scan = self.saved
        return False


def cross_train_cpu(arch: str) -> dict:
    """The CPU side of ``arch``'s training cross-check, computed in the
    spawned worker beside the card's phases: ``cross_steps`` on the CPU
    tier, and, where CROSS_TRAIN asks for it, in float64
    (``float64_tier``); tensors as numpy arrays (the float64 run's rounded
    to float32, far below the tolerances), and under ``worker`` the task's
    wall clock at its start and end and its set-up seconds."""
    import numpy as np
    import torch

    from repro_torch.training.tree import tree_map
    start = time.time()

    def arrays(res):
        loss, grads, params, secs = res
        return (loss, [(path, g.to(torch.float32).numpy())
                       for path, g in grads],
                [p.to(torch.float32).numpy() for p in params], secs)
    cfg, params, batch = cross_setup(torch, np, arch)
    setup_s = time.time() - start
    out = {"cpu": arrays(cross_steps(
        torch, cfg, tree_map(lambda p: p.clone(), params), batch, "cpu"))}
    if CROSS_TRAIN[arch][3]:
        with float64_tier(torch):
            res = cross_steps(torch, cfg,
                              tree_map(lambda p: p.double(), params), batch,
                              "cpu")
        out["float64"] = arrays(res)
    out["worker"] = {"start": start, "setup_s": setup_s, "end": time.time()}
    return out


def params_apart(torch, got, want) -> tuple[float, int, int, list]:
    """(max |got - want|, elements apart by more than 1e-5, elements, each
    leaf's count apart) over two lists of parameters (``want`` numpy)."""
    worst, apart, n, per_leaf = 0.0, 0, 0, []
    for c, h in zip(got, want, strict=True):
        d = (c - torch.from_numpy(h).to(c.device)).abs()
        worst = max(worst, float(d.max()))
        k = int((d > 1e-5).sum())
        per_leaf.append(k)
        apart += k
        n += d.numel()
    return worst, apart, n, per_leaf


def grads_apart(torch, got, want) -> tuple[float, float, str]:
    """(largest max |got - want| over the leaf's max |want|, largest
    relative norm difference, the leaf of the first) over two lists of
    (path, gradient) (``want``'s numpy)."""
    worst, worst_n, where = 0.0, 0.0, ""
    for (path, g), (_, h) in zip(got, want, strict=True):
        h = torch.from_numpy(h).to(g.device)
        err = float((g - h).abs().max()) / max(float(h.abs().max()), 1e-30)
        n_err = abs(float(g.norm()) - float(h.norm())) / max(
            float(h.norm()), 1e-30)
        if err > worst:
            worst, where = err, "/".join(path)
        worst_n = max(worst_n, n_err)
    return worst, worst_n, where


def train_cross_check(torch, np, arch: str,
                      cpu: dict | None = None) -> dict:
    """``arch`` in float32 at full width, depth as CROSS_TRAIN says, card
    against the CPU tier from the same weights on one batch (``cpu``:
    ``cross_train_cpu``'s result from the worker; computed here when it is
    None): ``train_loss`` within 1e-5 of the CPU's relatively; each
    gradient leaf within 1e-3 of its largest |element| and its norm within
    1e-4 relatively (fp32 sums over up to 151,936 logits, 6,144 features
    or 1,500 frames taken in another order on each side); then the
    parameters after 2 AdamW steps: no element apart by more than 4 lr
    (two steps each move a parameter by at most ~lr: where a gradient's
    sign is rounding noise, Adam's normalised step can take either sign)
    and at most 1e-3 of the elements apart by more than 1e-5.  Where
    CROSS_TRAIN asks for a float64 run, the card's parameters are also held
    to it: no element apart from it by more than 4 lr, and no more
    elements apart by more than 1e-5 than the CPU tier's (or 1e-3 of
    them): the card no further from exact arithmetic than the CPU tier
    (mamba2-130m's 24 layers, where the fp32 rounding of either side is
    amplified the most).  whisper-tiny's run holds its
    encoder, cross attention and the backward kernel's non-causal shapes
    to the CPU's autograd."""
    from repro_torch.training import AdamWConfig
    from repro_torch.training.tree import tree_map
    if cpu is None:
        cpu = cross_train_cpu(arch)
    cfg, params, batch = cross_setup(torch, np, arch)
    c_loss, c_grads, c_params, c_s = cross_steps(
        torch, cfg, tree_map(lambda p: p.to("cuda"), params), batch, "cuda")
    del params
    h_loss, h_grads, h_params, h_s = cpu["cpu"]
    out: dict = {"layers": cfg.n_layers, "batch": CROSS_TRAIN[arch][1],
                 "seq": CROSS_TRAIN[arch][2], "loss": c_loss,
                 "loss_cpu": h_loss}
    if not abs(c_loss - h_loss) <= 1e-5 * abs(h_loss):
        fail(f"training cross-check {arch}: loss {c_loss} vs {h_loss}")
    worst_g, worst_n, where = grads_apart(torch, c_grads, h_grads)
    if worst_g > 1e-3 or worst_n > 1e-4:
        fail(f"training cross-check {arch}: grad {where} max |err| "
             f"{worst_g} of its max, norm {worst_n} relative (worst leaf)")
    lr = AdamWConfig().lr
    worst_p, apart, n, per_leaf = params_apart(torch, c_params, h_params)
    out.update({"grad_max_rel_err": worst_g, "grad_norm_rel_err": worst_n,
                "params_max_abs_err": worst_p, "params_apart": apart,
                "params_total": n, "params_apart_by_leaf": {
                    "/".join(path): k
                    for (path, _), k in zip(c_grads, per_leaf) if k},
                "card_s": c_s, "cpu_s": h_s})
    if "float64" in cpu:
        t_loss, t_grads, t_params, t_s = cpu["float64"]
        cpu_dev = [torch.from_numpy(p).cuda() for p in h_params]
        cpu_grads = [(path, torch.from_numpy(g).cuda())
                     for path, g in h_grads]
        tw, t_apart, _, _ = params_apart(torch, c_params, t_params)
        hw, h_apart, _, _ = params_apart(torch, cpu_dev, t_params)
        out["float64"] = {
            "loss": t_loss, "float64_s": t_s,
            "card_grad_max_rel_err": grads_apart(torch, c_grads,
                                                 t_grads)[0],
            "cpu_grad_max_rel_err": grads_apart(torch, cpu_grads,
                                                t_grads)[0],
            "card_params_max_abs_err": tw, "card_params_apart": t_apart,
            "cpu_params_max_abs_err": hw, "cpu_params_apart": h_apart}
        del cpu_dev, cpu_grads
        if tw > 4 * lr or t_apart > max(1e-3 * n, h_apart):
            fail(f"training cross-check {arch}: parameters after 2 steps "
                 f"max |err| {tw} from the float64 run's (bound {4 * lr}), "
                 f"{t_apart} of {n} apart by > 1e-5 (the CPU tier's: "
                 f"{h_apart}): {json.dumps(out)}")
    if worst_p > 4 * lr or apart > 1e-3 * n:
        fail(f"training cross-check {arch}: parameters after 2 steps max "
             f"|err| {worst_p} (bound {4 * lr}), {apart} of {n} apart by > "
             f"1e-5: {json.dumps(out)}")
    return out


def bwd_bound(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
              causal: bool, nbytes_el: int = 2, window: int | None = None):
    """q, k, v, o, dO read and dq, dk, dv written once, lse read once (fp32);
    10*D operations per unmasked (query, key) pair (Q.K^T and dO.V^T
    recomputed, dV, dK, dQ)."""
    pairs = attn_pairs(sq, sk, causal, window) * b * hq
    nbytes = nbytes_el * (4 * b * hq * sq * d + 4 * b * hkv * sk * d) \
        + 4 * b * hq * sq
    return roofline(nbytes, 10 * d * pairs)


def time_flash_bwd(torch, b: int, s: int, reps: int, hq: int = 16,
                   hkv: int = 8, d: int = 128, sk: int | None = None,
                   causal: bool = True, window: int | None = None) -> dict:
    """flash_attention's backward, bf16, at B x S queries (over ``sk``
    keys, S by default; causal, or not; with a window) with qwen3-1.7b's
    heads by default (seeded inputs; o and lse from the forward kernel),
    beside its plain version and SDPA's backward (``enable_gqa``,
    ``torch.autograd.grad`` of one forward, with an explicit causal and
    window mask for a window; the library yardstick only);
    ``kernel_device_ms`` splits the kernel's device time between its two
    kernels."""
    from repro_torch.kernels.flash_attention.ops import (
        _forward, flash_attention_bwd, flash_attention_bwd_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    sk = s if sk is None else sk
    q = _randn(torch, gen, (b, hq, s, d), torch.bfloat16)
    k, v = (_randn(torch, gen, (b, hkv, sk, d), torch.bfloat16)
            for _ in range(2))
    do = _randn(torch, gen, (b, hq, s, d), torch.bfloat16)
    o, lse = _forward(q, k, v, causal, window, None, want_lse=True)
    args = (q, k, v, o, lse, do)
    kw = {"causal": causal, "window": window}
    err = max(check_close(f"flash_attention_bwd at B={b} Sq={s} Sk={sk} "
                          f"H={hq}/{hkv} D={d} causal={causal} "
                          f"window={window} {name}",
                          "flash_attention_bwd", g, w)
              for name, g, w in zip(("dq", "dk", "dv"),
                                    flash_attention_bwd(*args, **kw),
                                    flash_attention_bwd_plain(*args, **kw)))
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    if window is None:
        lib_out = F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=causal, enable_gqa=hq != hkv)
    else:
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        lib_out = F.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=mask, enable_gqa=hq != hkv)
    bound, by = bwd_bound(b, hq, hkv, s, sk, d, causal, window=window)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
    split = {(re.search(r"bwd_\w+(<[^>]*>)?", n) or [n[:60]])[0]:
             us / reps / 1e3 for n, us, _ in kernel_times_us(prof)}
    return {"shape": f"B {b}, BH {hq} (kv {hkv}), Sq {s}, Sk {sk}, D {d}, "
                     f"bf16, {'causal' if causal else 'non-causal'}"
                     + (f", window {window}" if window else ""),
            "pairs": attn_pairs(s, sk, causal, window) * b * hq,
            "max_abs_err": err, "bound_ms": bound, "bound_by": by,
            "kernel_device_ms": split,
            **time_all(torch, lambda: flash_attention_bwd(*args, **kw),
                       lambda: flash_attention_bwd_plain(*args, **kw),
                       lambda: torch.autograd.grad(lib_out, (qr, kr, vr), do,
                                                   retain_graph=True),
                       reps)}


def time_flash_cross(torch, sq: int, sk: int, reps: int, h: int = 6,
                     d: int = 64) -> dict:
    """flash_attention non-causal at whisper-tiny's shapes, B 1, bf16: its
    encoder (Sq = Sk = 1,500) and its cross attention (Sq prompt tokens
    over Sk = 1,500 frames), beside SDPA."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(47)
    q = _randn(torch, gen, (1, h, sq, d), torch.bfloat16)
    k, v = (_randn(torch, gen, (1, h, sk, d), torch.bfloat16)
            for _ in range(2))
    err = check_close(f"flash_attention at Sq={sq} Sk={sk} H={h} D={d}",
                      "flash_attention",
                      flash_attention(q, k, v, causal=False),
                      flash_attention_plain(q, k, v, causal=False))
    bound, by = roofline(2 * (2 * h * sq + 2 * h * sk) * d,
                         4 * d * sq * sk * h)
    return {"shape": f"BH {h}, Sq {sq}, Sk {sk}, D {d}, bf16, non-causal",
            "max_abs_err": err, "bound_ms": bound, "bound_by": by,
            **time_all(torch, lambda: flash_attention(q, k, v, causal=False),
                       lambda: flash_attention_plain(q, k, v, causal=False),
                       lambda: F.scaled_dot_product_attention(q, k, v),
                       reps)}


def gemma3_timings(torch, s_serve: int) -> dict:
    """gemma3-1b's attention kernels at its shapes (4 query heads over 1 kv
    head of 256, bf16): flash_attention at its serving prefill (S of the
    longest prompt) and at 4,096 tokens with its 512-token window and
    global; paged_attention at its serving decode (the longest prompt's
    last position, global and windowed alike there) and at 4,096 tokens of
    a 4,096-token cache with the window and global.  The windowed paged
    call's bound is the window's rows: its time beside the global call's
    shows whether the kernel reads only the window."""
    w, n = GEMMA_WINDOW, LONG_PREFILL
    return {
        "flash_prefill": time_flash(torch, s_serve, 40, 4, 1, 256),
        "flash_4096_window": time_flash(torch, n, 10, 4, 1, 256, w),
        "flash_4096_global": time_flash(torch, n, 10, 4, 1, 256),
        "paged_decode": time_paged(torch, s_serve + DECODE_TOKENS - 1, 200,
                                   4, 1, 256, w),
        "paged_4096_window": time_paged(torch, n, 200, 4, 1, 256, w, n),
        "paged_4096_global": time_paged(torch, n, 200, 4, 1, 256, None, n)}


def profile_serve(torch, np, arch: str) -> dict:
    """A 2-request full-size serving run of ``arch`` under torch.profiler:
    the device's busy time by kernel against the run's wall time.  Only the
    device's activity is recorded: with the host's ~2,000 ops a decode
    token too, sorting the events took ~45 s a model (gemma3-1b's run
    itself 2.6 s)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.run(arch, smoke=False, n_requests=PROFILE_REQUESTS,
                  compute_device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_times_us(prof)
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    return {"profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall,
            "top_device": [{"name": n[:90], "ms": us / 1e3, "count": c}
                           for n, us, c in rows[:15]]}


# ------------------------------------------------------------------- main
# ------------------------------------------------------- distributed (7)
DIST_RANKS = 4
DIST_JOIN_S = 300              # the time limit of the phase's ranks
# sequence-sharded decode at decode_32k's cache length, B 8, in four slices:
# arch -> (query heads, kv heads, head_dim)
DIST_DECODE_HEADS = {"qwen3_1_7b": (16, 8, 128), "gemma3_1b": (4, 1, 256)}
DIST_DECODE = (8, 32768)
# the last live token of each sequence: two end in the first slice (ranks
# 1-3 hold none of their tokens), the others in every later slice
DIST_DECODE_POS = (100, 8191, 8192, 12000, 16383, 20000, 24576, 32767)
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 4, 4, (2, 189)   # qwen3-1.7b's 28 layers
COMPRESS_BATCH = (8, 64)       # whisper-tiny's step: B x S tokens a rank
COMPRESS_SLACK = 0.51          # of the largest per-rank scale (see below)
# checkpoints of whisper-tiny's train state before the restore: three, as
# the training phase's run writes, so that the store's index compacts
CKPT_STEPS = 3


def _rank_result(out: str, name: str, obj) -> None:
    (Path(out) / f"{name}.json").write_text(json.dumps(obj))


def _decode_slices(torch, b, t, hkv, d, dtype, slices):
    """K and V slices ``slices`` (of 4 of t / 4 tokens) of a seeded decode
    cache [B, T, Hkv, D]: slice r from its own generator, so a rank draws
    its own slice and rank 0 the whole cache, the same numbers."""
    t_loc = t // DIST_RANKS
    out = []
    for which in (0, 1):
        parts = []
        for r in slices:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(7000 + 10 * r + which)
            parts.append(_randn(torch, gen, (b, t_loc, hkv, d), dtype))
        out.append(torch.cat(parts, dim=1) if len(parts) > 1 else parts[0])
    return out


def _mesh(torch, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", tuple(shape), mesh_dim_names=tuple(axes))


def _qwen3_stage(torch, cfg):
    """stage_fn of the pipeline: the stage's decoder blocks in order over
    [mb, S, D] activations (the model's own block forward, flash_attention
    inside), every qwen3 layer global."""
    from repro_torch.models.blocks import (_decoder_block_fwd, layer_meta,
                                           layer_params)
    from repro_torch.training.tree import leaves
    theta, window = layer_meta(cfg)[0]
    mb, s = PIPE_MB
    positions = torch.arange(s, device="cuda")[None].expand(mb, s)

    def stage_fn(p, h):
        for j in range(leaves(p)[0].shape[0]):
            h = _decoder_block_fwd(cfg, layer_params(p, j), h, positions,
                                   theta, window, dense=False)[0]
        return h
    return stage_fn


def dist_nccl_rank(rank, world, out, t_spawn):
    """Phase 7a, one NCCL rank on cuda:0, over a (1, 1, 1) mesh: the
    sequence-sharded decode over the whole cache is paged_attention itself,
    bitwise; compressed_psum of one rank is dequantize(quantize(x)),
    bitwise; pipeline_apply of one stage is the stage, bitwise."""
    import torch
    from repro_torch.distributed.compression import (
        compressed_psum, dequantize_int8, quantize_int8)
    from repro_torch.distributed.flash_decode import seq_sharded_decode_attn
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels.paged_attention import paged_attention
    t_start = time.time()
    torch.cuda.set_device(0)
    mesh = _mesh(torch, (1, 1, 1), ("pod", "pipe", "model"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    hq, hkv, d = DIST_DECODE_HEADS["qwen3_1_7b"]
    b, t = DIST_DECODE[0], DIST_DECODE[1] // DIST_RANKS
    q = _randn(torch, gen, (b, hq, d), torch.bfloat16)
    k, v = (_randn(torch, gen, (b, t, hkv, d), torch.bfloat16)
            for _ in range(2))
    pos = torch.tensor([min(p, t - 1) for p in DIST_DECODE_POS],
                       device="cuda")
    got = seq_sharded_decode_attn(mesh, q, k, v, pos)
    want = paged_attention(q, k, v, torch.arange(b, dtype=torch.int32,
                                                 device="cuda")[:, None],
                           (pos + 1).to(torch.int32))
    if not torch.equal(got, want):
        fail("NCCL: the one-rank sequence-sharded decode is not "
             "paged_attention's output")
    x = _randn(torch, gen, (1 << 20,), torch.float32)
    if not torch.equal(compressed_psum(x, mesh, "pod"),
                       dequantize_int8(*quantize_int8(x))):
        fail("NCCL: compressed_psum of one rank is not its round trip")
    w = _randn(torch, gen, (64, 64), torch.float32, 0.125)
    xs = _randn(torch, gen, (3, 2, 64), torch.float32)

    def stage(p, h):
        return torch.tanh(h @ p)
    if not torch.equal(pipeline_apply(mesh, stage, w, xs, n_micro=3),
                       torch.stack([stage(w, h) for h in xs])):
        fail("NCCL: pipeline_apply of one stage is not the stage")
    _rank_result(out, "nccl", {"backend": "nccl", "ranks": world,
                               "decode_bitwise": True, "psum_bitwise": True,
                               "pipeline_bitwise": True,
                               "startup_s": t_start - t_spawn,
                               "wall_s": time.time() - t_start})


def _dist_decode(torch, np, rank, out):
    """Sequence-sharded decode at qwen3-1.7b's and gemma3-1b's decode heads
    over decode_32k's 32,768 cache tokens, B 8, a slice of 8,192 a rank,
    bf16 and fp32: one paged_attention launch a rank and call, the result
    against paged_attention over the whole cache and its plain version on
    rank 0."""
    from repro_torch import kernels
    from repro_torch.distributed.flash_decode import seq_sharded_decode_attn
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    mesh = _mesh(torch, (DIST_RANKS,), ("model",))
    b, t = DIST_DECODE
    pos = torch.tensor(DIST_DECODE_POS, device="cuda")
    rows = {}
    for arch, (hq, hkv, d) in DIST_DECODE_HEADS.items():
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(7100)
            q = _randn(torch, gen, (b, hq, d), dtype)
            k_loc, v_loc = _decode_slices(torch, b, t, hkv, d, dtype, [rank])
            kernels.reset_launch_counts()
            got = seq_sharded_decode_attn(mesh, q, k_loc, v_loc, pos)
            launches = kernels.launch_counts()["paged_attention"]
            if launches != 1:
                fail(f"decode {arch} {dt}: paged_attention launched "
                     f"{launches} times on rank {rank}, not once")
            if rank:
                continue
            del k_loc, v_loc
            k, v = _decode_slices(torch, b, t, hkv, d, dtype,
                                  range(DIST_RANKS))
            args = (q, k, v, torch.arange(b, dtype=torch.int32,
                                          device="cuda")[:, None],
                    (pos + 1).to(torch.int32))
            what = f"sequence-sharded decode {arch} {dt}"
            rows[f"{arch}_{dt}"] = {
                "vs_kernel_whole_cache": check_close(
                    f"{what} against paged_attention over the whole cache",
                    "paged_attention", got, paged_attention(*args)),
                "vs_plain": check_close(
                    f"{what} against the plain version", "paged_attention",
                    got, paged_attention_plain(*args)),
                "launches_per_rank": launches,
                "kv_bytes_per_rank": 2 * b * (t // DIST_RANKS) * hkv * d
                * dtype.itemsize}
            del k, v, args
    if rank == 0:
        _rank_result(out, "decode", rows)
    torch.cuda.empty_cache()


def _dist_compress(torch, np, rank, out):
    """whisper-tiny's bf16 gradients of one step on this rank's batch,
    widened to fp32 (as compress_tree widens them), through compress_tree
    and the int8 cross-pod mean.  The mean must equal, bitwise, rank 0's
    rank-order sum of every rank's dequantized payload over 4, and sit
    within COMPRESS_SLACK x the largest per-rank scale of each leaf of the
    uncompressed mean: compress_tree's rounding is the only lossy one (a
    half scale), the mean's requantization of its output gives back the
    same integers at a scale within fp32 rounding of the first."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineState, TokenPipeline
    from repro_torch.distributed import comm
    from repro_torch.distributed.compression import (
        compress_tree, cross_pod_mean_compressed, dequantize_int8,
        quantize_int8)
    from repro_torch.models import init_model
    from repro_torch.models.common import dtype_of
    from repro_torch.training.step import value_and_grad
    from repro_torch.training.tree import leaf_paths, tree_map
    mesh = _mesh(torch, (DIST_RANKS,), ("pod",))
    cfg = get_config("whisper_tiny")
    params = init_model(cfg, 0, compute_device="cuda")
    bsz, seq = COMPRESS_BATCH
    batch = TokenPipeline(cfg.vocab_size, seq, bsz, PipelineState(
        seed=1, rank=rank, world=DIST_RANKS)).next_batch()
    batch["encoder_embeds"] = torch.from_numpy(
        np.random.default_rng(rank).standard_normal(
            (bsz, cfg.enc_seq, cfg.d_model))).to("cuda", dtype_of(cfg))
    _, grads = value_and_grad(cfg, params, batch, compute_device="cuda")
    g32 = tree_map(lambda g: g.float(), grads)
    del params
    comp, _ = compress_tree(g32, {})
    wire = []
    gather = comm.all_gather

    def recording(x, mesh, axis):
        wire.append((str(x.dtype), x.numel()))
        return gather(x, mesh, axis)
    comm.all_gather = recording
    try:
        mean = cross_pod_mean_compressed(mesh, comp)
    finally:
        comm.all_gather = gather
    torch.cuda.synchronize()
    payload = sum(n for dt, n in wire if dt == "torch.int8")
    if not (len(wire) == 2 * len(leaf_paths(comp)) and all(
            dt == ("torch.int8", "torch.float32")[i % 2]
            for i, (dt, _) in enumerate(wire))):
        fail(f"compressed mean: gathered {wire[:4]}..., not int8 payloads "
             "beside fp32 scales")
    worst_slack, leaves = 0.0, 0
    flat_mean = dict(leaf_paths(mean))
    flat_raw = dict(leaf_paths(grads))     # bf16: half the bytes, exact
    for path, x in leaf_paths(comp):
        parts = comm.all_gather(x, mesh, "pod")
        raws = comm.all_gather(flat_raw[path], mesh, "pod").float()
        if rank:
            continue
        redo = dequantize_int8(*quantize_int8(parts[0]))
        for r in range(1, DIST_RANKS):
            redo = redo + dequantize_int8(*quantize_int8(parts[r]))
        redo = redo / DIST_RANKS
        if not torch.equal(redo, flat_mean[path]):
            fail(f"compressed mean {path}: not rank 0's rank-order sum")
        scale = max(float(quantize_int8(raws[r])[1])
                    for r in range(DIST_RANKS))
        err = float((flat_mean[path] - raws.mean(0)).abs().max())
        worst_slack = max(worst_slack, err / scale)
        leaves += 1
    if rank == 0:
        if not worst_slack <= COMPRESS_SLACK:
            fail(f"compressed mean: {worst_slack} scales from the "
                 "uncompressed mean")
        _rank_result(out, "compress", {
            "leaves": leaves, "elements": sum(
                x.numel() for _, x in leaf_paths(comp)),
            "int8_payload_elements_per_rank": payload,
            "worst_err_over_scale": worst_slack,
            "bound_over_scale": COMPRESS_SLACK, "bitwise_rank_order": True})
    torch.cuda.empty_cache()


def _dist_pipeline(torch, np, rank, out):
    """qwen3-1.7b's 28 blocks at full width as 4 stages of 7 in bf16, M 4
    micro-batches of 2 x 189 tokens of seeded activations, against
    unpipelined_reference on rank 0."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  unpipelined_reference)
    from repro_torch.models import init_model
    from repro_torch.models.common import dtype_of
    from repro_torch.training.tree import tree_map
    mesh = _mesh(torch, (PIPE_STAGES,), ("pipe",))
    cfg = get_config("qwen3_1_7b")
    layers = init_model(cfg, 0, compute_device="cuda")["layers"]
    per = cfg.n_layers // PIPE_STAGES
    stage_fn = _qwen3_stage(torch, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7200)
    x = _randn(torch, gen, (PIPE_MICRO, *PIPE_MB, cfg.d_model),
               dtype_of(cfg))
    mine = tree_map(lambda a: a[rank * per:(rank + 1) * per], layers)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = pipeline_apply(mesh, stage_fn, mine, x, n_micro=PIPE_MICRO)
    launches = kernels.launch_counts()["flash_attention"]
    if launches != per * PIPE_MICRO:
        fail(f"pipeline: flash_attention launched {launches} times on rank "
             f"{rank}, not {per * PIPE_MICRO}")
    if rank == 0:
        stacked = tree_map(lambda a: a.view(PIPE_STAGES, per, *a.shape[1:]),
                           layers)
        with torch.no_grad():
            want = unpipelined_reference(stage_fn, stacked, x)
        err = check_close("pipeline against unpipelined_reference",
                          "flash_attention", got, want)
        _rank_result(out, "pipeline", {
            "stages": PIPE_STAGES, "layers_per_stage": per,
            "micro_batches": PIPE_MICRO, "max_abs_err": err,
            "bitwise": bool(torch.equal(got, want)),
            "flash_launches_per_rank": launches})
    del layers, mine
    torch.cuda.empty_cache()


def ckpt_state(torch, steps: int):
    """whisper-tiny's train state (seeded bf16 parameters and fp32 AdamW
    moments) after ``steps`` checkpoint intervals, each moving every
    floating leaf by 0.001, as a training step changes every page: the
    same bits wherever it is built on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.training import init_opt_state
    from repro_torch.training.tree import leaves
    cfg = get_config("whisper_tiny")
    params = init_model(cfg, 3, compute_device="cuda")
    state = {"params": params, "opt": init_opt_state(params)}
    for _ in range(steps):
        for leaf in leaves(state):
            if leaf.is_floating_point():
                leaf.add_(0.001)
    return cfg, state


def save_ckpt(torch, root: Path) -> None:
    """The state's CKPT_STEPS checkpoints into an ``LSMCheckpointStore`` on
    the card (its index replays them when a rank opens it), then a marker
    file."""
    from repro_torch.checkpoint import LSMCheckpointStore
    store = LSMCheckpointStore(root, compute_device="cuda")
    for step in range(CKPT_STEPS):
        store.save(step, ckpt_state(torch, step + 1)[1])
    (root / "READY").write_text(str(CKPT_STEPS))
    torch.cuda.empty_cache()


def _dist_restore(torch, np, rank, out):
    """Each rank of a (2, 2) ("data", "model") mesh opens the checkpoint
    store that the smoke's process wrote (its vLSM index replays the
    saves: overlap_scan and merge_path launch) and restores the last step
    under the mesh onto cuda:0, the parameters by param_specs and the
    moments by zero1_specs (sanitized against the mesh): every shard
    bitwise the slice of the rank's own build of the same state."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.checkpoint import LSMCheckpointStore
    from repro_torch.distributed.sharding import (
        P, axis_sizes, local_slice, param_specs, sanitize_spec, zero1_specs)
    from repro_torch.training.tree import leaf_paths, tree_map
    mesh = _mesh(torch, (2, 2), ("data", "model"))
    root = Path(out) / "ckpt"
    deadline = time.time() + DIST_JOIN_S
    while not (root / "READY").exists():
        if time.time() > deadline:
            fail("restore: the checkpoint store was never written")
        time.sleep(0.1)
    cfg, state = ckpt_state(torch, CKPT_STEPS)
    params = state["params"]
    specs = tree_map(
        lambda leaf, spec: sanitize_spec(mesh, spec, tuple(leaf.shape)),
        state, {"params": param_specs(cfg, params),
                "opt": {"m": zero1_specs(cfg, params, mesh),
                        "v": zero1_specs(cfg, params, mesh), "step": P()}})
    kernels.reset_launch_counts()
    tree, stats = LSMCheckpointStore(root, compute_device="cuda").restore(
        treedef_like=state, mesh=mesh, specs=specs)
    launches = kernels.launch_counts()
    if not (launches["overlap_scan"] and launches["merge_path"]):
        fail(f"restore: the store's index launched {launches} on rank "
             f"{rank}")
    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    spec_of = dict(leaf_paths(specs))
    got = dict(leaf_paths(tree))
    sharded = 0
    for path, full in leaf_paths(state):
        box = local_slice(sizes, coord, spec_of[path], tuple(full.shape))
        shard = got[path].to_local()
        if not (shard.is_cuda and torch.equal(
                shard, full[tuple(slice(a, b) for a, b in box)])):
            fail(f"restore under the mesh: {path} on rank {rank}")
        sharded += shard.numel() < full.numel()
    dist.barrier()
    if rank == 0:
        _rank_result(out, "restore", {
            "steps_saved": CKPT_STEPS, "leaves": len(got),
            "sharded_leaves_rank0": sharded,
            "index_launches_rank0": {k: launches[k] for k in
                                     ("overlap_scan", "merge_path")},
            **stats})
    del tree, state
    torch.cuda.empty_cache()


def dist_gloo_rank(rank, world, out, t_spawn):
    """Phase 7b, four gloo ranks on cuda:0 (collectives staged through the
    host by ``comm``'s table, kernels on the card)."""
    import numpy as np
    import torch
    walls = {"startup_s": time.time() - t_spawn}
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    for part, fn in (("decode", _dist_decode), ("compress", _dist_compress),
                     ("pipeline", _dist_pipeline),
                     ("restore", _dist_restore)):
        t0 = time.time()
        fn(torch, np, rank, out)
        walls[f"{part}_s"] = time.time() - t0
    if rank == 0:
        _rank_result(out, "gloo_walls", walls)


def distributed_phase(torch) -> dict:
    """Phase 7: one NCCL rank and four gloo ranks, the two worlds spawned
    side by side on cuda:0; a failing rank fails its world's join.  While
    they start, this process writes the checkpoints the restore reads.
    Each part reports its wall seconds on rank 0, and ``startup_s`` the
    seconds from the spawn to the rank's first line."""
    import tempfile
    from repro_torch.distributed import comm
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        worlds = [(name, comm.start(fn, n, (tmp, time.time()),
                                    backend=name,
                                    init_file=Path(tmp) / f"init_{name}"))
                  for name, fn, n in (("nccl", dist_nccl_rank, 1),
                                      ("gloo", dist_gloo_rank, DIST_RANKS))]
        try:
            # the store that the ranks restore is written while they start
            save_ckpt(torch, Path(tmp) / "ckpt")
            report["ckpt_saved_s"] = time.perf_counter() - t0
            for name, ctx in worlds:
                comm.join(ctx, DIST_JOIN_S - (time.perf_counter() - t0))
                report[f"{name}_wall_s"] = time.perf_counter() - t0
        finally:
            for _, ctx in worlds:
                comm.stop(ctx)
        for part in ("nccl", "decode", "compress", "pipeline", "restore",
                     "gloo_walls"):
            report[part] = json.loads((Path(tmp) / f"{part}.json")
                                      .read_text())
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the detailed JSON report")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT / "src"))
    # the CPU tier's runs go to one spawned worker (never fork: CUDA),
    # which computes them beside the card's phases, and db_bench with the
    # fleet matrix to another, on the card
    ctx = multiprocessing.get_context("spawn")
    pool, bench_pool = ctx.Pool(1, initializer=cpu_worker_init), ctx.Pool(1)
    try:
        return run(args, torch, pool, bench_pool)
    finally:
        for worker in (pool, bench_pool):
            worker.terminate()
            worker.join()


def run(args, torch, pool, bench_pool) -> int:
    """Every phase on the card (``main`` checks for it); ``pool`` is the
    worker that ``cpu_runs`` goes to once phase 3's store path is done,
    ``bench_pool`` the one that runs ``bench_phase`` beside phases 3c-6."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels import _build

    report: dict = {}
    phase_s = report["phase_s"] = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        """Wall seconds of the phase just ended, into the report."""
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {k: [ln for ln in v.splitlines() if "ptxas" in ln]
                       for k, v in _build.ptxas_reports.items()}
    print(f"kernels built in {report['build_s']:.2f} s", flush=True)
    lap("build")

    rng = np.random.default_rng(0)
    ssd_bwd_err, report["ssd_bwd_edge_rel_err"] = edge_ssd_bwd(torch)
    edge_err = {"merge_path": edge_merge(torch, np, rng),
                "overlap_scan": edge_rank(torch, np, rng),
                "lindley_scan": edge_lindley(torch, np, rng),
                "flash_attention": max(edge_flash(torch),
                                       edge_flash_cross(torch)),
                "flash_attention_bwd": edge_flash_bwd(torch),
                "ssd_scan": edge_ssd(torch),
                "ssd_scan_bwd": ssd_bwd_err,
                "paged_attention": max(edge_paged(torch, np),
                                       edge_paged_cross(torch))}
    torch.cuda.synchronize()
    print("kernel edge cases: merge_path and overlap_scan exact, "
          f"lindley_scan max |err| {edge_err['lindley_scan']:.3e} s, "
          f"flash_attention {edge_err['flash_attention']:.3e}, "
          f"flash_attention_bwd {edge_err['flash_attention_bwd']:.3e} "
          f"({len(bwd_cases())} cases, each twice bitwise equal), "
          f"ssd_scan {edge_err['ssd_scan']:.3e}, "
          f"ssd_scan_bwd {ssd_bwd_err:.3e} (of its gradient's largest "
          f"element {report['ssd_bwd_edge_rel_err']}; "
          f"{len(ssd_bwd_cases())} cases, each twice bitwise equal), "
          f"paged_attention {edge_err['paged_attention']:.3e}", flush=True)
    lap("edges")

    trace = ycsb_trace(np, N_LOAD, N_RUN)
    from repro_torch.core import policies
    store_policies = policies.names()
    kernels.reset_launch_counts()
    main_sim, launches, card_runs, probe_m = None, {}, {}, 0
    before = kernels.launch_counts()
    for policy in store_policies:
        torch.cuda.reset_peak_memory_stats()
        with rank_shapes() as shapes, merge_shapes() as merges, \
                CompactionInputs() as inputs, GetBatches() as gets:
            sim, res, wall = run_main_path(torch, np, policy, trace, "cuda")
        report[f"rank_shapes_{policy}"] = shapes.report()
        report[f"merge_shapes_{policy}"] = merges.report()
        report[f"get_batches_{policy}"] = gets.report()
        after = kernels.launch_counts()
        launches[policy] = {k: after[k] - before[k] for k in after}
        before = after
        row = summarize(np, sim, res, trace[3], wall)
        row["launches"] = launches[policy]
        # merge_path launches once for each input SST of a compaction past
        # the first of its merge; a run whose compactions each move one SST
        # into an empty key range (lsmi over the sorted load: its run phase
        # fills no L0 past the trigger) merges nothing
        compactions = [j for j in res.job_log if j.kind == "compact"]
        row["merging_compactions"] = sum(1 for j in compactions
                                         if j.n_in_ssts > 1)
        row["compaction_inputs"] = sum(j.n_in_ssts for j in compactions)
        if inputs.runs != row["compaction_inputs"]:
            fail(f"{policy}: compactions merged {inputs.runs} runs, the job "
                 f"log names {row['compaction_inputs']} input SSTs")
        if inputs.pairwise != launches[policy]["merge_path"]:
            fail(f"{policy}: merge_path launched "
                 f"{launches[policy]['merge_path']} times for "
                 f"{inputs.pairwise} pairwise merges of its compactions")
        row["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if gets.report()["calls"] != launches[policy]["lookup_probe"]:
            fail(f"{policy}: lookup_probe launched "
                 f"{launches[policy]['lookup_probe']} times for "
                 f"{gets.report()['calls']} GET batches")
        if policy == "vlsm":
            main_sim = (sim, res)
            probe_m = gets.median()
        if policy in CROSS_POLICIES:
            card_runs[policy] = (res.get_reads, res.get_probed, res.latency,
                                 res.n_stalls)
            report[f"probe_check_{policy}"] = check_probe_at(
                torch, np, sim.trees[0], trace, gets.median(), policy)
            # the check's launches belong to no policy's path
            before = kernels.launch_counts()
        del sim, res
        report[f"main_{policy}"] = row
        print(f"main path {policy}: " + json.dumps(row), flush=True)
        need = [k for k in STORE_KERNELS
                if k != "merge_path" or inputs.pairwise]
        if min(launches[policy][k] for k in need) <= 0:
            fail(f"{policy}: a kernel never launched on the store path")
        if shapes.report()["calls"] != launches[policy]["overlap_scan"]:
            fail(f"{policy}: {shapes.report()['calls']} recorded rank calls, "
                 f"{launches[policy]['overlap_scan']} launches")
        if merges.report()["calls"] != launches[policy]["merge_path"]:
            fail(f"{policy}: {merges.report()['calls']} recorded merge calls, "
                 f"{launches[policy]['merge_path']} launches")
        print(f"rank shapes {policy}: " + json.dumps(shapes.report()),
              flush=True)
        print(f"merge shapes {policy}: " + json.dumps(merges.report()),
              flush=True)
        print(f"GET batches {policy}: " + json.dumps(gets.report())
              + (", lookup_probe equal to its plain chain: "
                 + json.dumps(report[f"probe_check_{policy}"])
                 if policy in CROSS_POLICIES else ""), flush=True)
    total = {k: sum(counts[k] for counts in launches.values())
             for k in kernels.launch_counts()}
    common = collections.Counter()
    common_merge = collections.Counter()
    for policy in CROSS_POLICIES:
        for m, n, c in report[f"rank_shapes_{policy}"]["top"]:
            common[(m, n)] += c
        for n_a, n_b, c in report[f"merge_shapes_{policy}"]["top"]:
            common_merge[(n_a, n_b)] += c
    torch.cuda.empty_cache()
    lap("store_path")

    # the worker starts now, beside every later phase: first the training
    # cross-checks' CPU halves and the dry-run's plan of qwen3-1.7b's
    # training cell (4b), then the CPU tier's store runs, wanted only at the
    # end; vlsm's store path, run just before and just after the worker
    # starts, gives the worker's toll on a host-bound wall
    _, _, alone = run_main_path(torch, np, "vlsm", trace, "cuda")
    worker_t0 = time.time()
    cross_side = {arch: pool.apply_async(cross_train_cpu, (arch,))
                  for arch in CROSS_TRAIN if arch not in CROSS_TRAIN_HERE}
    dry_side = pool.apply_async(dryrun_train_plan)
    cpu_side = pool.apply_async(cpu_runs)
    _, _, beside = run_main_path(torch, np, "vlsm", trace, "cuda")
    report["worker_toll"] = {"store_path_alone_s": alone,
                             "store_path_beside_worker_s": beside}
    print("vlsm store path without and beside the CPU worker: "
          + json.dumps(report["worker_toll"]), flush=True)
    lap("worker_start")

    # db_bench and the fleet matrix (3b, 3c) run in a second spawned process
    # on the card beside the phases up to the serving paths, which wait for
    # it with the training steps and the kernel timings: both sides are
    # host-bound and the card idle most of the time, and no serving or
    # training wall and no device time is taken beside it
    bench_side = bench_pool.apply_async(
        bench_phase, (None if args.out is None else str(args.out),))
    report["fleet_workers"] = workers_rows(torch)
    print("fleet_sweep workers 1 vs 2: " + json.dumps(report["fleet_workers"]),
          flush=True)
    lap("fleet_workers")

    memo: dict = {}
    for policy in SERVE_POLICIES:
        srv = report[f"serve_open_{policy}"] = serve_open(torch, np, policy,
                                                          memo)
        print(f"open-loop serving {policy}: " + json.dumps(
            {k: v for k, v in srv.items() if k not in ("off", "on")}),
            flush=True)
        for arm in ("off", "on"):
            print(f"open-loop serving {policy}, admission {arm}: "
                  + json.dumps(srv[arm]), flush=True)
        torch.cuda.empty_cache()
    del memo
    lap("serve_open")

    card_store = shard_card_runs(torch, np)
    torch.cuda.empty_cache()
    lap("shard_store_card")

    # the training path's checks
    report["train_whisper"] = train_whisper(torch, np)
    print("training whisper-tiny through launch.train (one injected "
          "failure): " + json.dumps(report["train_whisper"]), flush=True)
    torch.cuda.empty_cache()
    report["cross_train"] = {}
    for arch in CROSS_TRAIN:
        if arch in CROSS_TRAIN_HERE:
            report["cross_train"][arch] = train_cross_check(torch, np, arch)
        else:
            t0 = time.perf_counter()
            cpu = cross_side.pop(arch).get()
            wait = time.perf_counter() - t0
            task = cpu.pop("worker")
            report["cross_train"][arch] = train_cross_check(torch, np, arch,
                                                            cpu)
            report["cross_train"][arch].update(
                worker_wait_s=wait, worker_setup_s=task["setup_s"],
                worker_task_s=task["end"] - task["start"],
                worker_start_s=task["start"] - worker_t0)
            del cpu
        print(f"cross-check training {arch} (float32): "
              + json.dumps(report["cross_train"][arch]), flush=True)
    torch.cuda.empty_cache()
    lap("train_checks")

    report["zamba2_bf16_states"] = serve_state_check(torch, np)
    print("zamba2 bf16 states: " + json.dumps(
        {k: v for k, v in report["zamba2_bf16_states"].items()
         if k != "per_layer_err"}), flush=True)
    torch.cuda.empty_cache()
    for arch, (_, layers) in SERVE_PATHS.items():
        cross = serve_cross_check(torch, np, arch, layers)
        report[f"cross_serve_{arch}"] = cross
        print(f"cross-check serving {arch} (float32, {layers} layers): "
              + json.dumps(cross), flush=True)
        torch.cuda.empty_cache()

    lap("serving_checks")

    try:
        report["db_bench"], report["fleet_matrix"] = bench_side.get(
            timeout=BENCH_WAIT_S)
    except multiprocessing.TimeoutError:
        fail(f"db_bench and the fleet matrix not done in {BENCH_WAIT_S} s")
    print(f"db_bench rows through the schema gate "
          f"(REPRO_PARANOID_CHECKS=1): "
          f"{report['db_bench']['schema_validated_rows']} of "
          f"{report['db_bench']['rows']}, "
          f"{report['db_bench']['last_digit_flips']} last-digit flips",
          flush=True)
    print("db_bench rows: " + json.dumps(report["db_bench"]), flush=True)
    print("fleet matrix: " + json.dumps(report["fleet_matrix"]), flush=True)
    lap("bench_wait")

    serve_launches = {}
    for arch in SERVE_PATHS:
        srv = report[f"serve_{arch}"] = serve_phase(torch, np, arch)
        serve_launches[arch] = srv["launches"]
        print(f"serving path {arch}: " + json.dumps(
            {k: v for k, v in srv.items() if k != "outputs"}), flush=True)
    report["long_window_decode"] = long_window_decode(torch, np)
    print("gemma3-1b long windowed decode: "
          + json.dumps(report["long_window_decode"]), flush=True)
    torch.cuda.empty_cache()
    lap("serving")

    report["train_qwen3"] = train_qwen3(torch, np, dry_side.get(timeout=600))
    report["dryrun_train"] = report["train_qwen3"].pop("dryrun")
    print(f"dry-run against the card, {TRAIN_ARCH} training B {TRAIN_BATCH} "
          f"x S {TRAIN_SEQ}: " + json.dumps(report["dryrun_train"]),
          flush=True)
    print(f"training {TRAIN_ARCH}: " + json.dumps(report["train_qwen3"]),
          flush=True)
    report["train_zamba2"] = train_zamba2(torch, np)
    print(f"training {SSM_TRAIN_ARCH}: " + json.dumps(report["train_zamba2"]),
          flush=True)
    report["train_gemma3"] = train_gemma3(torch, np)
    print("training gemma3_1b: " + json.dumps(report["train_gemma3"]),
          flush=True)
    report["train_deepseek"] = train_deepseek(torch, np)
    print(f"training {MOE_TRAIN_ARCH} at {MOE_TRAIN_LAYERS} layers: "
          + json.dumps(report["train_deepseek"]), flush=True)
    lap("train")

    # the card, its driver and clocks beside the device times, which have
    # moved between calls with no kernel changed (PERF.md section 7)
    report["card_state"] = {"fields": CARD_STATE,
                            "torch": torch.__version__,
                            "cuda": torch.version.cuda,
                            "before_timings": card_query(CARD_STATE)}
    sim, res = main_sim
    timings = {"merge_path": time_merge(torch, sim),
               "overlap_scan": time_rank(torch, np, sim, trace),
               "lookup_probe": time_probe(torch, np, sim.trees[0], trace,
                                          probe_m),
               "lindley_scan": time_lindley(torch, np,
                                            *lindley_queue(np, sim, res))}
    # the commonest shapes are held against the plain version here and
    # timed by scripts/probe.py merge rank (and the 4,096-row batch by
    # probe.py lindley), to keep the run's time
    report["rank_common"] = check_rank_at(torch, np, trace,
                                          *common.most_common(1)[0][0])[0]
    timings["overlap_scan"]["max_abs_err"] = max(
        timings["overlap_scan"]["max_abs_err"],
        report["rank_common"]["max_abs_err"])
    timings["lookup_probe"]["max_abs_err"] = max(
        [timings["lookup_probe"]["max_abs_err"]]
        + [report[f"probe_check_{p}"]["max_abs_err"]
           for p in CROSS_POLICIES])
    report["merge_common"] = check_merge_at(
        torch, np, trace, *common_merge.most_common(1)[0][0])[0]
    report["lindley_ragged"] = check_lindley_ragged(
        torch, np, res.arrivals, LINDLEY_ROWS)[0]
    del main_sim, sim, res
    s_serve = max(report["serve_zamba2_1_2b"]["prompt_tokens"])
    timings["flash_attention"] = time_flash(torch, s_serve, 40)
    timings["ssd_scan"] = time_ssd(torch, s_serve, 40)
    timings["paged_attention"] = time_paged(
        torch, max(report["serve_qwen3_1_7b"]["prompt_tokens"])
        + DECODE_TOKENS - 1, 200)
    report["qwen3_prefill_flash"] = time_flash(torch, s_serve, 40, 16, 8, 128)
    report["zamba2_decode_paged"] = time_paged(
        torch, s_serve + DECODE_TOKENS - 1, 200, 32, 32, 64)
    s_gemma = max(report["serve_gemma3_1b"]["prompt_tokens"])
    report["gemma3"] = {
        "flash_prefill": time_flash(torch, s_gemma, 40, 4, 1, 256),
        "paged_decode": time_paged(torch, s_gemma + DECODE_TOKENS - 1, 200,
                                   4, 1, 256, GEMMA_WINDOW)}
    # the 4,096-token rows of flash, paged and gemma3 are checked against
    # their plain versions here and timed by scripts/probe.py flash paged
    # gemma3 (gemma3_timings), to keep the run's time
    n, w = LONG_PREFILL, GEMMA_WINDOW
    report["long_checks"] = {name: check(torch, *a)[0] for name, check, a in (
        ("flash_d64_4096", check_flash, (n,)),
        ("flash_qwen3_4096", check_flash, (n, 16, 8, 128)),
        ("paged_long_b8", check_paged_long, ()),
        ("paged_long_b1", check_paged_long, (1,)),
        ("flash_gemma3_4096_window", check_flash, (n, 4, 1, 256, w)),
        ("flash_gemma3_4096_global", check_flash, (n, 4, 1, 256)),
        ("paged_gemma3_4096_window", check_paged, (n, 4, 1, 256, w, n)),
        ("paged_gemma3_4096_global", check_paged, (n, 4, 1, 256, None, n)))}
    checked = {**report["gemma3"], **report["long_checks"]}
    edge_err["flash_attention"] = max(
        edge_err["flash_attention"],
        report["qwen3_prefill_flash"]["max_abs_err"],
        *(t["max_abs_err"] for k, t in checked.items()
          if k.startswith("flash")))
    edge_err["paged_attention"] = max(
        edge_err["paged_attention"],
        report["zamba2_decode_paged"]["max_abs_err"],
        *(t["max_abs_err"] for k, t in checked.items()
          if k.startswith("paged")))
    for name, err in edge_err.items():
        if name in timings:
            timings[name]["max_abs_err"] = max(timings[name]["max_abs_err"],
                                               err)
    report["long_prefill"] = {"ssd_scan": time_ssd(torch, LONG_PREFILL, 10)}
    report["card_state"]["after_timings"] = card_query(CARD_STATE)
    print("card state before and after the timings: "
          + json.dumps(report["card_state"]), flush=True)
    for name, t in timings.items():
        print(f"timing {name}: " + json.dumps(t), flush=True)
    print("timing flash_attention at qwen3's prefill shape: "
          + json.dumps(report["qwen3_prefill_flash"]), flush=True)
    print("timing paged_attention at zamba2's decode shape: "
          + json.dumps(report["zamba2_decode_paged"]), flush=True)
    print("overlap_scan at the store's commonest shape: "
          + json.dumps(report["rank_common"]), flush=True)
    print("merge_path at the store's commonest shape: "
          + json.dumps(report["merge_common"]), flush=True)
    print(f"lindley_scan over {LINDLEY_ROWS} rows: "
          + json.dumps(report["lindley_ragged"]), flush=True)
    for name, t in report["long_prefill"].items():
        print(f"timing {name} at {LONG_PREFILL} tokens: " + json.dumps(t),
              flush=True)
    for name, t in report["long_checks"].items():
        print(f"{name} against its plain version (timed by "
              "scripts/probe.py): " + json.dumps(t), flush=True)
    for name, t in report["gemma3"].items():
        print(f"timing gemma3-1b {name}: " + json.dumps(t), flush=True)
    torch.cuda.empty_cache()
    lap("timings")

    s_whisper = max(report["serve_whisper_tiny"]["prompt_tokens"])
    timings["flash_attention_bwd"] = time_flash_bwd(torch, TRAIN_BATCH,
                                                    TRAIN_SEQ, 40)
    report["flash_bwd_4096"] = time_flash_bwd(torch, 1, LONG_PREFILL, 4)
    report["whisper_encoder_flash"] = time_flash_cross(
        torch, WHISPER_FRAMES, WHISPER_FRAMES, 40)
    report["whisper_cross_flash"] = time_flash_cross(torch, s_whisper,
                                                     WHISPER_FRAMES, 40)
    timings["flash_attention_bwd"]["max_abs_err"] = max(
        timings["flash_attention_bwd"]["max_abs_err"],
        report["flash_bwd_4096"]["max_abs_err"],
        edge_err["flash_attention_bwd"])
    timings["flash_attention"]["max_abs_err"] = max(
        timings["flash_attention"]["max_abs_err"],
        report["whisper_encoder_flash"]["max_abs_err"],
        report["whisper_cross_flash"]["max_abs_err"])
    # (ssd_scan_bwd at 4,096 steps is timed by scripts/probe.py ssd_bwd;
    # its check against the plain version stays in phase 2)
    timings["ssd_scan_bwd"] = time_ssd_bwd(torch, TRAIN_BATCH, TRAIN_SEQ, 40)
    timings["ssd_scan_bwd"]["max_abs_err"] = max(
        timings["ssd_scan_bwd"]["max_abs_err"], edge_err["ssd_scan_bwd"])
    for name in ("flash_bwd_4096", "whisper_encoder_flash",
                 "whisper_cross_flash"):
        print(f"timing {name}: " + json.dumps(report[name]), flush=True)
    print("timing flash_attention_bwd at the training shape: "
          + json.dumps(timings["flash_attention_bwd"]), flush=True)
    print("timing ssd_scan_bwd at the training shape: "
          + json.dumps(timings["ssd_scan_bwd"]), flush=True)
    torch.cuda.empty_cache()
    lap("bwd_timings")


    cpu = cpu_side.get()
    lap("worker_wait")
    report["shard_store"] = shard_store_check(np, card_store,
                                              cpu.pop("shard_store"))
    del card_store
    print("ShardedStore card vs cpu: " + json.dumps(report["shard_store"]),
          flush=True)
    for policy in CROSS_POLICIES:
        reads, probed, latency, n_stalls = card_runs.pop(policy)
        c_reads, c_probed, c_latency, c_stalls, w_cpu = cpu.pop(policy)
        if not (np.array_equal(reads, c_reads)
                and np.array_equal(probed, c_probed)):
            fail(f"cross-check {policy}: per-op reads/probed differ")
        err = float(np.max(np.abs(latency - c_latency)))
        if not err < LINDLEY_TOL_S or n_stalls != c_stalls:
            fail(f"cross-check {policy}: latency err {err}, stalls "
                 f"{n_stalls} vs {c_stalls}")
        report[f"cross_{policy}"] = {"max_abs_latency_err_s": err,
                                     "cpu_wall_s": w_cpu}
        print(f"cross-check {policy}: card vs cpu reads/probed identical, "
              f"max |latency err| {err:.3e} s (cpu run {w_cpu:.1f} s)",
              flush=True)

    lap("cross_checks")

    # the worker is idle from here on: the distributed phase's processes
    # slow no host-bound phase
    report["distributed"] = dist = distributed_phase(torch)
    print("distributed, one NCCL rank: " + json.dumps(dist["nccl"]),
          flush=True)
    for part in ("decode", "compress", "pipeline", "restore"):
        print(f"distributed, {DIST_RANKS} gloo ranks, {part}: "
              + json.dumps(dist[part]), flush=True)
    lap("distributed")
    print("phase wall s: " + json.dumps(phase_s), flush=True)
    rows = []
    for name, t in timings.items():
        # launches: each kernel's count on its own main path (store kernels
        # on the store path, each LM kernel on the serving or training path
        # of ROW_PATH)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{CSRC.get(name, name)}.cu",
            "replaces": f"src/repro/{SOURCES[name]}",
            "launches": (total if name in STORE_KERNELS
                         else report[ROW_PATH[name]]["launches"]
                         if name.endswith("_bwd")
                         else serve_launches[ROW_PATH[name]])[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "device_events": t["device_events"],
            "plain_device_ms": t["plain_device_ms"],
            "library_device_ms": t["library_device_ms"]})
    report["kernels"] = rows
    report["card"] = card
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
