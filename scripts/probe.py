#!/usr/bin/env python3
"""Short chip runs of single phases of ``chip_smoke.py``, for iterating on
one kernel of the PyTorch/CUDA port without driving the store and serving
paths, on one GPU.

    python3 scripts/probe.py PHASE [PHASE ...] [--src DIR] [--out DIR]
                             [--predict TEXT]

Phases, each made of ``chip_smoke.py``'s own functions:

    edge_merge edge_rank edge_lindley edge_flash edge_ssd edge_paged
    edge_flash_cross edge_flash_bwd edge_paged_cross
              one kernel's edge cases against its plain version (the last
              three: flash_attention non-causal with Sq != Sk, its
              backward kernel, paged_attention over whisper's padded cross
              cache)
    states    zamba2-1.2b's bf16 prefill states and their hand-off to
              decode (``serve_state_check``)
    merge     merge_path at the store's main merge (an L1 run of 321,467
              keys with an L0 run of 22,578) and at its commonest
              (41,943 + 41,943), beside torch.sort
    rank      overlap_scan at 41,943 GET keys over 7,956,248 fences and at
              the commonest call (1 key over 6), beside torch.searchsorted
    lindley   lindley_scan over the store path's 10,000,000 arrivals (YCSB
              A's load and run, service exponential with a 20 us mean) as
              one queue and as 4,096 rows
    flash     flash_attention at S 189 (zamba2's and qwen3's heads) and at
              4,096
    paged     paged_attention at qwen3's and zamba2's decode shapes and at
              8 and 1 sequences of 4,096 tokens
    ssd       ssd_scan at zamba2's L 189 and 4,096
    flash_bwd flash_attention's backward at qwen3-1.7b's heads at the
              training shape (B 8 x S 64) and at 4,096 tokens, beside SDPA's
              backward, with the registers, stack and spills ptxas reports
              for every kernel of its library
    gemma3_bwd the backward at gemma3-1b's shapes (4 query heads over 1 kv
              head of 256): its training step (B 8 x S 64) and a 4,096-
              token step's global and local (window 512) layers, beside
              SDPA's backward, with ptxas's registers and spills
              (``gemma3_bwd_unsplit``: dK and dV's blocks never split
              over the query heads)
    whisper_bwd the backward at whisper-tiny's training shapes (B 8, 6
              heads of 64, non-causal): the encoder's 1,500 x 1,500 and the
              cross attention's 64 queries over 1,500 frames, beside SDPA's
              backward
    whisper_flash flash_attention at whisper-tiny's encoder (S 1,500,
              non-causal) and cross attention (189 over 1,500)
    flash_decode the sequence-sharded decode of ``chip_smoke.py`` phase 7
              at qwen3-1.7b's heads (B 8, bf16, decode_32k's 32,768 cache
              tokens): paged_attention at one rank's slice (8,192 tokens)
              with and without its log-sum-exp, beside SDPA over the slice,
              and over the whole cache on one rank; then 4 gloo ranks on
              this card: each rank's kernel device time with lse, the
              combine's wall time and the whole call's
    distributed ``chip_smoke.py`` phase 7 alone: one NCCL rank, then four
              gloo ranks on this card (sequence-sharded decode, the int8
              cross-pod mean, qwen3-1.7b's GPipe stages, a restore under a
              (2, 2) mesh)
    gemma3    flash_attention and paged_attention at gemma3-1b's shapes
              (head_dim 256, 4 query heads over 1 kv head): its serving
              prefill and decode, and 4,096 tokens with its 512-token window
              and global
    serve_zamba2 serve_qwen3 serve_gemma3 serve_deepseek serve_whisper
    serve_llama3 serve_yi serve_qwen2vl serve_mamba2
              a model's serving path at full size (``chip_smoke.py`` phase
              4: launches, peak memory), and its 2-request profile
    train_qwen3 train_whisper cross_train
              the training phase: qwen3-1.7b's full-size steps, whisper-
              tiny through the launcher with a restore, the float32
              card-vs-CPU training checks (qwen3-1.7b at 2 layers,
              whisper-tiny at full size, zamba2-1.2b at 7 layers,
              mamba2-130m at its full 24 against a float64 run too,
              gemma3-1b at 6, deepseek-v2-lite at 2), their CPU halves in
              this process
    train_qwen3_long qwen3-1.7b at full size in bf16 on B 1 x S 4,096: 2
              steps (ms a step, launches, peak memory), then a third under
              torch.profiler for the backward kernels' share of the step
    train_gemma3 train_deepseek
              gemma3-1b's training phase at full size in bf16 (5 steps on
              one fixed learnable batch, 52 flash and 26 backward launches
              a step) and deepseek-v2-lite's at full width and 4 layers (3
              steps, no attention kernel)
    train_gemma3_long gemma3-1b at full size in bf16 on B 1 x S 4,096: 2
              steps, then a third under torch.profiler: flash_attention's
              kernels' share of the step, forward and backward
    train_zamba2 zamba2-1.2b's training phase at full size in bf16 (5 steps
              on one fixed learnable batch: launches, losses, ms a step,
              peak memory), then a sixth step under torch.profiler: the
              device's busy share, ssd_scan's and flash_attention's
              kernels forward and backward, the top kernels
    cross_train_ssm the float32 card-vs-CPU training checks of zamba2-1.2b
              (7 layers) and mamba2-130m (24 layers, and its float64 run)
              alone
    cross_train_new those of gemma3-1b (6 layers) and deepseek-v2-lite (2)
    cross_train_worker the CPU halves of those checks that the smoke's
              spawned worker computes, queued as there: each task's start,
              set-up, length and the time its result takes to arrive
    cross_depth mamba2-130m's training check at 16 and 24 layers, and at
              24 with ssd_scan's plain versions on the card, from weights
              drawn on the CPU and (at 24) on the card: the card and the
              CPU tier each against the float64 run
    edge_ssd_bwd ssd_scan's backward kernel against its plain version over
              ``ssd_bwd_cases()``, each case twice and bitwise equal
    ssd_bwd   ssd_scan's backward at zamba2-1.2b's training shape (B 8, L
              64, 64 heads, bf16) and at 4,096 steps, beside its plain
              version, with each pass's device time and events a call and
              the registers, stack and spills ptxas reports
    fleet_matrix db_bench's fleet_sweep at full size, then the fleet
              matrix in one lindley_scan launch against its passes, and
              lindley_scan timed over the matrix's batch
    long_decode gemma3-1b's 4,096-token prefill and 16 windowed decode steps
    cross_gemma3 cross_deepseek cross_whisper cross_llama3 cross_yi
    cross_qwen2vl cross_mamba2
              a model's float32 card-vs-CPU serving cross-check (phase 6)
    seekrandom db_bench's seekrandom at full size for every policy, from
              rewound uid counters: its wall, its launches and its rows
    serve_sweep db_bench's serve_sweep at full size for every policy: its
              wall, its launches, its rows against the committed ones
    serve_open open-loop serving over the store at the paper's byte scale
              (``chip_smoke.py`` phase 3d, vlsm and rocksdb)
    profiles  where the store's time goes: vlsm's store path under
              torch.profiler (device busy share) and cProfile, and phase
              3d's admission-on serve of vlsm at factor 2 under
              torch.profiler
    shard_store ``ShardedStore`` of 4 shards and of 1 on the card against
              the CPU, and the 1 against a bare tree (``chip_smoke.py``
              phase 3e)
    lookup_probe the GET path's fused probe on the vlsm.ycsb_b.served
              cell's tree (8 M keys preloaded, its 32 warm batches served):
              one batch's ~9,500 GETs, the kernel beside the plain chain
              on the same runs (equal element for element), their device
              time and events a call, the whole ``_lookup_batch`` on the
              host clock, and the bytes bound
    window    ``device_ms`` read three times a function at the main
              shapes, with the device events each reading recorded
    clocks    merge_path's, lindley_scan's and ssd_scan's device time after
              an idle and after a busy second, beside the SM clock

It builds the kernels the phases need and prints their ``-Xptxas -v``
lines, prints ``--predict``'s text before anything runs, then runs every
phase even after one failed, printing each failure; the exit code is 1 if
any failed.  ``--src DIR`` puts another ``repro_torch`` first on the path
(such as an unpacked parent commit's ``src``), so two versions can be
timed in turns within one call; ``--out DIR`` writes every number to
``DIR/probe-<phases>[-<src>].json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_MERGE = (321_467, 22_578)     # an L1 run and an L0 run of the store
COMMON_MERGE = (41_943, 41_943)    # two flushed memtables
MAIN_RANK = (41_943, 7_956_248)    # a memtable of GETs over the flat L1
COMMON_RANK = (1, 6)


def _trace(ctx, np, cs):
    if "trace" not in ctx:
        ctx["trace"] = cs.ycsb_trace(np, cs.N_LOAD, cs.N_RUN)
    return ctx["trace"]


def merge(torch, np, cs, ctx) -> dict:
    trace = _trace(ctx, np, cs)
    return {"main": cs.time_merge_at(torch, np, trace, *MAIN_MERGE),
            "common": cs.time_merge_at(torch, np, trace, *COMMON_MERGE)}


def rank(torch, np, cs, ctx) -> dict:
    trace = _trace(ctx, np, cs)
    return {"main": cs.time_rank_at(torch, np, trace, *MAIN_RANK),
            "common": cs.time_rank_at(torch, np, trace, *COMMON_RANK)}


def lindley(torch, np, cs, ctx) -> dict:
    arrivals = _trace(ctx, np, cs)[2]
    service = np.random.default_rng(4).exponential(2e-5, arrivals.size)
    return {"queue": cs.time_lindley(torch, np, service, arrivals),
            "rows": cs.time_lindley_ragged(torch, np, arrivals,
                                           cs.LINDLEY_ROWS)}


def flash(torch, np, cs, ctx) -> dict:
    return {"zamba2_189": cs.time_flash(torch, 189, 40),
            "qwen3_189": cs.time_flash(torch, 189, 40, 16, 8, 128),
            "d64_4096": cs.time_flash(torch, cs.LONG_PREFILL, 10),
            "qwen3_4096": cs.time_flash(torch, cs.LONG_PREFILL, 10, 16, 8,
                                        128)}


def paged(torch, np, cs, ctx) -> dict:
    length = 189 + cs.DECODE_TOKENS - 1
    return {"qwen3_decode": cs.time_paged(torch, length, 200),
            "zamba2_decode": cs.time_paged(torch, length, 200, 32, 32, 64),
            "long_b8": cs.time_paged_long(torch, 20),
            "long_b1": cs.time_paged_long(torch, 40, 1)}


def ptxas_summary(name: str) -> dict:
    """Registers, stack frame and spill bytes of every kernel ``nvcc
    -Xptxas -v`` compiled for library ``name`` in this process (demangled
    where ``c++filt`` is found); empty if it was not built here."""
    import re
    import shutil
    import subprocess

    from repro_torch.kernels import _build
    out: dict = {}
    fn = None
    for line in _build.ptxas_reports.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(
                m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn]["registers"] = int(m.group(1))
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True).stdout
        out = dict(zip(map(_kernel_name, names.splitlines()),
                       out.values()))
    return out


def _kernel_name(sig: str) -> str:
    """``name<args>`` of a demangled kernel's signature: no return type,
    parameters or anonymous namespace (its parameters may hold ``::``)."""
    depth = 0
    for i in range(len(sig) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(sig[i], 0)
        if depth == 0 and sig[i] == "(":
            sig = sig[:i]
            break
    return sig.removeprefix("void ").replace("(anonymous namespace)::", "")


def flash_bwd(torch, np, cs, ctx) -> dict:
    return {"ptxas": ptxas_summary("flash_attention_bwd"),
            "train": cs.time_flash_bwd(torch, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                       40),
            "qwen3_4096": cs.time_flash_bwd(torch, 1, cs.LONG_PREFILL, 4)}


def gemma3_bwd(torch, np, cs, ctx) -> dict:
    """flash_attention's backward at gemma3-1b's shapes (4 query heads over
    1 kv head of 256, bf16): its training step's (B 8 x S 64, causal; the
    local layers' window does not reach past S 64) and a 4,096-token
    step's global and local (window 512) layers, beside SDPA's backward;
    each row's ``kernel_device_ms`` names the kernels that ran."""
    b, hq, hkv, d = cs.BWD_GEMMA
    n, w = cs.LONG_PREFILL, cs.GEMMA_WINDOW
    return {"ptxas": ptxas_summary("flash_attention_bwd"),
            "train": cs.time_flash_bwd(torch, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                       40, hq, hkv, d),
            "global_4096": cs.time_flash_bwd(torch, b, n, 4, hq, hkv, d),
            "local_4096": cs.time_flash_bwd(torch, b, n, 4, hq, hkv, d,
                                            window=w)}


def gemma3_bwd_unsplit(torch, np, cs, ctx) -> dict:
    """``gemma3_bwd`` with dK and dV's blocks never split over the query
    heads (``ops._head_split`` off): one block per (b, kv head, 64 keys)."""
    from repro_torch.kernels.flash_attention import ops
    saved = ops._head_split
    ops._head_split = lambda *a: False
    try:
        return gemma3_bwd(torch, np, cs, ctx)
    finally:
        ops._head_split = saved


def whisper_bwd(torch, np, cs, ctx) -> dict:
    n, b = cs.WHISPER_FRAMES, cs.WHISPER_TRAIN["batch"]
    return {"encoder": cs.time_flash_bwd(torch, b, n, 10, 6, 6, 64,
                                         causal=False),
            "cross": cs.time_flash_bwd(torch, b, cs.TRAIN_SEQ, 20, 6, 6, 64,
                                       sk=n, causal=False)}


def train_qwen3_long(torch, np, cs, ctx) -> dict:
    """qwen3-1.7b's training steps at B 1 x S LONG_PREFILL, then one more
    step profiled."""
    out, (step, params, opt, pipe) = cs.train_steps(torch, np, 1,
                                                    cs.LONG_PREFILL, 2)
    out["profiled_step"] = profile_train_step(
        torch, cs, step, params, opt, pipe.next_batch(),
        out["step_ms_after_first"])
    del params, opt
    torch.cuda.empty_cache()
    return out


def train_gemma3_long(torch, np, cs, ctx) -> dict:
    """gemma3-1b's training at B 1 x S LONG_PREFILL, full size in bf16 (its
    22 local layers run their 512-token window, its 4 global layers the
    whole causal span): 2 steps, then one more step profiled, with
    flash_attention's kernels forward and backward."""
    out, (step, params, opt, pipe) = cs.train_steps(
        torch, np, 1, cs.LONG_PREFILL, 2, arch="gemma3_1b")
    out["profiled_step"] = profile_train_step(
        torch, cs, step, params, opt, pipe.next_batch(),
        out["step_ms_after_first"],
        {"flash_attention": ("flash_fwd",),
         "flash_attention_bwd": ("bwd_dq", "bwd_dkdv")})
    del params, opt
    torch.cuda.empty_cache()
    return out


def train_zamba2(torch, np, cs, ctx) -> dict:
    """zamba2-1.2b's training phase (``chip_smoke.train_zamba2``'s steps on
    its fixed learnable batch), then one more step profiled: the device's
    busy share and where it goes, ssd_scan's and flash_attention's
    kernels, forward and backward, beside the top kernels."""
    from repro_torch.configs import get_config
    cfg = get_config(cs.SSM_TRAIN_ARCH)
    batch = cs.learnable_batch(np, cfg.vocab_size, cs.TRAIN_BATCH,
                               cs.TRAIN_SEQ)
    out, (step, params, opt, _) = cs.train_steps(
        torch, np, cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.SSM_TRAIN_STEPS,
        arch=cs.SSM_TRAIN_ARCH, fixed=batch)
    out["profiled_step"] = profile_train_step(
        torch, cs, step, params, opt, batch, out["step_ms_after_first"],
        {"ssd_scan": ("chunk_state", "state_pass", "chunk_out"),
         "ssd_scan_bwd": ("bwd_chunk", "bwd_carry", "bwd_out", "bwd_reduce",
                          "bwd_da"),
         "flash_attention": ("flash_fwd",),
         "flash_attention_bwd": ("bwd_dq", "bwd_dkdv")})
    del params, opt
    torch.cuda.empty_cache()
    return out


def profile_train_step(torch, cs, step, params, opt, tokens, step_ms: float,
                       groups: dict | None = None) -> dict:
    """One training step under torch.profiler (device activity only): the
    device time of each group of kernels (by name fragments; by default
    flash_attention's backward) against the device's busy time and
    against ``step_ms``, a step's time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    groups = groups or {"flash_attention_bwd": ("bwd_dq", "bwd_dkdv")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = cs.kernel_times_us(prof)
    busy = sum(us for _, us, _ in rows) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "busy_share_of_step": busy / wall_ms}
    for name, frags in groups.items():
        mine = [(n, us, c) for n, us, c in rows
                if any(f in n for f in frags)]
        ms = sum(us for _, us, _ in mine) / 1e3
        out[name] = {"device_ms": ms,
                     "share_of_busy": ms / busy if busy else None,
                     "share_of_step": ms / step_ms,
                     "kernels": [{"name": n[:90], "ms": us / 1e3, "count": c}
                                 for n, us, c in mine]}
    out["top_device"] = [{"name": n[:90], "ms": us / 1e3, "count": c}
                         for n, us, c in rows[:12]]
    return out


def cross_train_worker(torch, np, cs, ctx) -> dict:
    """The training cross-checks' CPU halves as the smoke computes them in
    its spawned worker (two threads; all but CROSS_TRAIN_HERE's, queued at
    once), nothing else running; per arch its task's start (from the
    queueing), set-up and task seconds, and the seconds its result took to
    reach this process."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        1, initializer=cs.cpu_worker_init)
    try:
        t0 = time.time()
        jobs = {arch: pool.apply_async(cs.cross_train_cpu, (arch,))
                for arch in cs.CROSS_TRAIN if arch not in cs.CROSS_TRAIN_HERE}
        out = {}
        for arch, job in jobs.items():
            task = job.get()["worker"]
            out[arch] = {"start_s": task["start"] - t0,
                         "setup_s": task["setup_s"],
                         "task_s": task["end"] - task["start"],
                         "transfer_s": time.time() - task["end"]}
        out["all_s"] = time.time() - t0
        return out
    finally:
        pool.terminate()
        pool.join()


def whisper_flash(torch, np, cs, ctx) -> dict:
    n = cs.WHISPER_FRAMES
    return {"encoder": cs.time_flash_cross(torch, n, n, 40),
            "cross": cs.time_flash_cross(torch, 189, n, 40)}


def fleet_matrix(torch, np, cs, ctx) -> dict:
    from repro_torch.bench_kv import db_bench
    from repro_torch.core.uids import reset_uid_counters
    reset_uid_counters()
    with cs.RecordLindley() as rec:
        db_bench.main(["--bench", "fleet_sweep"])
    report, batch = cs.fleet_matrix(torch, np, [c[1:] for c in rec.calls])
    report["timing"] = cs.time_lindley_matrix(torch, batch)
    return report


def gemma3(torch, np, cs, ctx) -> dict:
    return cs.gemma3_timings(torch, 189)


def _decode_args(torch, cs, slices):
    """q, K, V (``slices`` of the seeded cache), page table and lengths of
    phase 7's decode at qwen3-1.7b's heads in bf16, every sequence live
    over the whole of each slice."""
    hq, hkv, d = cs.DIST_DECODE_HEADS["qwen3_1_7b"]
    b, t = cs.DIST_DECODE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7100)
    q = cs._randn(torch, gen, (b, hq, d), torch.bfloat16)
    k, v = cs._decode_slices(torch, b, t, hkv, d, torch.bfloat16, slices)
    pt = torch.arange(b, dtype=torch.int32, device="cuda")[:, None]
    ln = torch.full((b,), k.shape[1], dtype=torch.int32, device="cuda")
    return q, k, v, pt, ln


def flash_decode_rank(rank, world, out):
    """One rank of ``flash_decode``'s 4-rank run (gloo, cuda:0): its slice's
    kernel with lse (device time), the combine (wall, synchronized) and
    the whole call (wall, synchronized), 40 calls each after a warm-up."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke as cs
    from repro_torch.distributed.flash_decode import (
        combine_partials, seq_sharded_decode_attn)
    from repro_torch.kernels.paged_attention import paged_attention
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("model",))
    q, k, v, pt, ln = _decode_args(torch, cs, [rank])
    pos = torch.full((q.shape[0],), cs.DIST_DECODE[1] - 1, device="cuda")
    o, lse = paged_attention(q, k, v, pt, ln, return_lse=True)

    def wall_ms(fn, reps=40):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    row = {"kernel_lse_device_ms": cs.device_ms(
        torch, lambda: paged_attention(q, k, v, pt, ln, return_lse=True),
        40),
        "combine_wall_ms": wall_ms(lambda: combine_partials(mesh, o, lse)),
        "call_wall_ms": wall_ms(lambda: seq_sharded_decode_attn(
            mesh, q, k, v, pos))}
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(row))


def flash_decode(torch, np, cs, ctx) -> dict:
    import tempfile
    import torch.nn.functional as F
    from repro_torch.distributed import comm
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_plain)
    hq, hkv, d = cs.DIST_DECODE_HEADS["qwen3_1_7b"]
    report = {}
    for name, slices in (("slice", [0]),
                         ("whole", list(range(cs.DIST_RANKS)))):
        q, k, v, pt, ln = _decode_args(torch, cs, slices)
        b, t = k.shape[:2]
        kc, vc = (x.transpose(1, 2).contiguous() for x in (k, v))
        bound, by = cs.paged_bound(b, hq, hkv, d, t, 1)

        def library():
            return F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, enable_gqa=True)[:, :, 0]
        cs.check_close(f"paged_attention, decode {name}", "paged_attention",
                       paged_attention(q, k, v, pt, ln),
                       paged_attention_plain(q, k, v, pt, ln))
        for lse in (False, True):
            report[f"{name}{'_lse' if lse else ''}"] = {
                "shape": f"B {b} x {t} tokens, H {hq} over {hkv}, D {d}, "
                         "bf16", "bound_ms": bound, "bound_by": by,
                **cs.time_all(torch, lambda: paged_attention(
                    q, k, v, pt, ln, return_lse=lse),
                    lambda: paged_attention_plain(q, k, v, pt, ln,
                                                  return_lse=lse),
                    library, 40)}
        del q, k, v, kc, vc
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        comm.join(comm.start(flash_decode_rank, cs.DIST_RANKS, (tmp,),
                             backend="gloo", init_file=Path(tmp) / "init"),
                  cs.DIST_JOIN_S)
        report["ranks_wall_s"] = time.perf_counter() - t0
        report["ranks"] = [json.loads((Path(tmp) / f"rank{r}.json")
                                      .read_text())
                           for r in range(cs.DIST_RANKS)]
    return report


def serve_model(arch: str):
    def run(torch, np, cs, ctx) -> dict:
        t0 = time.perf_counter()
        out = cs.serve_phase(torch, np, arch)
        out["phase_wall_s"] = time.perf_counter() - t0
        out.pop("outputs")
        t0 = time.perf_counter()
        out["profile"] = cs.profile_serve(torch, np, arch)
        out["profile"]["phase_wall_s"] = time.perf_counter() - t0
        return out
    return run


def cross_model(arch: str):
    def run(torch, np, cs, ctx) -> dict:
        return cs.serve_cross_check(torch, np, arch, cs.SERVE_PATHS[arch][1])
    return run


def ssd(torch, np, cs, ctx) -> dict:
    return {"L189": cs.time_ssd(torch, 189, 40),
            "L4096": cs.time_ssd(torch, cs.LONG_PREFILL, 10)}


def cross_depth(torch, np, cs, ctx) -> dict:
    """mamba2-130m's training check against depth and the weights' draw:
    ``chip_smoke.train_cross_check`` at 16 and at 24 layers, at 24 again
    with the ssd_scan plain versions swapped in on the card (so that both
    sides run the same scan arithmetic), and both at 24 from weights drawn
    on the card (a CUDA generator, as the smoke drew them before its CPU
    halves moved to a worker) instead of the CPU, each read rather than
    failed: the card against the CPU tier, and both against the float64
    run."""
    import contextlib

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import init_model
    from repro_torch.training.tree import tree_map

    @contextlib.contextmanager
    def plain_scan():
        fwd, bwd = ops._forward, ops.ssd_scan_bwd
        ops._forward = lambda x, dt, a, b, c, ck, state_dt: \
            ops.ssd_scan_plain(x, dt, a, b, c, ck=ck, state_dt=state_dt)
        ops.ssd_scan_bwd = lambda *args, ck=ops.DEFAULT_CK: \
            ops.ssd_scan_bwd_plain(*args, ck=ck)
        try:
            yield
        finally:
            ops._forward, ops.ssd_scan_bwd = fwd, bwd

    cpu_setup = cs.cross_setup

    def card_setup(torch, np, arch):
        cfg, _, batch = cpu_setup(torch, np, arch)
        return cfg, tree_map(lambda p: p.cpu(), init_model(
            cfg, 0, compute_device="cuda")), batch

    arch, keep = "mamba2_130m", cs.CROSS_TRAIN["mamba2_130m"]
    out, cpu = {}, {}
    try:
        for name, depth, scan, setup in (
                ("16", 16, contextlib.nullcontext, cpu_setup),
                ("24", 24, contextlib.nullcontext, cpu_setup),
                ("24_plain_scan", 24, plain_scan, cpu_setup),
                ("24_card_draw", 24, contextlib.nullcontext, card_setup),
                ("24_card_draw_plain_scan", 24, plain_scan, card_setup)):
            cs.CROSS_TRAIN[arch] = (depth,) + keep[1:]
            cs.cross_setup = setup
            if (depth, setup) not in cpu:
                cpu = {(depth, setup): cs.cross_train_cpu(arch)}
            with scan():
                try:
                    r = cs.train_cross_check(torch, np, arch,
                                             cpu[depth, setup])
                    r["passed"] = True
                except SystemExit as e:   # fail() carries the report
                    msg = str(e)
                    r = json.loads(msg[msg.index("{"):])
                    r["passed"] = False
            out[name] = {k: v for k, v in r.items()
                         if k != "params_apart_by_leaf"}
            torch.cuda.empty_cache()
    finally:
        cs.CROSS_TRAIN[arch], cs.cross_setup = keep, cpu_setup
    return out


def ssd_bwd(torch, np, cs, ctx) -> dict:
    return {"ptxas": ptxas_summary("ssd_scan_bwd"),
            "train": cs.time_ssd_bwd(torch, cs.TRAIN_BATCH, cs.TRAIN_SEQ, 40),
            "L4096": cs.time_ssd_bwd(torch, 1, cs.LONG_PREFILL, 4)}


def edge_ssd_bwd(torch, np, cs, ctx) -> dict:
    err, rel = cs.edge_ssd_bwd(torch)
    return {"max_abs_err": err, "max_rel_err_by_dtype": rel,
            "cases": len(cs.ssd_bwd_cases())}


def seekrandom(torch, np, cs, ctx) -> dict:
    from repro_torch import kernels
    from repro_torch.bench_kv import db_bench
    from repro_torch.core.uids import reset_uid_counters
    reset_uid_counters()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = db_bench.main(["--bench", "seekrandom"])
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "launches": kernels.launch_counts(),
            "rows": [cs.strip_volatile(r) for r in rows]}


def serve_sweep(torch, np, cs, ctx) -> dict:
    from repro_torch import kernels
    from repro_torch.bench_kv import db_bench
    want = [r for r in json.loads((ROOT / "BENCH_dbbench.json").read_text())
            if r["bench"] == "serve_sweep"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = db_bench.main(["--bench", "serve_sweep"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    flips: list = []
    got = [r for r in rows if r["bench"] == "serve_sweep"]
    if len(got) != len(want):
        cs.fail(f"serve_sweep: {len(got)} rows, {len(want)} committed")
    for i, (g, w) in enumerate(zip(got, want)):
        cs.compare_row(cs.strip_volatile(g), cs.strip_volatile(w),
                       f"{i}:serve_sweep:{w['policy']}", flips)
    return {"wall_s": wall, "launches": launches, "rows": len(got),
            "last_digit_flips": flips, "perf_trajectory": rows[-1]}


def serve_open(torch, np, cs, ctx) -> dict:
    memo: dict = {}
    return {p: cs.serve_open(torch, np, p, memo) for p in cs.SERVE_POLICIES}


def profiles(torch, np, cs, ctx) -> dict:
    return {"vlsm": cs.profile_main_path(torch, np, _trace(ctx, np, cs)),
            "serve_open": cs.profile_serve_open(torch, np)}


def window(torch, np, cs, ctx) -> dict:
    """``device_ms`` read three times in a row for each function that
    merge_path's, overlap_scan's and lindley_scan's main shapes, ssd_scan
    and flash_attention at 4,096 tokens and paged_attention's long decode
    time, each reading with the device events torch.profiler recorded:
    how far the readings of one function spread within a call, and
    whether the profiler's window held every call's kernels."""
    from torch.profiler import ProfilerActivity, profile
    seen: list = []

    def device_ms(torch, fn, reps):
        fn()
        torch.cuda.synchronize()
        readings = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rows = cs.kernel_times_us(prof)
            readings.append({"ms": sum(us for _, us, _ in rows) / reps / 1e3,
                             "events": sum(c for _, _, c in rows),
                             "reps": reps})
        seen.append(readings)
        return (readings[0]["ms"] or None,
                readings[0]["events"] / readings[0]["reps"])

    out: dict = {"card_state": cs.card_query(cs.CARD_STATE)}
    trace = _trace(ctx, np, cs)
    service = np.random.default_rng(4).exponential(2e-5, trace[2].size)
    orig = cs.device_ms
    cs.device_ms = device_ms
    try:
        for name, run in (
                ("merge_main", lambda: cs.time_merge_at(torch, np, trace,
                                                        *MAIN_MERGE)),
                ("rank_main", lambda: cs.time_rank_at(torch, np, trace,
                                                      *MAIN_RANK)),
                ("lindley_queue", lambda: cs.time_lindley(
                    torch, np, service, trace[2])),
                ("ssd_4096", lambda: cs.time_ssd(torch, cs.LONG_PREFILL, 10)),
                ("flash_4096", lambda: cs.time_flash(torch, cs.LONG_PREFILL,
                                                     10)),
                ("paged_long_b8", lambda: cs.time_paged_long(torch, 20))):
            seen.clear()
            run()
            # one entry a time_all call: kernel, plain, library (if any)
            out[name] = list(seen)
    finally:
        cs.device_ms = orig
    return out


def clocks(torch, np, cs, ctx) -> dict:
    """The kernel's ``device_ms`` of merge_path's, lindley_scan's and
    ssd_scan's main calls, read after a second of an idle card and after a
    second of a busy one (bf16 products), twice each, over 50 times the
    smoke's calls, with the card's SM clock sampled every 10 ms by
    nvidia-smi during each reading and the mean kernel duration of the
    first and last tenth of the calls: whether the device time of a kernel
    whose wrapper leaves the card idle between calls follows the clock the
    card's power management picks."""
    import datetime
    import subprocess
    from torch.profiler import ProfilerActivity, profile
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "10"],
        stdout=subprocess.PIPE, text=True)
    big = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    orig = cs.device_ms
    state: dict = {}

    def device_ms(torch, fn, reps):
        if state["readings"] is not None:
            return orig(torch, fn, reps)
        readings = state["readings"] = []
        for mode in ("idle", "busy", "idle", "busy"):
            torch.cuda.synchronize()
            end = time.perf_counter() + 1.0
            while time.perf_counter() < end:
                if mode == "busy":
                    big @ big
                    torch.cuda.synchronize()
                else:
                    time.sleep(0.01)
            t0 = time.time()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(50 * reps):
                    fn()
                torch.cuda.synchronize()
            t1 = time.time()
            us = [e.time_range.elapsed_us() for e in sorted(
                (e for e in prof.events()
                 if "CUDA" in str(getattr(e, "device_type", ""))),
                key=lambda e: e.time_range.start)]
            tenth = max(1, len(us) // 10)
            readings.append({
                "mode": mode, "t": (t0, t1), "calls": 50 * reps,
                "ms": sum(us) / (50 * reps) / 1e3, "events": len(us),
                "first_tenth_us": sum(us[:tenth]) / tenth,
                "last_tenth_us": sum(us[-tenth:]) / tenth})
        return readings[0]["ms"], readings[0]["events"] / readings[0]["calls"]

    out: dict = {}
    trace = _trace(ctx, np, cs)
    service = np.random.default_rng(4).exponential(2e-5, trace[2].size)
    cs.device_ms = device_ms
    try:
        for name, run in (
                ("merge_main", lambda: cs.time_merge_at(torch, np, trace,
                                                        *MAIN_MERGE)),
                ("lindley_queue", lambda: cs.time_lindley(
                    torch, np, service, trace[2])),
                ("ssd_4096", lambda: cs.time_ssd(torch, cs.LONG_PREFILL,
                                                 10))):
            state["readings"] = None
            run()
            out[name] = state["readings"]
    finally:
        cs.device_ms = orig
        time.sleep(0.1)
        smi.terminate()
    samples = []
    for line in smi.communicate()[0].splitlines():
        try:
            ts, mhz, util = (f.strip() for f in line.split(","))
            samples.append((datetime.datetime.strptime(
                ts, "%Y/%m/%d %H:%M:%S.%f").timestamp(), float(mhz),
                float(util)))
        except ValueError:
            continue
    for readings in out.values():
        for r in readings:
            t0, t1 = r.pop("t")
            mhz = sorted(m for t, m, _ in samples if t0 <= t <= t1)
            r["sm_mhz"] = ((mhz[0], mhz[len(mhz) // 2], mhz[-1])
                           if mhz else None)
            r["samples"] = len(mhz)
    out["samples"] = len(samples)
    return out


def lookup_probe(torch, np, cs, ctx) -> dict:
    from port_bench import harness
    from repro_torch.core.types import OpKind
    from repro_torch.kernels.overlap_scan import ops
    _cell, spec, traffic = harness.cell_files("vlsm.ycsb_b.served")
    launches = ops.lookup_probe.launches
    t0 = time.perf_counter()
    with cs.GetBatches() as gets:   # set-up serves the warm batches
        entry = harness.entry_module("served").Entry(spec, traffic,
                                                     2 ** 31 + 5)
    setup_s = time.perf_counter() - t0
    get_batches = gets.report()["calls"]
    if ops.lookup_probe.launches - launches != get_batches:
        cs.fail(f"lookup_probe: {ops.lookup_probe.launches - launches} "
                f"launches for {get_batches} GET batches")
    tree = entry.store.shards[0]
    batch = entry.batches[entry.warm]
    keys = np.ascontiguousarray(batch.keys[batch.kinds == OpKind.GET])
    runs = tree.probe_runs()
    fpr = tree.cfg.bloom_fpr
    dev = torch.device("cuda")
    k_dev = torch.from_numpy(keys).to(dev)
    got = ops.lookup_probe(keys, runs, fpr, dev)
    cs.check_equal(torch, "lookup_probe on the B cell's tree", got,
                   ops.lookup_probe_plain(k_dev, runs, fpr))
    got = got.cpu().numpy()
    n = int(keys.shape[0])
    nbytes = cs.probe_bytes(torch, k_dev, runs)
    kinds = [r.kind for r in runs]
    out = {"shape": f"{n} GETs over {len(runs)} runs",
           "runs": {"memtables": kinds.count(ops.MEMTABLE),
                    "l0": kinds.count(ops.L0_SST),
                    "levels": [int(r.keys.shape[0]) for r in runs
                               if r.kind == ops.LEVEL]},
           "equal": True, "setup_s": setup_s,
           "warm_get_batches": get_batches,
           "hits": int((got[0] >= 0).sum()), "probed": int(got[2].sum()),
           "reads": int(got[1].sum()), "bytes": nbytes,
           "bound_ms": cs.bound_ms(nbytes)}
    out.update(cs.time_all(
        torch, lambda: ops.lookup_probe(keys, runs, fpr, dev),
        lambda: ops.lookup_probe_plain(k_dev, runs, fpr), None, 200))
    out["passes"] = cs.pass_ms(
        torch, lambda: ops.lookup_probe(keys, runs, fpr, dev), 200)
    walls = []
    for _ in range(50):
        t = time.perf_counter()
        tree._lookup_batch(keys)
        walls.append((time.perf_counter() - t) * 1e3)
    walls.sort()
    out["lookup_batch_ms"] = walls[len(walls) // 2]
    return out


def shard_store(torch, np, cs, ctx) -> dict:
    want = {n: cs.shard_run(np, "cpu", n)[0] for n in (cs.SHARD_COUNT, 1)}
    return cs.shard_store_check(np, cs.shard_card_runs(torch, np), want)


STORE = ("merge_path", "overlap_scan", "lindley_scan")
LM = ("overlap_scan", "flash_attention", "paged_attention")
TRAIN = ("flash_attention", "flash_attention_bwd")
SSM = ("ssd_scan", "ssd_scan_bwd")
# phase: (kernels it builds, what it runs)
PHASES = {
    "edge_merge": (("merge_path",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_merge(torch, np, np.random.default_rng(0))}),
    "edge_rank": (("overlap_scan",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_rank(torch, np, np.random.default_rng(0))}),
    "edge_lindley": (("lindley_scan",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_lindley(torch, np,
                                       np.random.default_rng(0))}),
    "edge_flash": (("flash_attention",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_flash(torch)}),
    "edge_ssd": (("ssd_scan",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_ssd(torch)}),
    "edge_paged": (("paged_attention",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_paged(torch, np)}),
    "edge_flash_cross": (("flash_attention",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_flash_cross(torch)}),
    "edge_flash_bwd": (("flash_attention", "flash_attention_bwd"),
                       lambda torch, np, cs, ctx: {
                           "max_abs_err": cs.edge_flash_bwd(torch),
                           "cases": len(cs.bwd_cases())}),
    "edge_paged_cross": (("paged_attention",), lambda torch, np, cs, ctx: {
        "max_abs_err": cs.edge_paged_cross(torch)}),
    "edge_ssd_bwd": (("ssd_scan_bwd",), edge_ssd_bwd),
    "states": (("ssd_scan", "flash_attention", "paged_attention"),
               lambda torch, np, cs, ctx: cs.serve_state_check(torch, np)),
    "merge": (("merge_path",), merge),
    "rank": (("overlap_scan",), rank),
    "lindley": (("lindley_scan",), lindley),
    "flash": (("flash_attention",), flash),
    "paged": (("paged_attention",), paged),
    "ssd": (("ssd_scan",), ssd),
    "ssd_bwd": (("ssd_scan_bwd",), ssd_bwd),
    "flash_bwd": (("flash_attention", "flash_attention_bwd"), flash_bwd),
    "whisper_bwd": (("flash_attention", "flash_attention_bwd"), whisper_bwd),
    "whisper_flash": (("flash_attention",), whisper_flash),
    "gemma3": (("flash_attention", "paged_attention"), gemma3),
    "gemma3_bwd": (TRAIN, gemma3_bwd),
    "gemma3_bwd_unsplit": (TRAIN, gemma3_bwd_unsplit),
    "flash_decode": (("paged_attention",), flash_decode),
    "distributed": (STORE + LM + TRAIN, lambda torch, np, cs, ctx:
                    cs.distributed_phase(torch)),
    "serve_zamba2": (LM + ("ssd_scan",), serve_model("zamba2_1_2b")),
    "serve_qwen3": (LM, serve_model("qwen3_1_7b")),
    "serve_gemma3": (LM, serve_model("gemma3_1b")),
    "serve_deepseek": (LM, serve_model("deepseek_v2_lite")),
    "serve_whisper": (LM, serve_model("whisper_tiny")),
    "serve_llama3": (LM, serve_model("llama3_2_3b")),
    "serve_yi": (LM, serve_model("yi_6b")),
    "serve_qwen2vl": (LM, serve_model("qwen2_vl_2b")),
    "serve_mamba2": (LM + ("ssd_scan",), serve_model("mamba2_130m")),
    "train_qwen3": (TRAIN, lambda torch, np, cs, ctx:
                    cs.train_qwen3(torch, np)),
    "train_qwen3_long": (TRAIN, train_qwen3_long),
    "train_zamba2": (TRAIN + SSM, train_zamba2),
    "train_gemma3": (TRAIN, lambda torch, np, cs, ctx:
                     cs.train_gemma3(torch, np)),
    "train_gemma3_long": (TRAIN, train_gemma3_long),
    "train_deepseek": (TRAIN, lambda torch, np, cs, ctx:
                       cs.train_deepseek(torch, np)),
    "train_whisper": (TRAIN + STORE, lambda torch, np, cs, ctx:
                      cs.train_whisper(torch, np)),
    "cross_train": (TRAIN + SSM, lambda torch, np, cs, ctx: {
        arch: cs.train_cross_check(torch, np, arch)
        for arch in cs.CROSS_TRAIN}),
    "cross_train_ssm": (TRAIN + SSM, lambda torch, np, cs, ctx: {
        arch: cs.train_cross_check(torch, np, arch)
        for arch in ("zamba2_1_2b", "mamba2_130m")}),
    "cross_train_worker": ((), cross_train_worker),
    "cross_train_new": (TRAIN + SSM, lambda torch, np, cs, ctx: {
        arch: cs.train_cross_check(torch, np, arch)
        for arch in ("gemma3_1b", "deepseek_v2_lite")}),
    "cross_depth": (TRAIN + SSM, cross_depth),
    "cross_whisper": (LM, cross_model("whisper_tiny")),
    "fleet_matrix": (STORE, fleet_matrix),
    "long_decode": (LM, lambda torch, np, cs, ctx:
                    cs.long_window_decode(torch, np)),
    "cross_gemma3": (LM, cross_model("gemma3_1b")),
    "cross_deepseek": (LM, cross_model("deepseek_v2_lite")),
    "cross_llama3": (LM, cross_model("llama3_2_3b")),
    "cross_yi": (LM, cross_model("yi_6b")),
    "cross_qwen2vl": (LM, cross_model("qwen2_vl_2b")),
    "cross_mamba2": (LM + ("ssd_scan",), cross_model("mamba2_130m")),
    "seekrandom": (STORE, seekrandom),
    "serve_sweep": (STORE, serve_sweep),
    "serve_open": (STORE, serve_open),
    "profiles": (STORE, profiles),
    "shard_store": (STORE, shard_store),
    "lookup_probe": (STORE, lookup_probe),
    "window": (STORE + ("flash_attention", "ssd_scan", "paged_attention"),
               window),
    "clocks": (STORE + ("ssd_scan",), clocks),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", choices=sorted(PHASES),
                    metavar="PHASE", help=" ".join(PHASES))
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch to run")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the JSON report")
    ap.add_argument("--predict", default=None,
                    help="the run's prediction, printed before it runs")
    args = ap.parse_args()
    if args.predict:
        print("prediction:", args.predict, flush=True)
    import torch
    if not torch.cuda.is_available():
        print("probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.src.resolve()))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.card_line(), "src", args.src, flush=True)
    names = tuple(dict.fromkeys(k for p in args.phases for k in PHASES[p][0]))
    t0 = time.time()
    try:
        _build.build(names)
    finally:
        for name, log in _build.ptxas_reports.items():
            print(f"== {name} ==\n" + "\n".join(
                ln for ln in log.splitlines()
                if "Used" in ln or "Function properties" in ln
                or "error" in ln.lower()
                or "warning" in ln.lower() or "spill" in ln), flush=True)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    out: dict = {"card": cs.card_line(), "src": str(args.src)}
    ctx: dict = {}
    bad = 0
    for phase in args.phases:
        t0 = time.time()
        try:
            out[phase] = PHASES[phase][1](torch, np, cs, ctx)
            torch.cuda.synchronize()
            print(f"{phase}: ok in {time.time() - t0:.1f}s "
                  + json.dumps(out[phase], default=str), flush=True)
        except (Exception, SystemExit):     # a failed check exits via fail()
            bad += 1
            print(f"{phase}: FAILED", flush=True)
            traceback.print_exc()
            sys.stdout.flush()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        tag = "-".join(args.phases)
        if args.src != ROOT / "src":
            tag += f"-{args.src.resolve().parent.name}"
        (args.out / f"probe-{tag}.json").write_text(
            json.dumps(out, indent=1, default=str))
    print("BAD", bad, flush=True)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
