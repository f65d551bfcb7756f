#!/usr/bin/env python3
"""Short chip runs for iterating on the two attention kernels of the
PyTorch/CUDA port (paged_attention, flash_attention) on one GPU.

    python3 scripts/attention_probe.py checks   # build, check, time both
    python3 scripts/attention_probe.py spread   # repeated small timings
    python3 scripts/attention_probe.py flash    # flash_attention only

``checks`` builds both kernels, prints their ``-Xptxas -v`` lines, holds
each against its plain version at small and real shapes (printing every
failure instead of stopping at the first), then times them at the serving
and long shapes with ``chip_smoke.py``'s timing functions and writes the
timings to ``chiprun_out/probe.json``.  ``spread`` repeats the small
timings three times (long decode at 8 and 1 sequences, qwen3's prefill and
decode shapes) and profiles the 1 x 4,096 decode kernel by kernel.
``flash`` runs ``chip_smoke.py``'s flash_attention edge cases and its four
timings.  A kernel's first chip run should be ``checks``: a wgmma
descriptor or swizzle mismatch gives wrong numbers, not a fault.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def checks(torch, np, cs) -> int:
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention, paged_attention_plain, split_plan)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    bad = 0

    def chk(what, kern, got, want):
        nonlocal bad
        atol, rtol = cs.TOL[kern, str(want.dtype).split(".")[1]]
        g, w = got.float(), want.float()
        err = float((g - w).abs().max()) if w.numel() else 0.0
        if not (bool(g.isfinite().all())
                and bool(((g - w).abs() <= atol + rtol * w.abs()).all())):
            bad += 1
            print(f"FAIL {what}: max err {err} max|want| "
                  f"{float(w.abs().max())}", flush=True)
        return err

    worst = 0.0
    # (S, D, GQA rep, window, causal), B 2, 2 kv heads
    for s, d, rep, win, causal in [
            (64, 64, 1, None, True), (64, 128, 1, None, True),
            (63, 64, 1, None, True), (65, 64, 1, None, True),
            (1, 64, 1, None, True), (130, 64, 2, None, True),
            (384, 128, 2, 128, True), (130, 64, 1, None, False),
            (384, 128, 1, 128, False), (189, 64, 1, None, True),
            (189, 128, 2, None, True), (4096, 64, 1, 128, True),
            (1000, 128, 2, None, True), (127, 128, 1, 64, True)]:
        for dt in (torch.bfloat16, torch.float32):
            try:
                q = cs._randn(torch, gen, (2, 2 * rep, s, d), dt)
                k = cs._randn(torch, gen, (2, 2, s, d), dt)
                v = cs._randn(torch, gen, (2, 2, s, d), dt)
                got = flash_attention(q, k, v, causal=causal, window=win)
                torch.cuda.synchronize()
                worst = max(worst, chk(
                    f"flash S={s} D={d} rep={rep} win={win} causal={causal} "
                    f"{dt}", "flash_attention", got,
                    flash_attention_plain(q, k, v, causal=causal,
                                          window=win)))
            except Exception:
                bad += 1
                traceback.print_exc()
    print(f"flash checks done, worst {worst}, bad {bad}", flush=True)
    worst = 0.0
    rng = np.random.default_rng(3)
    # (B, Hkv, G, D, PS, MAXP, lengths); entries past each length garbage
    for b, hkv, g, d, ps, maxp, lens in [
            (1, 2, 1, 64, 16, 5, [80]), (3, 2, 2, 128, 32, 5, [0, 1, 160]),
            (2, 2, 8, 64, 16, 5, [17, 33]), (3, 2, 3, 128, 16, 5, [0, 0, 0]),
            (1, 8, 2, 128, 32, 16, [204]), (1, 32, 1, 64, 32, 16, [204]),
            (1, 8, 2, 128, 32, 128, [4096]),
            (2, 8, 2, 128, 32, 128, [4095, 4096]),
            (4, 8, 2, 128, 32, 16, [31, 32, 33, 64]),
            (2, 2, 6, 64, 16, 40, [639, 640])]:
        for dt in (torch.bfloat16, torch.float32):
            try:
                n_pages = 3 * maxp
                table = rng.integers(0, n_pages, (b, maxp))
                for row, n in enumerate(lens):
                    table[row, -(-n // ps):] = (-1, 2 ** 30)[row % 2]
                q = cs._randn(torch, gen, (b, g * hkv, d), dt)
                kp = cs._randn(torch, gen, (n_pages, ps, hkv, d), dt)
                vp = cs._randn(torch, gen, (n_pages, ps, hkv, d), dt)
                pt = torch.tensor(table, dtype=torch.int32, device="cuda")
                ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
                got = paged_attention(q, kp, vp, pt, ln)
                torch.cuda.synchronize()
                plan = split_plan(maxp * ps, b, hkv, 132)
                worst = max(worst, chk(
                    f"paged B={b} hkv={hkv} G={g} D={d} PS={ps} MAXP={maxp} "
                    f"lens={lens} plan={plan} {dt}", "paged_attention", got,
                    paged_attention_plain(q, kp, vp, pt, ln)))
            except Exception:
                bad += 1
                traceback.print_exc()
    print(f"paged checks done, worst {worst}, bad {bad}", flush=True)
    out = {}
    for name, fn, args in (
            ("flash_zamba2_189", cs.time_flash, (189, 40)),
            ("flash_qwen3_189", cs.time_flash, (189, 40, 16, 8, 128)),
            ("flash_4096_d64", cs.time_flash, (4096, 10)),
            ("flash_4096_qwen3", cs.time_flash, (4096, 10, 16, 8, 128)),
            ("paged_qwen3_204", cs.time_paged, (204, 200)),
            ("paged_zamba2_204", cs.time_paged, (204, 200, 32, 32, 64)),
            ("paged_long", cs.time_paged_long, (20,)),
            ("paged_long_b1", cs.time_paged_long, (40, 1))):
        try:
            r = out[name] = fn(torch, *args)
            print(name, json.dumps({k: r[k] for k in (
                "shape", "max_abs_err", "bound_ms", "ms", "device_ms",
                "library_ms", "library_device_ms") if k in r}), flush=True)
        except BaseException as e:      # a failed check exits via fail()
            bad += 1
            print(f"TIMING FAIL {name}: {e!r}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe.json").write_text(
        json.dumps(out, indent=1, default=str))
    print("BAD", bad, flush=True)
    return int(bad > 0)


def spread(torch, np, cs) -> int:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.paged_attention.ops import paged_attention
    keys = ("ms", "device_ms", "library_ms", "library_device_ms")
    for rnd in range(3):
        for name, fn, args in (
                ("b8", cs.time_paged_long, (20,)),
                ("b1", cs.time_paged_long, (40, 1)),
                ("flash_qwen3_189", cs.time_flash, (189, 40, 16, 8, 128)),
                ("paged_qwen3_204", cs.time_paged, (204, 200))):
            r = fn(torch, *args)
            print(rnd, name, json.dumps({k: r[k] for k in keys}), flush=True)
    # the 1 x 4,096 decode alone under the profiler, kernel by kernel
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    kp, vp = (torch.randn((2048, 32, 8, 128), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((1, 16, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    pt = torch.randperm(2048, generator=gen, device="cuda")[:128].view(
        1, 128).to(torch.int32)
    ln = torch.full((1,), 4096, dtype=torch.int32, device="cuda")
    for _ in range(3):
        paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(40):
            paged_attention(q, kp, vp, pt, ln)
        torch.cuda.synchronize()
    for n, us, c in cs.kernel_times_us(prof):
        print("prof", n[:60], us / c, c, flush=True)
    return 0


def flash(torch, np, cs) -> int:
    t0 = time.time()
    print("edge worst", cs.edge_flash(torch), f"{time.time() - t0:.1f}s",
          flush=True)
    keys = ("ms", "device_ms", "library_ms", "library_device_ms",
            "max_abs_err")
    for name, args in (("4096_d64", (4096, 10)),
                       ("4096_qwen3", (4096, 10, 16, 8, 128)),
                       ("189_d64", (189, 40)),
                       ("189_qwen3", (189, 40, 16, 8, 128))):
        r = cs.time_flash(torch, *args)
        print(name, json.dumps({k: r[k] for k in keys}), flush=True)
    return 0


MODES = {"checks": (checks, ("flash_attention", "paged_attention")),
         "spread": (spread, ("flash_attention", "paged_attention")),
         "flash": (flash, ("flash_attention",))}


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "checks"
    if mode not in MODES:
        print(f"usage: {sys.argv[0]} [{'|'.join(MODES)}]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("attention_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build
    fn, names = MODES[mode]
    print(cs.card_line(), flush=True)
    t0 = time.time()
    try:
        _build.build(names)
    finally:
        for name, log in _build.ptxas_reports.items():
            print(f"== {name} ==\n" + "\n".join(
                ln for ln in log.splitlines()
                if "Used" in ln or "error" in ln.lower()
                or "warning" in ln.lower()), flush=True)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    return fn(torch, np, cs)


if __name__ == "__main__":
    sys.exit(main())
