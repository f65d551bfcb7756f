"""Serving entry point: prefill + greedy decode with the LSM-backed prefix
cache and the paged KV pool — the port of ``repro/launch/serve.py``, step
for step.

Every admitted prompt first consults the PrefixCache (a vLSM-indexed
``LSMTree`` whose GETs run the overlap_scan kernel), which counts the
reused prefix; the full prompt is then prefilled (the flash_attention
kernel, and ssd_scan for the ssm and hybrid families) and decoded greedily,
every decode attention through the paged_attention kernel over the dense
cache.  whisper's requests carry seeded stub frame embeddings
(``default_rng(request id)``, as in the reference) through its encoder.
As in the reference, the page pool's own pages are allocated and
registered with the prefix cache but not read.  Admission is a token
bucket on a seeded Poisson timeline, so the admitted/rejected split is
deterministic per (seed, rate, limit).  Runs on the card unless
``compute_device="cpu"``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \\
        --requests 8 --decode 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.types import resolve_compute_device
from ..models import decode_step, forward, init_model
from ..models.common import dtype_of
from ..serving import PagePool, PrefixCache, TokenBucket, poisson_arrivals


def make_requests(n: int, vocab: int, *, prefix_len: int = 128,
                  tail_max: int = 64, seed: int = 0):
    """Requests sharing one of two system prefixes (prefix-cache-friendly)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, prefix_len),
                rng.integers(0, vocab, prefix_len)]
    reqs = []
    for i in range(n):
        pre = prefixes[i % 2]
        tail = rng.integers(0, vocab, int(rng.integers(8, tail_max)))
        reqs.append(np.concatenate([pre, tail]).astype(np.int32))
    return reqs


def run(arch: str, *, smoke: bool = True, n_requests: int = 8,
        decode_tokens: int = 16, block_tokens: int = 32,
        max_seq: int = 512, seed: int = 0, rate_ops_s: float = 50.0,
        limit_ops_s: float = 0.0, burst_ops: float = 4.0,
        compute_device: str | torch.device = "cuda",
        params: dict | None = None) -> dict:
    """Serve ``n_requests`` of ``arch``.  ``params`` (e.g. carried across
    from the reference with ``models.params_from_jax``) replaces the seeded
    initialisation.  Returns the reference's ``outputs`` and ``stats``;
    ``stats`` also holds per-request ``prefill_ms`` and ``decode_ms``."""
    dev = resolve_compute_device(compute_device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if params is None:
        params = init_model(cfg, seed, compute_device=dev)

    pool = PagePool(n_pages=256, page_size=block_tokens,
                    n_layers=max(cfg.n_layers, 1),
                    n_kv_heads=max(cfg.n_kv_heads, 1),
                    head_dim=max(cfg.head_dim, 1), compute_device=dev)
    pcache = PrefixCache(pool, block_tokens=block_tokens, compute_device=dev)

    reqs = make_requests(n_requests, cfg.vocab_size, seed=seed)
    arrivals = poisson_arrivals(n_requests, rate_ops_s,
                                np.random.default_rng(seed + 1))
    bucket = TokenBucket(rate_ops_s=limit_ops_s, burst_ops=burst_ops)
    stats = {"prefix_hits": 0, "tokens_prefilled": 0, "tokens_reused": 0,
             "requests_offered": n_requests, "requests_admitted": 0,
             "requests_rejected": 0, "latency_ms": [], "prefill_ms": [],
             "decode_ms": []}
    outputs = []
    for r_id, tokens in enumerate(reqs):
        if not bucket.try_admit(float(arrivals[r_id])):
            stats["requests_rejected"] += 1
            continue
        stats["requests_admitted"] += 1
        t0 = time.monotonic()
        matched, _pages = pcache.match(tokens)
        stats["tokens_reused"] += matched
        if matched:
            stats["prefix_hits"] += 1
        # the full prompt is prefilled: the prefix cache counts reuse
        batch = {"tokens": torch.from_numpy(tokens[None]).to(dev)}
        if cfg.family == "encdec":
            # whisper's stub frame embeddings, seeded by the request id
            rng = np.random.default_rng(r_id)
            batch["encoder_embeds"] = torch.from_numpy(rng.standard_normal(
                (1, cfg.enc_seq, cfg.d_model))).to(dev, dtype_of(cfg))
        logits, cache = forward(cfg, params, batch, mode="prefill",
                                cache_len=max_seq, compute_device=dev)
        stats["tokens_prefilled"] += len(tokens) - matched
        n_blocks = len(tokens) // block_tokens
        pcache.insert(tokens, [[pool.alloc()] for _ in range(n_blocks)])

        tok = torch.argmax(logits[:, -1:], -1)
        out = [int(tok[0, 0])]              # waits for the prefill
        t1 = time.monotonic()
        pos = torch.tensor([len(tokens)], dtype=torch.int64, device=dev)
        for t in range(decode_tokens - 1):
            lg, cache = decode_step(cfg, params, tok, pos + t, cache,
                                    compute_device=dev)
            tok = torch.argmax(lg[:, -1:], -1)
            out.append(int(tok[0, 0]))
        outputs.append(out)
        t2 = time.monotonic()
        stats["latency_ms"].append((t2 - t0) * 1e3)
        stats["prefill_ms"].append((t1 - t0) * 1e3)
        stats["decode_ms"].append((t2 - t1) * 1e3)

    stats["prefix_cache"] = pcache.stats()
    lat = stats["latency_ms"]
    stats["p50_ms"] = float(np.percentile(lat, 50)) if lat else 0.0
    stats["p99_ms"] = float(np.percentile(lat, 99)) if lat else 0.0
    return {"outputs": outputs, "stats": stats}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="offered request rate (Poisson, ops/s)")
    ap.add_argument("--limit", type=float, default=0.0,
                    help="admission token-bucket rate (ops/s; 0 = off)")
    ap.add_argument("--burst", type=float, default=4.0,
                    help="admission token-bucket burst size (ops)")
    ap.add_argument("--compute-device", default="cuda")
    args = ap.parse_args()
    out = run(args.arch, smoke=args.smoke, n_requests=args.requests,
              decode_tokens=args.decode, rate_ops_s=args.rate,
              limit_ops_s=args.limit, burst_ops=args.burst,
              compute_device=args.compute_device)
    s = out["stats"]
    print(f"served {s['requests_admitted']}/{s['requests_offered']} requests"
          f" ({s['requests_rejected']} rejected);"
          f" prefix hits {s['prefix_hits']}"
          f" reused {s['tokens_reused']} tok; p50 {s['p50_ms']:.0f}ms"
          f" p99 {s['p99_ms']:.0f}ms")
    print("prefix cache:", s["prefix_cache"])


if __name__ == "__main__":
    main()
