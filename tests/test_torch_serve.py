"""Port of the serving path (``launch/serve.py`` and ``serving/``) against
the JAX reference on the CPU.

Both packages serve the same seeded requests of zamba2-1.2b, qwen3-1.7b,
gemma3-1b (sliding windows; the prompts of 136-191 tokens plus 8 decoded
pass its smoke window of 16) and deepseek-v2-lite (MLA, MoE) at smoke size
with the same parameters (the reference's ``init_model`` for the seed,
carried across with ``params_from_jax``).  Greedy outputs, admission
counts and the prefix cache's hits, reuse and stats must be identical: the
prefix cache is a real LSM store in both (the port's GETs run the
overlap_scan wrapper), and every decode attention of the port runs the
paged_attention wrapper.
"""

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro.configs import get_config
from repro.launch import serve as ref_serve
from repro.models import init_model as ref_init
from repro.serving import PagePool as RefPagePool
from repro.serving import TokenBucket as RefTokenBucket
from repro.serving import deterministic_arrivals as ref_det
from repro.serving import poisson_arrivals as ref_poisson
from repro_torch.launch import serve
from repro_torch.models import params_from_jax
from repro_torch.serving import (PagePool, PrefixCache, Sequence,
                                 TokenBucket, deterministic_arrivals,
                                 poisson_arrivals)

KEYS = ("requests_offered", "requests_admitted", "requests_rejected",
        "prefix_hits", "tokens_reused", "tokens_prefilled", "prefix_cache")


@pytest.mark.parametrize("arch,limit,burst", [
    pytest.param("zamba2_1_2b", 0.0, 4.0, id="open"),
    pytest.param("zamba2_1_2b", 5.0, 1.0, id="limited"),
    pytest.param("qwen3_1_7b", 0.0, 4.0, id="qwen3_1_7b-open"),
    pytest.param("qwen3_1_7b", 5.0, 1.0, id="qwen3_1_7b-limited"),
    pytest.param("gemma3_1b", 0.0, 4.0, id="gemma3_1b-open"),
    pytest.param("gemma3_1b", 5.0, 1.0, id="gemma3_1b-limited"),
    pytest.param("deepseek_v2_lite", 0.0, 4.0, id="deepseek_v2_lite-open"),
    pytest.param("deepseek_v2_lite", 5.0, 1.0,
                 id="deepseek_v2_lite-limited")])
def test_serve_matches_reference(arch, limit, burst):
    """The open case serves all 4 requests (2 prefix hits); the limited
    one admits 1 and rejects 3."""
    kw = dict(smoke=True, n_requests=4, decode_tokens=8, seed=0,
              limit_ops_s=limit, burst_ops=burst)
    want = ref_serve.run(arch, **kw)
    cfg = get_config(arch).smoke()
    params = params_from_jax(
        port_configs.get_config(arch).smoke(),
        jax.tree.map(np.asarray, ref_init(cfg, jax.random.PRNGKey(0))),
        compute_device="cpu")
    got = serve.run(arch, compute_device="cpu", params=params, **kw)
    assert got["outputs"] == want["outputs"]
    for k in KEYS:
        assert got["stats"][k] == want["stats"][k], k
    assert len(got["stats"]["latency_ms"]) == got["stats"]["requests_admitted"]


def test_make_requests_matches_reference():
    a = serve.make_requests(6, 512, seed=3)
    b = ref_serve.make_requests(6, 512, seed=3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_page_pool_matches_reference():
    kw = dict(n_pages=4, page_size=2, n_layers=1, n_kv_heads=1, head_dim=2)
    ref, port = RefPagePool(**kw), PagePool(compute_device="cpu", **kw)
    for pool in (ref, port):
        pages = [pool.alloc() for _ in range(3)]
        pool.pin(pages[0])
        pool.release(pages[0])
        pool.release(pages[1])
    assert port.free_pages == ref.free_pages == 2
    assert port.alloc() == ref.alloc()
    np.testing.assert_array_equal(port.refcount, ref.refcount)
    assert tuple(port.k_pages.shape) == ref.k_pages.shape
    assert port.k_pages.dtype == torch.float32
    port.write_tokens(0, 1, 0, torch.ones(2, 1, 2), torch.ones(2, 1, 2))
    assert float(port.k_pages[0, 1].sum()) == 4.0
    pool = PagePool(n_pages=1, page_size=2, n_layers=1, n_kv_heads=1,
                    head_dim=2, compute_device="cpu")
    pool.alloc()
    with pytest.raises(MemoryError):
        pool.alloc()
    seq = Sequence(0, pages=[3], length=5)
    assert [seq.pages_needed(4, n) for n in (0, 3, 4, 12)] == [1, 1, 2, 4]


def test_prefix_cache_longest_match_and_eviction():
    pool = PagePool(n_pages=8, page_size=4, n_layers=1, n_kv_heads=1,
                    head_dim=2, compute_device="cpu")
    pc = PrefixCache(pool, block_tokens=4, compute_device="cpu")
    toks = np.arange(12, dtype=np.int32)
    assert pc.match(toks) == (0, [])
    pages = [[pool.alloc()] for _ in range(3)]
    assert pc.insert(toks, pages) == 3
    assert pc.match(toks) == (12, [p[0] for p in pages])
    assert pc.match(np.concatenate([toks[:8], [99, 98, 97, 96]])) == \
        (8, [pages[0][0], pages[1][0]])
    assert pc.evict_lru(1) == 1
    assert pc.stats()["entries"] == 2


def test_token_bucket_and_arrivals_match_reference():
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    arr = poisson_arrivals(200, 50.0, rng_a)
    np.testing.assert_array_equal(arr, ref_poisson(200, 50.0, rng_b))
    np.testing.assert_array_equal(deterministic_arrivals(7, 3.0),
                                  ref_det(7, 3.0))
    for rate, burst in ((20.0, 2.0), (0.0, 4.0), (100.0, 0.5)):
        port, ref = TokenBucket(rate, burst), RefTokenBucket(rate, burst)
        assert [port.try_admit(float(t)) for t in arr] == \
            [ref.try_admit(float(t)) for t in arr]
