"""Port of the decoder family against the JAX reference on the CPU, at
smoke size: qwen3-1.7b (qk-norm; 4 query heads over 4 kv heads, and over 2
so that GQA is covered), llama3.2-3b, yi-6b (untied ``lm_head``),
qwen2-vl-2b (M-RoPE), gemma3-1b (sliding window 16 on every other layer,
dual RoPE theta, sandwich norms; also at its real head_dim of 256, with a
cache of two 32-token pages and of one 48-token page: decode at positions
37-40 moves the window's first token across tokens 22-25 while the last
crosses no page edge, and the window spans the page edge at 32) and
deepseek-v2 (MLA and MoE routing with a dense first layer; the lite and
the 236b configs, the same at smoke size; decode both absorbed and
expanded).

The reference initialises its parameters; ``params_from_jax`` carries them
across, so both packages compute the same function.  The reference runs
its plain route (``forward(..., use_pallas=False)``): its Pallas route
cannot run a scanned decoder (``int(window)`` on a tracer), and its serve
loop uses the plain route too.  The port runs its kernel wrappers, which
take the plain versions for CPU tensors: flash_attention in the prefill,
paged_attention in every decode step.  Everything is float32.

Tolerance: ``max|Δ| <= 5e-5 * max(1, max|ref|)`` on every tensor, the one
``test_torch_models.py`` states (fp32 rounding through the layers; RoPE
angles of ~100 rad move by ~1e-5 rad when the two frameworks' ``pow``
differ by one ulp).  Greedy tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro.configs import get_config
from repro.models import decode_step as ref_decode
from repro.models import forward as ref_forward
from repro.models import init_model as ref_init
from repro_torch.models import (decode_step, forward, init_cache, init_model,
                                params_from_jax)

RTOL = 5e-5
S = 37
# (arch, config overrides, cache length): 64 gives the decode cache two
# 32-token pages, 48 one page of 48 tokens (32 does not divide it)
ARCHS = {"qwen3": ("qwen3_1_7b", {}, 64),
         "qwen3-gqa": ("qwen3_1_7b", {"n_kv_heads": 2}, 48),
         "llama3.2": ("llama3_2_3b", {}, 64),
         "yi": ("yi_6b", {}, 48),
         "qwen2-vl": ("qwen2_vl_2b", {}, 64),
         "gemma3": ("gemma3_1b", {}, 64),
         "gemma3-d256": ("gemma3_1b", {"head_dim": 256}, 64),
         "gemma3-d256-one-page": ("gemma3_1b", {"head_dim": 256}, 48),
         "deepseek-v2-lite": ("deepseek_v2_lite", {}, 64),
         "deepseek-v2-236b": ("deepseek_v2_236b", {}, 48)}
CACHE_KEYS = {"gqa": {"k", "v", "pos"},
              "mla": {"ckv", "kr", "d_ckv", "d_kr", "pos"}}


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want)) if want.size else 0.0
    assert err <= RTOL * max(1.0, np.max(np.abs(want))), (what, err)


def _configs(arch, overrides):
    return (get_config(arch).smoke().with_(**overrides),
            port_configs.get_config(arch).smoke().with_(**overrides))


@pytest.fixture(scope="module", params=list(ARCHS), ids=list(ARCHS))
def pair(request):
    arch, overrides, cache_len = ARCHS[request.param]
    cfg, tcfg = _configs(arch, overrides)
    rp = ref_init(cfg, jax.random.PRNGKey(3))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    rl, rc = ref_forward(cfg, rp, {"tokens": jnp.asarray(toks)},
                         mode="prefill", use_pallas=False,
                         cache_len=cache_len)
    return cfg, tcfg, rp, tp, toks, cache_len, rl, rc


def test_prefill_logits_and_cache(pair):
    cfg, tcfg, _rp, tp, toks, cache_len, rl, rc = pair
    tl, tc = forward(tcfg, tp, {"tokens": toks}, cache_len=cache_len,
                     compute_device="cpu")
    _close(tl, rl, "logits")
    assert set(tc) == set(rc) == CACHE_KEYS[cfg.attn_kind]
    for k in rc:
        _close(tc[k], rc[k], k)
    empty = init_cache(tcfg, 2, cache_len, compute_device="cpu")
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}


def test_four_decode_steps(pair):
    """Four greedy steps from the prefill's cache; MLA in both decode
    forms, each from its own copy of the cache."""
    cfg, tcfg, rp, tp, toks, cache_len, rl, rc0 = pair
    for absorbed in ((True, False) if cfg.attn_kind == "mla" else (True,)):
        rc = rc0
        _, tc = forward(tcfg, tp, {"tokens": toks}, cache_len=cache_len,
                        compute_device="cpu")
        tok_r = jnp.argmax(rl[:, -1:], -1).astype(jnp.int32)
        tok_t = torch.from_numpy(np.array(tok_r))
        pos = np.full(2, S, np.int32)
        for step in range(4):
            what = f"decode step {step} (absorbed={absorbed})"
            rl2, rc = ref_decode(cfg, rp, tok_r, jnp.asarray(pos + step), rc,
                                 absorbed_mla=absorbed)
            tl2, tc = decode_step(tcfg, tp, tok_t,
                                  torch.from_numpy(pos + step), tc,
                                  absorbed_mla=absorbed, compute_device="cpu")
            _close(tl2, rl2, f"{what} logits")
            for k in rc:
                _close(tc[k], rc[k], f"{what} {k}")
            tok_r = jnp.argmax(rl2[:, -1:], -1).astype(jnp.int32)
            tok_t = torch.argmax(tl2[:, -1:], -1)
            np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_r))


def test_seeded_init_matches_the_layout(pair):
    cfg, tcfg, rp, *_ = pair
    port = init_model(tcfg, 0, compute_device="cpu")
    ref_shapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)), rp)
    port_shapes = jax.tree.map(lambda x: (tuple(x.shape),
                                          str(x.dtype).split(".")[1]), port)
    assert port_shapes == ref_shapes
    assert ("lm_head" in port) == (not tcfg.tie_embeddings)


def test_embeds_and_mrope_positions():
    """qwen2-vl's backbone fed stub patch embeddings with distinct
    temporal/height/width positions (the ViT stays a stub, as in the
    reference)."""
    cfg, tcfg = _configs("qwen2_vl_2b", {})
    rp = ref_init(cfg, jax.random.PRNGKey(5))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    rng = np.random.default_rng(4)
    embeds = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    positions = rng.integers(0, 3 * S, (2, S, 3)).astype(np.int32)
    rl, rc = ref_forward(cfg, rp, {"embeds": jnp.asarray(embeds),
                                   "positions": jnp.asarray(positions)},
                         mode="prefill", use_pallas=False, cache_len=64)
    tl, tc = forward(tcfg, tp, {"embeds": embeds, "positions": positions},
                     cache_len=64, compute_device="cpu")
    _close(tl, rl, "logits")
    for k in rc:
        _close(tc[k], rc[k], k)


def test_params_from_jax_checks_the_decoder_layout():
    """yi's untied ``lm_head`` is carried across; a pytree without it, or
    with a layer of the wrong width, is refused."""
    cfg, tcfg = _configs("yi_6b", {})
    tree = jax.tree.map(np.asarray, ref_init(cfg, jax.random.PRNGKey(1)))
    params = params_from_jax(tcfg, tree, compute_device="cpu")
    np.testing.assert_array_equal(params["lm_head"].numpy(),
                                  tree["lm_head"])
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tcfg, missing, compute_device="cpu")
    narrow = jax.tree.map(lambda x: x, tree)
    narrow["layers"]["mlp"]["w_up"] = tree["layers"]["mlp"]["w_up"][..., :8]
    with pytest.raises(ValueError, match="w_up"):
        params_from_jax(tcfg, narrow, compute_device="cpu")
