"""Port of whisper's encoder-decoder (the encdec family) against the JAX
reference on the CPU, at whisper-tiny's smoke size (2 encoder and 2
decoder layers, 32 encoder frames, float32).

The reference initialises its parameters; ``params_from_jax`` carries them
across.  The port's encoder and cross attention run the flash_attention
wrapper (non-causal, Sk = the encoder's frames), its decode the
paged_attention wrapper over the self cache and over the cross cache (the
frames padded to a whole page: 32 rows here, 1,504 for 1,500 at full
size); on CPU tensors both wrappers run their plain versions.

Tolerance: ``max|Δ| <= 5e-5 * max(1, max|ref|)`` on every tensor (fp32
rounding through 4 layers of 128-wide products and layer norms, as in the
decoder family's parity tests; measured below 1e-6).  Greedy tokens must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro.configs import get_config
from repro.launch import serve as ref_serve
from repro.models import decode_step as ref_decode
from repro.models import forward as ref_forward
from repro.models import init_model as ref_init
from repro.models.blocks import encode as ref_encode
from repro_torch.launch import serve
from repro_torch.models import (decode_step, encode, forward, init_cache,
                                init_model, params_from_jax)
from repro_torch.models.blocks import cross_rows

ARCH = "whisper_tiny"
RTOL = 5e-5
B, S, CACHE_LEN = 2, 20, 32


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want)) if want.size else 0.0
    assert err <= RTOL * max(1.0, np.max(np.abs(want))), (what, err)


@pytest.fixture(scope="module")
def pair():
    cfg = get_config(ARCH).smoke()
    tcfg = port_configs.get_config(ARCH).smoke()
    rp = ref_init(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)) \
        .astype(np.float32)
    return cfg, tcfg, rp, tp, toks, emb


@pytest.fixture(scope="module")
def prefilled(pair):
    """(reference logits, cache; port logits, cache) of one prefill."""
    cfg, tcfg, rp, tp, toks, emb = pair
    batch = {"tokens": toks, "encoder_embeds": emb}
    rl, rc = ref_forward(cfg, rp, batch, mode="prefill", cache_len=CACHE_LEN)
    tl, tc = forward(tcfg, tp, batch, cache_len=CACHE_LEN,
                     compute_device="cpu")
    return rl, rc, tl, tc


def test_encode_prefill_and_cache(pair, prefilled):
    cfg, tcfg, rp, tp, toks, emb = pair
    _close(encode(tcfg, tp, torch.from_numpy(emb)),
           ref_encode(cfg, rp, jnp.asarray(emb)), "encoder output")
    rl, rc, tl, tc = prefilled
    _close(tl, rl, "prefill logits")
    for k in ("k", "v"):
        _close(tc[k], rc[k], k)
    t = cfg.enc_seq
    assert tc["cross_k"].shape[2] == cross_rows(tcfg) >= t
    for k in ("cross_k", "cross_v"):
        _close(tc[k][:, :, :t], rc[k], k)
        assert not tc[k][:, :, t:].any()
    assert int(tc["pos"][0]) == int(rc["pos"][0]) == S
    empty = init_cache(tcfg, B, CACHE_LEN, compute_device="cpu")
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}


def test_four_decode_steps(pair, prefilled):
    cfg, tcfg, rp, tp, toks, emb = pair
    rl, rc, tl, tc = prefilled
    tc = {k: v.clone() for k, v in tc.items()}   # decode writes in place
    tok_r = jnp.argmax(rl[:, -1:], -1).astype(jnp.int32)
    tok_t = torch.argmax(tl[:, -1:], -1)
    for step in range(4):
        pos = np.full((B,), S + step, np.int32)
        rl, rc = ref_decode(cfg, rp, tok_r, jnp.asarray(pos), rc)
        tl, tc = decode_step(tcfg, tp, tok_t, torch.from_numpy(pos), tc,
                             batch_extras={"ignored": True},
                             compute_device="cpu")
        _close(tl, rl, f"decode step {step} logits")
        for k in ("k", "v"):
            _close(tc[k], rc[k], f"decode step {step} {k}")
        tok_r = jnp.argmax(rl[:, -1:], -1).astype(jnp.int32)
        tok_t = torch.argmax(tl[:, -1:], -1)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_r))


def test_prefill_decode_matches_full_forward(pair):
    """The reference's test of the same name, for whisper: the last
    position's train-mode logits equal a prefill of the prompt but its last
    token and one decode step (within the reference's 2e-3), and the
    train-mode logits equal the reference's."""
    cfg, tcfg, rp, tp, toks, emb = pair
    batch = {"tokens": toks, "encoder_embeds": emb}
    full, aux = forward(tcfg, tp, batch, mode="train", remat=False,
                        compute_device="cpu")
    rfull, _ = ref_forward(cfg, rp, batch, mode="train", remat=False)
    _close(full, rfull, "train-mode logits")
    assert float(aux) == 0.0
    pre = {"tokens": toks[:, :S - 1], "encoder_embeds": emb}
    _, cache = forward(tcfg, tp, pre, cache_len=S + 4, compute_device="cpu")
    pos = torch.full((B,), S - 1)
    lg, _ = decode_step(tcfg, tp, torch.from_numpy(toks[:, S - 1:S]), pos,
                        cache, compute_device="cpu")
    err = float((lg[:, 0] - full[:, S - 1]).abs().max())
    assert err < 2e-3, err


def test_seeded_init_matches_the_layout(pair):
    cfg, tcfg, rp, *_ = pair
    port = init_model(tcfg, 0, compute_device="cpu")
    ref_shapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)), rp)
    port_shapes = jax.tree.map(lambda x: (tuple(x.shape),
                                          str(x.dtype).split(".")[1]), port)
    assert port_shapes == ref_shapes


def test_serve_matches_reference(pair):
    """Both packages serve the same 4 seeded requests (two per shared
    prefix), each with its ``default_rng(request id)`` frame embeddings:
    greedy outputs and the prefix cache's counts identical."""
    cfg, tcfg, rp, tp, *_ = pair
    want = ref_serve.run(ARCH, n_requests=4, decode_tokens=6)
    got = serve.run(ARCH, n_requests=4, decode_tokens=6,
                    compute_device="cpu", params=tp)
    assert got["outputs"] == want["outputs"]
    for k in ("requests_admitted", "prefix_hits", "tokens_reused",
              "tokens_prefilled", "prefix_cache"):
        assert got["stats"][k] == want["stats"][k], k
