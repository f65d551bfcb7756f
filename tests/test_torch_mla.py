"""Port of Multi-head Latent Attention (``models/mla.py``) against the JAX
reference on the CPU: the prefill (``mla_forward``: its output and the
latents it caches) and both decode forms (``mla_decode``, absorbed and
expanded) over a cache filled by the prefill, at deepseek-v2-lite's smoke
size.  The reference's ``init_mla`` draws the parameters; both sides get
them and the same numpy-seeded inputs.  Tolerance: ``5e-5 * max(1,
max|ref|)``, the decoder tests'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro.configs import get_config
from repro.models import mla as ref_mla
from repro_torch.models import mla

RTOL = 5e-5
B, S, SMAX = 2, 21, 32


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= RTOL * max(1.0, np.max(np.abs(want))), (what, err)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("deepseek_v2_lite").smoke()
    tcfg = port_configs.get_config("deepseek_v2_lite").smoke()
    rp = ref_mla.init_mla(cfg, jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in rp.items()}
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, rp, tp, x


def test_mla_forward_matches_reference(setup):
    cfg, tcfg, rp, tp, x = setup
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, (ckv, kr) = ref_mla.mla_forward(cfg, rp, jnp.asarray(x),
                                          jnp.asarray(pos))
    got, (tckv, tkr) = mla.mla_forward(tcfg, tp, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()))
    _close(got, want, "out")
    _close(tckv, ckv, "c_kv")
    _close(tkr, kr, "k_rope")


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "expanded"])
def test_mla_decode_matches_reference(setup, absorbed):
    """Three steps at positions S-1, S and S+1 of sequences whose caches
    hold the prefill's latents (and stale rows past them, which the mask
    must hide); the caches are updated in place in the port."""
    cfg, tcfg, rp, tp, x = setup
    rng = np.random.default_rng(2)
    ckv = rng.standard_normal((B, SMAX, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, SMAX, cfg.qk_rope_dim)).astype(np.float32)
    rc, rk = jnp.asarray(ckv), jnp.asarray(kr)
    tc, tk = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    for step in range(3):
        pos = np.array([S - 1 + step, S - 4 + step], np.int32)
        xs = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, rc, rk = ref_mla.mla_decode(cfg, rp, jnp.asarray(xs),
                                          jnp.asarray(pos), rc, rk,
                                          absorbed=absorbed)
        got, tc2, tk2 = mla.mla_decode(tcfg, tp, torch.from_numpy(xs),
                                       torch.from_numpy(pos).long(), tc, tk,
                                       absorbed=absorbed)
        assert tc2 is tc and tk2 is tk
        _close(got, want, f"step {step} out")
        _close(tc, rc, f"step {step} ckv cache")
        _close(tk, rk, f"step {step} kr cache")


def test_mla_decode_forms_agree(setup):
    """The absorbed and expanded forms are the same function."""
    cfg, tcfg, rp, tp, x = setup
    rng = np.random.default_rng(3)
    ckv = torch.from_numpy(rng.standard_normal(
        (B, SMAX, cfg.kv_lora_rank)).astype(np.float32))
    kr = torch.from_numpy(rng.standard_normal(
        (B, SMAX, cfg.qk_rope_dim)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    pos = torch.tensor([5, 30])
    a = mla.mla_decode(tcfg, tp, xs, pos, ckv.clone(), kr.clone(),
                       absorbed=True)[0]
    e = mla.mla_decode(tcfg, tp, xs, pos, ckv.clone(), kr.clone(),
                       absorbed=False)[0]
    _close(a, e.numpy(), "absorbed vs expanded")
