"""Port of the MoE MLP (``models/moe.py``: sort-based dispatch, capacity,
drop row, gate renormalisation, shared experts, switch-style aux loss)
against the JAX reference on the CPU.

The reference's ``init_moe`` draws the parameters; both sides get them and
the same numpy-seeded tokens.  Cases: deepseek-v2-lite's smoke config
(4 experts, top-2, one shared expert, capacity factor 4: no drops), the
same with capacity factor 0.5 so that assignments overflow their
expert's capacity and go to the drop row, without a shared expert, a
one-token decode batch (the capacity floor of 8), and
``REPRO_MOE_GROUPS=2`` (two batch-aligned dispatch groups; set with
``monkeypatch``, read at each call as the reference reads it).
Tolerance: ``5e-5 * max(1, max|ref|)``, the decoder tests' (fp32 rounding
of the products and the k-sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro.configs import get_config
from repro.models import moe as ref_moe
from repro_torch.models import moe

RTOL = 5e-5
CASES = {  # config overrides, (B, S)
    "smoke": ({}, (2, 37)),
    "drops": ({"capacity_factor": 0.5}, (2, 37)),
    "no-shared": ({"n_shared_experts": 0}, (3, 11)),
    "decode": ({}, (1, 1)),
}


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= RTOL * max(1.0, np.max(np.abs(want))), (what, err)


def _setup(overrides, shape, seed=0):
    cfg = get_config("deepseek_v2_lite").smoke().with_(**overrides)
    tcfg = port_configs.get_config("deepseek_v2_lite").smoke().with_(
        **overrides)
    rp = ref_moe.init_moe(cfg, jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in rp.items()}
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return cfg, tcfg, rp, tp, x


def _dropped(cfg, x, rp) -> int:
    """Assignments past their expert's capacity (the reference's routing,
    recomputed in numpy)."""
    xt = x.reshape(-1, cfg.d_model)
    n = xt.shape[0]
    logits = xt @ np.asarray(rp["router"])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    counts = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
    cap = max(8, int(cfg.capacity_factor * n * cfg.top_k / cfg.n_experts))
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_moe_forward_matches_reference(case):
    overrides, shape = CASES[case]
    cfg, tcfg, rp, tp, x = _setup(overrides, shape)
    want, want_aux = ref_moe.moe_forward(cfg, rp, jnp.asarray(x))
    got, aux = moe.moe_forward(tcfg, tp, torch.from_numpy(x))
    _close(got, want, "out")
    _close(aux, want_aux, "aux")
    assert aux.dtype == torch.float32
    assert (_dropped(cfg, x, rp) > 0) == (case == "drops")


def test_moe_groups_match_reference(monkeypatch):
    """Two dispatch groups, each with its own capacity (factor 0.5, so the
    groups drop different assignments than one dispatch would), and the
    mean of their aux losses."""
    cfg, tcfg, rp, tp, x = _setup({"capacity_factor": 0.5}, (4, 9), seed=2)
    one, _ = moe.moe_forward(tcfg, tp, torch.from_numpy(x))
    monkeypatch.setenv("REPRO_MOE_GROUPS", "2")
    want, want_aux = ref_moe.moe_forward(cfg, rp, jnp.asarray(x))
    got, aux = moe.moe_forward(tcfg, tp, torch.from_numpy(x))
    _close(got, want, "out")
    _close(aux, want_aux, "aux")
    assert not torch.allclose(got, one)
    monkeypatch.setenv("REPRO_MOE_GROUPS", "3")   # 3 does not divide B 4
    _close(moe.moe_forward(tcfg, tp, torch.from_numpy(x))[0], one.numpy(),
           "ungrouped")


def test_moe_specs_match_reference_layout():
    cfg = get_config("deepseek_v2_lite").smoke()
    tcfg = port_configs.get_config("deepseek_v2_lite").smoke()
    rp = ref_moe.init_moe(cfg, jax.random.PRNGKey(0))
    tp = moe.init_moe(tcfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in tp.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in rp.items()}
