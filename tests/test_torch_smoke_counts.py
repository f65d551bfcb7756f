"""``chip_smoke.py``'s launch counts against the port's own calls on the
CPU.

The smoke holds each serving path's paged_attention and flash_attention
launches to ``attention_layers`` and ``prefill_attention_layers`` of the
model's config, and each training step's kernel launches to
``train_launches``.  Here, at every registry config's smoke size, the
same counts are taken from what the port really calls: the wrappers'
CPU paths (flash_attention's and ssd_scan's forwards, their backwards,
paged_attention's plain version) are wrapped to count, and one prefill,
one decode step and one remat training step are run.  A CPU wrapper
counts no launch, so the calls are counted where the card would launch.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import decode_step, forward, init_model
from repro_torch.training.step import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCHS = port_configs.ARCH_IDS
# (module, name in it, count key): the functions a card launch stands in
COUNTED = ((flash_ops, "_forward", "flash_attention"),
           (flash_ops, "flash_attention_bwd", "flash_attention_bwd"),
           (ssd_ops, "_forward", "ssd_scan"),
           (ssd_ops, "ssd_scan_bwd", "ssd_scan_bwd"),
           (paged_ops, "paged_attention_plain", "paged_attention"))


@pytest.fixture
def calls(monkeypatch):
    counts = dict.fromkeys((key for _, _, key in COUNTED), 0)

    def counting(fn, key):
        def wrapped(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapped
    for mod, name, key in COUNTED:
        monkeypatch.setattr(mod, name, counting(getattr(mod, name), key))
    return counts


def _batch(cfg, seq: int = 8) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (1, seq)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = rng.standard_normal(
            (1, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _moe_gqa():
    """An MoE decoder with GQA attention and a dense first layer: the case
    of ``train_launches``' ``first_dense_layers`` term, which no registry
    config has."""
    return port_configs.get_config("deepseek_v2_lite").smoke().with_(
        attn_kind="gqa", name="moe-gqa-smoke")


def _configs():
    return [pytest.param(port_configs.get_config(a).smoke(), id=a)
            for a in ARCHS] + [pytest.param(_moe_gqa(), id="moe_gqa")]


@pytest.mark.parametrize("cfg", _configs())
def test_attention_layers_count_the_serving_calls(cfg, calls):
    params = init_model(cfg, 0, compute_device="cpu")
    batch = _batch(cfg)
    del batch["labels"]
    with torch.no_grad():
        logits, cache = forward(cfg, params, batch, mode="prefill",
                                cache_len=64, compute_device="cpu")
        assert calls["flash_attention"] == \
            chip_smoke.prefill_attention_layers(cfg)
        tok = torch.argmax(logits[:, -1:], -1)
        decode_step(cfg, params, tok, torch.tensor([8]), cache,
                    compute_device="cpu")
    assert calls["paged_attention"] == chip_smoke.attention_layers(cfg)


@pytest.mark.parametrize("cfg", _configs())
def test_train_launches_count_a_remat_step(cfg, calls):
    params = init_model(cfg, 0, compute_device="cpu")
    loss, _ = value_and_grad(cfg, params, _batch(cfg), remat=True,
                             compute_device="cpu")
    assert bool(torch.isfinite(loss))
    want = chip_smoke.train_launches(cfg)
    assert {k: calls[k] for k in want} == want
    assert all(calls[k] == 0 for k in calls
               if k not in want and k != "paged_attention")
