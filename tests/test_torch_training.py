"""The port's training forward and gradients against the JAX reference on
the CPU, for the decoder, encdec, hybrid and ssm arch ids at their smoke
size.

The reference initialises its parameters; ``params_from_jax`` carries them
across.  Both sides take the same numpy-seeded batch (labels with one -1,
which the loss masks; whisper's frame embeddings).  The reference's
``train_loss`` differentiates its plain jnp attention and its sequential
SSD scan (``ssd_scan_ref``) with ``jax.grad``; the port's runs the
flash_attention and ssd_scan wrappers, whose backwards are
``flash_attention_bwd`` and ``ssd_scan_bwd`` (their plain versions on CPU
tensors), and its MoE and MLA in plain torch as the reference does.

Tolerances (float32): train-mode logits ``5e-5 * max(1, max|ref|)`` as the
prefill parity tests; the loss 1e-5 relative; each gradient leaf
``2e-5 * max|ref leaf|`` — fp32 sums taken in another order through the
backward pass (measured below 2e-6 of each leaf's largest element).
``remat`` (``torch.utils.checkpoint`` per stacked layer) recomputes the
same forward, so its gradients are bitwise those without it.
"""

import jax
import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro.configs import get_config
from repro.models import forward as ref_forward
from repro.models import init_model as ref_init
from repro.models import train_loss as ref_train_loss
from repro_torch.models import forward, params_from_jax
from repro_torch.training.step import value_and_grad
from repro_torch.training.tree import leaf_paths

# every arch id but deepseek_v2_236b, whose smoke config is
# deepseek_v2_lite's but for its name
ARCHS = ["qwen3_1_7b", "llama3_2_3b", "yi_6b", "qwen2_vl_2b", "gemma3_1b",
         "deepseek_v2_lite", "whisper_tiny", "zamba2_1_2b", "mamba2_130m"]
B, S = 2, 16


def batch_of(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -1] = -1                     # masked out of the loss
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def grads_close(got: dict, want, rtol: float = 2e-5) -> None:
    """Every leaf of ``got`` (the port's nested dict) within ``rtol`` of the
    reference pytree leaf's largest |element|."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    port = dict(leaf_paths(got))
    assert len(flat) == len(port)
    for path, leaf in flat:
        key = tuple(k.key for k in path)
        w = np.asarray(leaf, np.float64)
        g = port[key].detach().double().numpy()
        err = float(np.max(np.abs(g - w)))
        assert err <= rtol * float(np.max(np.abs(w))), ("/".join(key), err)


def ref_params(cfg):
    """The reference's ``init_model`` at key 0, jitted for time (its draws
    differ from the eager call's in the last bits; both packages take these
    same parameters)."""
    return jax.jit(ref_init, static_argnums=0)(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = get_config(request.param).smoke()
    tcfg = port_configs.get_config(request.param).smoke()
    rp = ref_params(cfg)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    return cfg, tcfg, rp, tp


def test_train_logits_loss_and_grads(pair):
    cfg, tcfg, rp, tp = pair
    batch = batch_of(cfg)
    rl, raux = jax.jit(lambda p, b: ref_forward(cfg, p, b, mode="train",
                                                remat=False))(rp, batch)
    tl, taux = forward(tcfg, tp, batch, mode="train", remat=False,
                       compute_device="cpu")
    want = np.asarray(rl, np.float64)
    err = float(np.max(np.abs(tl.detach().double().numpy() - want)))
    assert err <= 5e-5 * max(1.0, float(np.max(np.abs(want)))), err
    assert abs(float(taux) - float(raux)) <= 1e-5 * max(1.0, abs(float(raux)))
    rloss, rgrads = jax.value_and_grad(
        lambda p: ref_train_loss(cfg, p, batch))(rp)
    loss, grads = value_and_grad(tcfg, tp, batch, compute_device="cpu")
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    grads_close(grads, rgrads)


def test_remat_equals_no_remat(pair):
    cfg, tcfg, rp, tp = pair
    batch = batch_of(cfg, seed=1)
    loss_r, grads_r = value_and_grad(tcfg, tp, batch, remat=True,
                                     compute_device="cpu")
    loss_n, grads_n = value_and_grad(tcfg, tp, batch, remat=False,
                                     compute_device="cpu")
    assert torch.equal(loss_r, loss_n)
    for (path, g), (_, h) in zip(leaf_paths(grads_r), leaf_paths(grads_n)):
        assert torch.equal(g, h), path


# gemma3's smoke config at its real head_dim 256 and S 40, past its
# 16-token smoke window: the local layer masks by the window, the global
# one causally, so both of the D 256 backward's masks are held to the
# reference's gradient
WINDOWED = [("gemma3_1b", 256, 40)]


@pytest.mark.parametrize("arch,head_dim,seq", WINDOWED)
def test_windowed_head_dim_grads(arch, head_dim, seq):
    cfg = get_config(arch).smoke().with_(head_dim=head_dim)
    tcfg = port_configs.get_config(arch).smoke().with_(head_dim=head_dim)
    windows = tcfg.layer_windows()
    assert any(0 < w < seq for w in windows) and any(w <= 0 for w in windows)
    rp = ref_params(cfg)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    rloss, rgrads = jax.value_and_grad(
        lambda p: ref_train_loss(cfg, p, batch, use_pallas=False))(rp)
    loss, grads = value_and_grad(tcfg, tp, batch, compute_device="cpu")
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    grads_close(grads, rgrads)
