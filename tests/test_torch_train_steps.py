"""The port's train step (``training.make_train_step``: autograd, AdamW,
clipping, gradient accumulation) against the reference's on the CPU, for
one arch id of each kind of block: qwen3-1.7b (GQA, qk-norm, tied head),
deepseek-v2-lite (MLA, MoE routing and aux loss, a dense first layer),
whisper-tiny (encdec) and zamba2-1.2b (Mamba2 layers and a shared
attention block), at smoke size.  ``test_torch_training.py`` holds the
gradients of every arch id; the optimizer's arithmetic does not depend on
the arch.

Both sides start from the same parameters (the reference's, carried
across) and take 3 steps on the same batches, the last with
``grad_accum=2``.  Tolerances: the loss and grad norm 1e-5 relative; the
parameters after 3 steps: no element apart by more than 6 x lr (each
AdamW step moves a parameter by at most ~lr: where a gradient's sign is
rounding noise, Adam's normalised step can take either sign, which a few
dozen elements of each model show) and at most 1e-3 of the elements apart
by more than 1e-6.

zamba2-1.2b's grad norm after the first step is held to 5e-5 relative:
its smoke model's gradients differ from the reference's by up to ~1e-5
of each leaf's largest element (``test_torch_training.py`` holds them to
2e-5; qwen3's sit near 1e-6), so the first AdamW step, whose normalised
update takes the sign of gradients at that level, leaves a few hundred
parameters apart (within the bounds below) and the next grad norms up to
~2e-5 apart.  Its first step, from the same parameters on both sides,
is held to 1e-5 as the others.
"""

import jax
import numpy as np
import pytest

import repro_torch.configs as port_configs
from repro.configs import get_config
from repro.models import init_model as ref_init
from repro.training import AdamWConfig as RefAdamW
from repro.training import init_opt_state as ref_init_opt
from repro.training import make_train_step as ref_make_step
from repro_torch.models import params_from_jax
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.tree import leaf_paths

ARCHS = ["qwen3_1_7b", "deepseek_v2_lite", "whisper_tiny", "zamba2_1_2b"]
# the grad norm's relative tolerance after the first step, where not 1e-5
LATER_GRAD_NORM_RTOL = {"zamba2_1_2b": 5e-5}
B, S = 4, 16


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference(arch):
    cfg = get_config(arch).smoke()
    tcfg = port_configs.get_config(arch).smoke()
    rp = jax.jit(ref_init, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, rp),
                         compute_device="cpu")
    lr = AdamWConfig().lr
    ref_steps = {ga: jax.jit(ref_make_step(cfg, RefAdamW(), grad_accum=ga))
                 for ga in (1, 2)}
    steps = {ga: make_train_step(tcfg, AdamWConfig(), grad_accum=ga,
                                 compute_device="cpu") for ga in (1, 2)}
    ro, to = ref_init_opt(rp), init_opt_state(tp)
    for i, ga in enumerate((1, 1, 2)):
        batch = _batch(cfg, i)
        rp, ro, rm = ref_steps[ga](rp, ro, batch)
        tp, to, tm = steps[ga](tp, to, batch)
        for k in ("loss", "grad_norm"):
            rtol = LATER_GRAD_NORM_RTOL.get(arch, 1e-5) \
                if i and k == "grad_norm" else 1e-5
            assert abs(float(tm[k]) - float(rm[k])) <= \
                rtol * abs(float(rm[k])), (i, k)
    assert int(to["step"]) == int(ro["step"]) == 3
    port = dict(leaf_paths(tp))
    apart = total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(rp)[0]:
        got = port[tuple(k.key for k in path)].numpy()
        d = np.abs(got.astype(np.float64) - np.asarray(leaf, np.float64))
        assert d.max() <= 6 * lr, (path, d.max())
        apart += int((d > 1e-6).sum())
        total += d.size
    assert apart <= 1e-3 * total, (apart, total)
    for name in ("m", "v"):
        for (_, m) in leaf_paths(to[name]):
            assert m.dtype.is_floating_point and m.dtype.itemsize == 4
