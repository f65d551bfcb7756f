"""Port of the flash_attention kernel against the JAX reference on the CPU.

The same numpy-seeded q/k/v go through the reference's Pallas kernel (its
wrapper runs it in interpret mode on the CPU), its pure-jnp oracle
``attention_ref`` and the port's wrapper, which runs the plain version for
CPU tensors.  Tolerances are the reference's own (``tests/test_kernels.py``):
2e-5 in float32 (summation order), 3e-2 in bfloat16 (one bf16 rounding of
outputs of magnitude ~1).  bf16 inputs are rounded once, in JAX, and handed
to torch exactly through float32.

The reference's wrapper cannot run S < 128: it sizes its blocks to
``min(128, S)`` but calls the kernel with the default 128-row blocks, which
asserts ``S % 128 == 0`` (``kernels/flash_attention/ops.py:26-47``).  The
one-token case is therefore held against the oracle alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

CASES = [  # b, hq, hkv, s, d, window, dtype
    (1, 2, 2, 256, 64, None, "float32"),
    (2, 4, 2, 128, 64, None, "float32"),
    (1, 2, 1, 256, 128, 128, "float32"),
    (1, 2, 2, 384, 64, None, "bfloat16"),
    (1, 1, 1, 130, 64, None, "float32"),
    (2, 4, 2, 1, 64, None, "float32"),           # one token
    # gemma3's head_dim 256, 4 query heads over 1 kv head, its windows
    (1, 4, 1, 256, 256, None, "float32"),
    (1, 4, 1, 256, 256, 16, "float32"),
    (2, 4, 1, 128, 256, 64, "bfloat16"),
    (1, 4, 1, 130, 256, 1, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(42)
    dt = jnp.dtype(dtype)
    qkv = [jnp.asarray(rng.standard_normal(shape), dt)
           for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    tt = getattr(torch, dtype)
    port = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tt)
            for x in qkv]
    return qkv, port


def _err(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want.astype(jnp.float32)))))


@pytest.mark.parametrize("b,hq,hkv,s,d,win,dtype", CASES)
def test_flash_matches_reference(b, hq, hkv, s, d, win, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(b, hq, hkv, s, d, dtype)
    launches = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=True, window=win)
    assert flash_attention.launches == launches   # CPU: plain version only
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _err(got, attention_ref(q, k, v, causal=True, window=win)) \
        < TOL[dtype]
    if s >= 128:
        assert _err(got, ref_flash(q, k, v, causal=True, window=win)) \
            < TOL[dtype]


def test_flash_noncausal_and_fully_masked_rows():
    """Non-causal attention needs no padding in the port; a window that
    masks every key of a row (window 1 with causal=False keeps kj >= qi)
    and the reference's -1e30 convention give finite rows."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 2, 1, 64, 64, "float32")
    want = attention_ref(q, k, v, causal=False)
    assert _err(flash_attention(tq, tk, tv, causal=False), want) < 2e-5
    want_w = attention_ref(q, k, v, causal=False, window=1)
    got_w = flash_attention_plain(tq, tk, tv, causal=False, window=1)
    assert torch.isfinite(got_w).all()
    assert _err(got_w, want_w) < 2e-5


def test_flash_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError):
        flash_attention(x, x, x, window=0)
    with pytest.raises(ValueError):
        flash_attention(x, x[:, :, :3], x)
