"""The training launcher's parts in the port against the JAX reference on
the CPU: the token pipeline, the straggler and failure hooks, the vLSM
checkpoint store, and ``launch.train.run`` end to end with an injected
failure and its restore.

The pipeline is numpy on both sides, so its batches must be bit-identical.
The checkpoint store's page index is each package's own ``LSMTree`` under
the vLSM policy (the port's on CPU tensors here); for one save sequence
the two stores must write the same pages, segments and manifest, keep the
same index statistics and restore the same bytes — a bf16 leaf included,
stored as its raw 16-bit words.  ``run``'s losses are held to the
reference's within 1e-4 relative (fp32 training of a smoke model from the
same parameters; the step parity tests measure ~1e-7).
"""

import json
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.fleet as ref_fleet
import repro_torch.configs as port_configs
from repro.checkpoint import LSMCheckpointStore as RefStore
from repro.configs import get_config
from repro.data import BatchAllocator as RefAllocator
from repro.data import PipelineState as RefState
from repro.data import TokenPipeline as RefPipeline
from repro.ft import FailureInjector as RefInjector
from repro.ft import StepWatchdog as RefWatchdog
from repro.launch.train import run as ref_run
from repro.models import init_model as ref_init
from repro_torch.checkpoint import LSMCheckpointStore
from repro_torch.core.uids import reset_uid_counters
from repro_torch.data import BatchAllocator, PipelineState, TokenPipeline
from repro_torch.ft import FailureInjector, InjectedFailure, StepWatchdog
from repro_torch.launch.train import run
from repro_torch.models import params_from_jax


@pytest.mark.parametrize("corpus", [False, True])
def test_pipeline_batches_and_resume_match_reference(corpus):
    data = (np.random.default_rng(9).integers(0, 1000, 5000)
            if corpus else None)
    for rank in (0, 1):
        ref = RefPipeline(1000, 16, 4, RefState(seed=3, rank=rank, world=2),
                          corpus=data)
        port = TokenPipeline(1000, 16, 4, PipelineState(seed=3, rank=rank,
                                                        world=2),
                             corpus=data)
        for _ in range(5):
            want, got = ref.next_batch(), port.next_batch()
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        assert port.state.to_dict() == ref.state.to_dict()
    # resume from a saved cursor: the same batch as the uninterrupted run
    a = TokenPipeline(1000, 16, 4, PipelineState(seed=3, rank=0, world=2))
    for _ in range(3):
        a.next_batch()
    b = TokenPipeline(1000, 16, 4,
                      PipelineState.from_dict(a.state.to_dict()))
    np.testing.assert_array_equal(a.next_batch()["tokens"],
                                  b.next_batch()["tokens"])


def test_allocator_watchdog_and_injector_match_reference():
    for alloc in (BatchAllocator(), RefAllocator()):
        ids = [alloc.claim(r) for r in (0, 1, 0, 0, 1)]
        assert ids == [0, 1, 2, 3, 4]
        assert alloc.claims == {0: [0, 2, 3], 1: [1, 4]}
    flags = []
    for wd in (StepWatchdog(threshold=3.0, alpha=0.5),
               RefWatchdog(threshold=3.0, alpha=0.5)):
        out = []
        for step, dt in enumerate((0.01, 0.01, 0.01, 0.2, 0.01)):
            wd._t0 = time.monotonic() - dt
            out.append(wd.stop(step))
        flags.append((out, [s for s, _ in wd.stragglers]))
    assert flags[0] == flags[1] and flags[0][0][3]
    for inj, exc in ((FailureInjector(fail_at_step=2), InjectedFailure),
                     (RefInjector(fail_at_step=2), RuntimeError)):
        inj.check(0)
        inj.check(1)
        with pytest.raises(exc, match="step 2"):
            inj.check(2)
        inj.check(2)                     # fires once


def _state(seed: int, bf16_bump: float = 0.0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((100, 50)).astype(np.float32)
    e = (rng.standard_normal((64, 40)) + bf16_bump).astype(ml_dtypes.bfloat16)
    return {"params": {"w": w, "emb": e,
                       "b": rng.standard_normal(50).astype(np.float32)},
            "opt": {"step": np.asarray(seed, np.int32)},
            "pipe_cursor": np.asarray(seed)}


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype == ml_dtypes.bfloat16 else arr


def test_checkpoint_store_matches_reference(tmp_path):
    ref_fleet.reset_uid_counters()
    reset_uid_counters()
    ref = RefStore(tmp_path / "ref", page_bytes=2048)
    port = LSMCheckpointStore(tmp_path / "port", page_bytes=2048,
                              compute_device="cpu")
    states = [_state(0), _state(0), _state(1), _state(1, 1.0)]
    for step, st in enumerate(states * 3):
        want = ref.save(step, st)
        got = port.save(step, _to_port(st))
        assert got == want, step
    assert port.index_stats() == ref.index_stats()
    m_ref = json.loads((tmp_path / "ref" / "MANIFEST.json").read_text())
    m_port = json.loads((tmp_path / "port" / "MANIFEST.json").read_text())
    assert m_port == m_ref
    names = list(m_port["steps"]["0"]["meta"])
    assert names == ["opt/step", "params/b", "params/emb", "params/w",
                     "pipe_cursor"]
    assert m_port["steps"]["0"]["meta"]["params/emb"]["dtype"] == "bfloat16"
    for seg in m_ref["seg_live"]:
        a = np.load(tmp_path / "ref" / "segments" / f"{seg}.npz")
        b = np.load(tmp_path / "port" / "segments" / f"{seg}.npz")
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[f], b[f]) for f in a.files)
    for step in (11, 6, 2):
        want, w_stats = ref.restore(step, treedef_like=states[step % 4])
        got, g_stats = port.restore(step,
                                    treedef_like=_to_port(states[step % 4]))
        assert g_stats == w_stats
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        for path, leaf in flat_w:
            node = got
            for k in path:
                node = node[k.key]
            assert isinstance(node, torch.Tensor)
            np.testing.assert_array_equal(_bits(node), _bits(leaf))
    # a new store over the same directory restores the same (recovery)
    again = LSMCheckpointStore(tmp_path / "port", page_bytes=2048,
                               compute_device="cpu")
    flat, _ = again.restore(11)
    assert torch.equal(flat["params/emb"].view(torch.int16),
                       _to_port(states[3])["params"]["emb"].view(torch.int16))


def test_async_save_equals_save(tmp_path):
    a = LSMCheckpointStore(tmp_path / "a", page_bytes=1024,
                           compute_device="cpu")
    b = LSMCheckpointStore(tmp_path / "b", page_bytes=1024,
                           compute_device="cpu")
    st = _to_port(_state(4))
    want = a.save(0, st)
    b.async_save(0, st)
    b.wait()
    got, _ = b.restore(0, treedef_like=st)
    assert b.steps[0]["meta"] == a.steps[0]["meta"]
    assert want["pages_written"] == want["pages_total"]
    assert torch.equal(got["params"]["w"], st["params"]["w"])


def test_run_with_injected_failure_matches_reference(tmp_path):
    _run_matches_reference(tmp_path, "qwen3_1_7b")


def test_run_of_the_hybrid_family_matches_reference(tmp_path):
    """zamba2's Mamba2 layers and shared attention block through the
    launcher: its restore, checkpoints and losses as the reference's."""
    _run_matches_reference(tmp_path, "zamba2_1_2b")


def _run_matches_reference(tmp_path, arch):
    cfg = get_config(arch).smoke()
    rp = jax.jit(ref_init, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(port_configs.get_config(arch).smoke(),
                         jax.tree.map(np.asarray, rp), compute_device="cpu")
    kw = dict(steps=8, batch=4, seq=16, ckpt_every=3, fail_at=5,
              log_every=100)
    ref_fleet.reset_uid_counters()
    want = ref_run(arch, ckpt_dir=str(tmp_path / "ref"), **kw)
    ref_fleet.reset_uid_counters()
    reset_uid_counters()
    got = run(arch, ckpt_dir=str(tmp_path / "port"), compute_device="cpu",
              params=tp, **kw)
    assert got["restarts"] == want["restarts"] == 1
    assert got["restores"][0]["step"] == 3
    assert got["restores"][0]["pipe_cursor"] == 4
    assert [x["step"] for x in got["saves"]] == [3, 3, 6, 8]
    assert got["saves"][0]["pages_written"] == got["saves"][0]["pages_total"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["final_ckpt"] == want["final_ckpt"]
    assert got["index_stats"] == want["index_stats"]

