"""Training driver: data pipeline -> train step -> LSM checkpoints, with
watchdog, failure injection and restart — the port of
``repro/launch/train.py``, step for step.

Runs on the card unless ``compute_device="cpu"``: every attention forward
and backward is a flash_attention / flash_attention_bwd kernel launch,
and the checkpoint's page index is the port's vLSM ``LSMTree`` on the same
device (overlap_scan and merge_path launches).  An injected failure
mid-run restores the latest incremental checkpoint onto the same device
and training resumes at the checkpointed step with the pipeline cursor
intact.  This driver runs one process; a restore under another mesh (the
elastic reshard) is ``LSMCheckpointStore.restore(mesh=, specs=)``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_3b \\
        --smoke --steps 60 --ckpt-every 20 [--fail-at 30] \\
        [--compute-device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..checkpoint import LSMCheckpointStore
from ..configs import get_config
from ..core.types import resolve_compute_device
from ..data.pipeline import PipelineState, TokenPipeline
from ..ft.watchdog import FailureInjector, InjectedFailure, StepWatchdog
from ..models import init_model
from ..models.common import dtype_of
from ..training import AdamWConfig, init_opt_state, make_train_step


def run(arch: str, *, smoke: bool = True, steps: int = 50,
        batch: int = 8, seq: int = 64, ckpt_every: int = 20,
        ckpt_dir: str | None = None, fail_at: int | None = None,
        lr: float = 1e-3, log_every: int = 10, seed: int = 0,
        compute_device: str | torch.device = "cuda",
        params: dict | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps.  ``params`` (e.g. carried across
    from the reference with ``models.params_from_jax``) replaces the seeded
    initialisation and is updated in place.  Returns the reference's keys,
    and ``saves`` (each checkpoint's step and stats, in order) and
    ``restores`` (the step, pipeline cursor and segment counts of each
    restore)."""
    dev = resolve_compute_device(compute_device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    store = LSMCheckpointStore(ckpt_dir or Path("results") / "ckpt" / arch,
                               compute_device=dev)
    injector = FailureInjector(fail_at_step=fail_at)
    watchdog = StepWatchdog()

    if params is None:
        params = init_model(cfg, seed, compute_device=dev)
    opt_state = init_opt_state(params)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch,
                         PipelineState(seed=seed, rank=0, world=1))
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr), compute_device=dev)

    losses: list[float] = []
    restarts = 0
    saves: list[dict] = []
    restores: list[dict] = []

    def save(step):
        state = {"params": params, "opt": opt_state,
                 "pipe_cursor": np.asarray(pipe.state.cursor)}
        stats = store.save(step, state)
        saves.append({"step": step, **stats})
        return stats

    step = 0
    while step < steps:
        try:
            batch_np = pipe.next_batch()
            if cfg.family == "encdec":
                rng = np.random.default_rng(step)
                batch_np["encoder_embeds"] = torch.from_numpy(
                    rng.standard_normal((batch, cfg.enc_seq, cfg.d_model))
                ).to(dev, dtype_of(cfg))
            injector.check(step)
            watchdog.start()
            params, opt_state, metrics = step_fn(params, opt_state, batch_np)
            loss = float(metrics["loss"])      # waits for the step
            watchdog.stop(step)
            losses.append(loss)
            if step % log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f}", flush=True)
            if ckpt_every and step and step % ckpt_every == 0:
                st = save(step)
                print(f"  ckpt@{step}: {st['pages_written']}/"
                      f"{st['pages_total']} pages (incremental)", flush=True)
            step += 1
        except InjectedFailure as e:
            print(f"!! {e} — restoring from LSM checkpoint", flush=True)
            restarts += 1
            like = {"params": params, "opt": opt_state,
                    "pipe_cursor": np.asarray(0)}
            restored, rstats = store.restore(treedef_like=like,
                                             compute_device=dev)
            params, opt_state = restored["params"], restored["opt"]
            pipe.state.cursor = int(restored["pipe_cursor"])
            step = max(store.steps)
            restores.append({"step": step, "pipe_cursor": pipe.state.cursor,
                             **rstats})
            print(f"   restored step {step} "
                  f"(read {rstats['segments_touched']}/"
                  f"{rstats['segments_total']} segments)", flush=True)

    final = save(steps)
    return {
        "losses": losses, "restarts": restarts,
        "stragglers": watchdog.stragglers,
        "final_ckpt": final, "index_stats": store.index_stats(),
        "store": store, "params": params, "saves": saves,
        "restores": restores,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the full-size config (the default is --smoke)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--compute-device", default="cuda")
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = run(args.arch, smoke=args.smoke, steps=args.steps,
              batch=args.batch, seq=args.seq, ckpt_every=args.ckpt_every,
              fail_at=args.fail_at, compute_device=args.compute_device)
    print(f"done in {time.perf_counter()-t0:.1f}s; first loss "
          f"{out['losses'][0]:.3f} -> last {out['losses'][-1]:.3f}; "
          f"restarts={out['restarts']}")


if __name__ == "__main__":
    main()
