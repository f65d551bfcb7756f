"""Parameters carried across from the JAX reference.

:func:`params_from_jax` turns the reference's parameter pytree, given as
nested dicts of numpy arrays (``np.asarray`` of each leaf), into the port's
parameters on a chosen device, after checking every key, shape and dtype
against :func:`~repro_torch.models.blocks.model_specs`.  It imports nothing
of the reference: the caller converts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import resolve_compute_device
from .blocks import model_specs
from .common import DTYPES


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _convert(specs: dict, tree: dict, dev: torch.device, path: str) -> dict:
    if set(specs) != set(tree):
        raise ValueError(f"{path or 'params'}: keys {sorted(tree)} differ "
                         f"from the port's {sorted(specs)}")
    out = {}
    for k, spec in specs.items():
        where = f"{path}.{k}" if path else k
        if isinstance(spec, dict):
            out[k] = _convert(spec, tree[k], dev, where)
            continue
        t = _tensor(tree[k])
        if tuple(t.shape) != tuple(spec[1]) or t.dtype != DTYPES[spec[2]]:
            raise ValueError(f"{where}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(spec[1])} {DTYPES[spec[2]]}")
        out[k] = t.to(dev)
    return out


def params_from_jax(cfg, params_np: dict, *,
                    compute_device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_model`` pytree (numpy leaves) as the port's
    parameters on ``compute_device``."""
    dev = resolve_compute_device(compute_device)
    return _convert(model_specs(cfg), params_np, dev, "")
