"""Production mesh factory — the port of ``repro/launch/mesh.py``.

(16, 16) ``("data", "model")`` per pod; the multi-pod config adds a leading
"pod" axis, (2, 16, 16) = 512 ranks.  Each is a ``DeviceMesh`` over the
default process group, which must already hold that many ranks
(``torch.distributed.init_process_group``); a function, so that importing
builds nothing.  ``distributed.sharding.axis_sizes(mesh)`` gives its
name -> size dict, the reference's ``mesh.shape``.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda") -> DeviceMesh:
    """Elastic variant: any factorization of the ranks — a restore after a
    fleet resize reshards onto it (``LSMCheckpointStore.restore(mesh=)``)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
