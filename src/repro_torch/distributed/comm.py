"""Collectives over a named dimension of a ``DeviceMesh`` — the port's
counterpart of ``jax.lax``'s collectives inside ``shard_map``
(``axis_index``, ``psum``, ``pmax``, ``all_gather``, ``ppermute``), so that
``flash_decode``, ``compression`` and ``pipeline`` read like the
reference.  Every process runs the same program (SPMD, one process a
rank); ``mesh.get_group(axis)`` is the group of the ranks that differ only
in ``axis``.

**Transport.**  Where a collective's tensors must lie is a table by
backend, :data:`TRANSPORT`, read before every op: NCCL takes CUDA
tensors as they are, gloo CPU tensors.  A CUDA tensor handed to a gloo
group is copied to the host, the op runs there, and the result is copied
back to the tensor's device (PyTorch lists gloo's CUDA support op by op,
and send/recv has none).  That staging is a transport for running several
ranks on one card, where NCCL will not put two ranks on one device; it is
no compute path: every rank's arithmetic stays on its own device, and a
backend the table does not name raises.

Sums over ranks (:func:`psum`) gather every rank's tensor and add them in
rank order, so the result does not depend on the order in which the
ranks' data arrive, and is the same on every rank.

:func:`start` runs an SPMD function on ``world_size`` local processes
(``spawn`` start method, a ``file://`` rendezvous) and :func:`join` waits
for them within a time limit, a failure in any rank raised in the caller;
worlds of different backends can run side by side.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: backend -> the device type a collective's tensors must lie on (the same
#: for every op this module runs)
TRANSPORT = {"nccl": "cuda", "gloo": "cpu"}


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def _wire(pg) -> str:
    backend = str(dist.get_backend(pg))
    try:
        return TRANSPORT[backend]
    except KeyError:
        raise ValueError(f"no transport over backend {backend!r}") from None


def _to(x: torch.Tensor, device_type: str) -> torch.Tensor:
    """``x`` on ``device_type`` (itself if it lies there), contiguous."""
    if x.device.type != device_type:
        x = x.to("cpu" if device_type == "cpu" else torch.device(
            device_type, torch.cuda.current_device()))
    return x.contiguous()


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """[G, *x.shape]: every rank's ``x`` along ``axis``, in rank order."""
    pg = mesh.get_group(axis)
    w = _to(x, _wire(pg))
    out = [torch.empty_like(w) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(out, w, group=pg)
    return torch.stack(out).to(x.device)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis``, added in rank order."""
    parts = all_gather(x, mesh, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The element-wise max of every rank's ``x`` along ``axis`` (exact in
    any order)."""
    pg = mesh.get_group(axis)
    w = _to(x, _wire(pg)).clone()
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=pg)
    return w.to(x.device)


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """Rank ``src``'s ``x`` (its index along ``axis``) on every rank; the
    other ranks' ``x`` gives only the shape and dtype."""
    pg = mesh.get_group(axis)
    w = _to(x, _wire(pg)).clone()
    dist.broadcast(w, src=dist.get_global_rank(pg, src), group=pg)
    return w.to(x.device)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: list[tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: for each pair (i, j) of ``perm`` (indices along
    ``axis``) rank i's ``x`` goes to rank j.  Returns what this rank
    received, or zeros of ``x``'s shape where no pair sends to it.  Every
    rank calls it with the same ``perm``; a rank that sends nothing passes
    any tensor of the right shape and dtype."""
    pg = mesh.get_group(axis)
    wire = _wire(pg)
    me = axis_index(mesh, axis)
    ops, recv = [], None
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, _to(x, wire),
                                  dist.get_global_rank(pg, dst), pg))
        if dst == me:
            recv = torch.empty_like(_to(x, wire))
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(pg, src), pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.zeros_like(x) if recv is None else recv.to(x.device)


# ----------------------------------------------------------- local launch
def _rank_main(rank: int, fn, world_size: int, backend: str,
               init_file: str, args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def start(fn, world_size: int, args: tuple = (), *, backend: str,
          init_file: str | Path):
    """Start ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each in a process group of ``backend`` joined through the
    file ``init_file`` (which must not exist yet); ``fn`` must be
    importable by name.  Returns the processes' context for :func:`join`,
    so that several worlds can run at once."""
    return mp.start_processes(_rank_main,
                              args=(fn, world_size, backend, str(init_file),
                                    args),
                              nprocs=world_size, join=False,
                              start_method="spawn")


def join(ctx, timeout: float) -> None:
    """Wait for every rank of :func:`start`'s ``ctx``.  Raises if any rank
    raises or exits non-zero, and ends every rank and raises
    ``TimeoutError`` past ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{len(ctx.processes)} ranks still "
                                   f"running after {timeout} s")
    finally:
        stop(ctx)


def stop(ctx) -> None:
    """End every rank of ``ctx`` that still runs, and reap them all."""
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
        p.join()
