"""Forming the port's process worlds and meshes.

A caller starts a rank with `init_distributed` (torchrun's ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or a world of one when
none is set, as ``jax.devices()`` on one chip is a mesh of one), or runs
ranks on one machine with `spawn`. The backend is NCCL for a CUDA device
and gloo for the CPU unless the caller names one, and nothing switches it:
an NCCL that fails to start raises. `make_mesh` / `make_mesh_2d` build the
JAX package's 1-D and 2-D meshes (``hivemall_tpu/parallel/mesh.py``) as
process groups; the mesh and its collectives live in
``core/collectives.py`` and are re-exported here.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..core.collectives import (CollectiveStats, Mesh, all_gather_host,
                                gather_fields, pmean, psum)
from ..device import DeviceLike, resolve_device

__all__ = ["CollectiveStats", "DEFAULT_TIMEOUT", "Mesh", "SHARD_AXIS",
           "WORKER_AXIS", "all_gather_host", "gather_fields",
           "init_distributed", "make_mesh", "make_mesh_2d", "pmean", "psum",
           "spawn"]

WORKER_AXIS = "workers"
SHARD_AXIS = "shards"
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def init_distributed(backend: Optional[str] = None,
                     device: DeviceLike = None, *,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join (or form) this process's ``torch.distributed`` world and return
    the device its tensors live on.

    ``device`` None is the CUDA device (``cuda:LOCAL_RANK``), raising when
    there is none (hivemall_tpu_torch/device.py); ``"cpu"`` runs the ranks
    on the CPU. ``backend`` None is NCCL for CUDA and gloo for the CPU.
    ``rank`` / ``world_size`` default to torchrun's ``RANK`` /
    ``WORLD_SIZE``, ``init_method`` to ``env://`` when they are set; with
    neither the world is this process alone, through an in-memory store.
    An already initialised world is kept (its backend must be ``backend``
    when one is named)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"torch.distributed is initialised with "
                               f"{have!r}, not {backend!r}")
        return dev
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and world_size is None and init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        return dev
    if rank is None or world_size is None:
        raise ValueError("set both rank and world_size (RANK and "
                         "WORLD_SIZE), or neither")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=timeout)
    return dev


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = WORKER_AXIS,
              device: DeviceLike = None) -> Mesh:
    """A 1-D mesh over the whole world (call `init_distributed` first).
    ``n_devices``, when given, must be the world size: a rank outside the
    mesh would have nothing to run."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans the whole world: n_devices "
                         f"{n_devices} != world size {world}")
    return Mesh(axis_names=(axis_name,), shape={axis_name: world},
                coords={axis_name: dist.get_rank()},
                groups={axis_name: dist.group.WORLD},
                device=resolve_device(device))


def make_mesh_2d(n_replicas: int, n_shards: int,
                 replica_axis: str = WORKER_AXIS,
                 shard_axis: str = SHARD_AXIS,
                 device: DeviceLike = None) -> Mesh:
    """A 2-D (replicas x shards) mesh over the world: rank ``r * n_shards +
    s`` is replica ``r``'s stripe ``s``. Every rank makes every group, in
    the same order (``dist.new_group`` is collective)."""
    world = dist.get_world_size()
    if n_replicas * n_shards != world:
        raise ValueError(f"need {n_replicas * n_shards} ranks, the world "
                         f"has {world}")
    rank = dist.get_rank()
    r, s = divmod(rank, n_shards)
    made = []
    shard_group = replica_group = None
    for row in range(n_replicas):
        g = dist.new_group([row * n_shards + c for c in range(n_shards)])
        made.append(g)
        if row == r:
            shard_group = g
    for col in range(n_shards):
        g = dist.new_group([row * n_shards + col
                            for row in range(n_replicas)])
        made.append(g)
        if col == s:
            replica_group = g
    return Mesh(axis_names=(replica_axis, shard_axis),
                shape={replica_axis: n_replicas, shard_axis: n_shards},
                coords={replica_axis: r, shard_axis: s},
                groups={replica_axis: replica_group,
                        shard_axis: shard_group},
                device=resolve_device(device),
                owned_groups=tuple(made))


def _spawned(rank: int, fn, nprocs: int, args: Sequence,
             backend: Optional[str], device: str, init_file: str,
             threads: Optional[int], timeout_s: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device[rank] if isinstance(device, list) else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    init_distributed(backend, dev,
                     timeout=datetime.timedelta(seconds=timeout_s),
                     init_method=f"file://{init_file}", rank=rank,
                     world_size=nprocs)
    try:
        fn(rank, nprocs, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: Sequence = (), *, init_file: str,
          backend: Optional[str] = None,
          device: Union[DeviceLike, Sequence[DeviceLike]] = None,
          threads: Optional[int] = None, timeout: float = 600.0) -> None:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes that
    form one world through a ``file://`` rendezvous at ``init_file`` (a
    path that does not exist yet). ``fn`` must be importable by name
    (processes start by ``spawn``).

    ``device`` and ``backend`` resolve as in `init_distributed`: None is
    CUDA (raising here, before any process starts, when there is none),
    rank r on GPU ``r % device_count`` unless ``device`` names one, with
    NCCL; ``"cpu"`` runs the ranks on the CPU over gloo. A list or tuple
    names one device per rank. Several ranks on one GPU need
    ``backend="gloo"`` (NCCL refuses them).

    Raises the first rank's exception; kills every rank and raises
    ``TimeoutError`` when they have not all finished within ``timeout``
    seconds, so a hang cannot outlive it."""
    import torch.multiprocessing as tmp

    if isinstance(device, (list, tuple)):
        if len(device) != nprocs:
            raise ValueError(f"{len(device)} devices for {nprocs} ranks")
        dev = [str(resolve_device(d)) for d in device]
    else:
        dev = str(resolve_device(device))
    ctx = tmp.start_processes(
        _spawned, args=(fn, nprocs, tuple(args), backend, dev,
                        init_file, threads, timeout),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
