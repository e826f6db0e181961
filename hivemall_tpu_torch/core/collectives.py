"""A process mesh and its collectives (``psum`` / ``pmean`` / gather).

The JAX package's workers are devices of a ``jax.sharding.Mesh`` and its
collectives are XLA's ``psum`` / ``pmean`` inside ``shard_map``. Here each
worker is a process, one per rank, joined by ``torch.distributed``:

- a 1-D mesh is the world's process group; a 2-D (replicas x shards) mesh
  adds one shard group per replica row and one replica group per shard
  column (``hivemall_tpu_torch/parallel/mesh.py`` builds both);
- ``jax.lax.axis_index(axis)`` is this rank's coordinate on the axis
  (``Mesh.index``);
- ``psum`` is ``all_reduce(SUM)`` over the axis' group, ``pmean`` is that
  divided by the group's size, and ``jax.device_get`` of a replicated or
  striped state is `all_gather_host`: every rank gets all ranks' copies as
  one numpy array with a leading [n] axis.

Gloo also carries CUDA tensors (several ranks on one GPU, where NCCL
refuses): the collectives here stage them through host memory. Every
collective counts its calls and bytes on the mesh (`Mesh.stats`); with
``stats.timed`` set it also times each call (CUDA events on a CUDA device,
the host clock otherwise), read back by `CollectiveStats.ms`.

The engine and the models' sharded hooks use this module; the trainers in
``parallel/`` build on it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class CollectiveStats:
    """Calls and payload bytes of a mesh's collectives; with ``timed``,
    each call's time as well (`ms`)."""

    calls: int = 0
    bytes: int = 0
    timed: bool = False
    _marks: List[tuple] = field(default_factory=list)

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self._marks.clear()

    def ms(self) -> float:
        """Milliseconds spent inside the timed collectives since the last
        reset (synchronises the device once)."""
        total = 0.0
        for a, b in self._marks:
            if isinstance(a, float):
                total += (b - a) * 1e3
            else:
                b.synchronize()
                total += a.elapsed_time(b)
        return total


@dataclass
class Mesh:
    """This rank's view of a 1-D or 2-D process mesh.

    ``shape`` maps each axis name to its size (the shard axis innermost on
    a 2-D mesh, as in JAX), ``coords`` maps it to this rank's index, and
    ``groups`` to the process group of the ranks that share every other
    coordinate with this one. ``device`` is where this rank's tensors
    live."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    owned_groups: Tuple[object, ...] = ()

    def index(self, axis: str) -> int:
        """``jax.lax.axis_index(axis)``: this rank's coordinate."""
        return self.coords[axis]

    def destroy(self) -> None:
        """Destroy the groups this mesh made (not the world's)."""
        for g in self.owned_groups:
            dist.destroy_process_group(g)
        self.owned_groups = ()


def _staged(mesh: Mesh, axis: str, x: torch.Tensor) -> bool:
    """Gloo's CUDA tensors go through host memory here."""
    return x.is_cuda and dist.get_backend(mesh.groups[axis]) == "gloo"


def _begin(mesh: Mesh, x: torch.Tensor):
    mesh.stats.calls += 1
    mesh.stats.bytes += x.numel() * x.element_size()
    if not mesh.stats.timed:
        return None
    if x.is_cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _end(mesh: Mesh, mark) -> None:
    if mark is None:
        return
    if isinstance(mark, float):
        mesh.stats._marks.append((mark, time.perf_counter()))
    else:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        mesh.stats._marks.append((mark, ev))


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the axis' group, on every
    rank of it. Reduces ``x`` in place when it is contiguous (pass a
    tensor the caller owns) and returns the result."""
    x = x.contiguous()
    mark = _begin(mesh, x)
    group = mesh.groups[axis]
    if _staged(mesh, axis, x):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    _end(mesh, mark)
    return x


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.pmean``: `psum` over the group divided by its size."""
    return psum(x, mesh, axis) / mesh.shape[axis]


def all_gather_host(x, mesh: Mesh, axis: str) -> np.ndarray:
    """Every rank's ``x`` along the axis as one host numpy array with a
    leading [n] axis, in coordinate order (``jax.device_get`` of a leaf
    sharded over the axis). ``x`` is a tensor or a Python number; bf16
    comes back as float32."""
    if not torch.is_tensor(x):
        x = torch.tensor(x, device=mesh.device)
    src = x.detach()
    if src.dtype == torch.bfloat16:
        src = src.float()
    if _staged(mesh, axis, src):
        src = src.cpu()
    src = src.contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    mark = _begin(mesh, src)
    dist.all_gather(out, src, group=mesh.groups[axis])
    _end(mesh, mark)
    return np.stack([o.cpu().numpy() for o in out])


def gather_fields(state, names, mesh: Mesh, axis: str) -> dict:
    """The named fields of every rank's ``state`` along the axis as host
    numpy [n, ...] arrays (`all_gather_host` of each)."""
    return {k: all_gather_host(getattr(state, k), mesh, axis) for k in names}
