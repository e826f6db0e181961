"""Model-dimension sharding (the port of ``hivemall_tpu/parallel/
sharded.py``).

The reference shards its 2^24-dim feature space across MIX servers by
feature hash (ref: mix/client/MixRequestRouter.java:56-60). Here the
weight table is striped along the feature dim across the ranks of a mesh
axis: each rank holds a [D/n] stripe, a row's gather hits every stripe,
and the partial dot products are summed with one all_reduce.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.engine import _to_device, gather, live_lanes
from ..core.striping import stripe_of, translate_to_stripe
from .mesh import WORKER_AXIS, Mesh, psum


def shard_weights(weights, mesh: Mesh, axis_name: str = WORKER_AXIS):
    """This rank's stripe of a [D] host table (D divisible by the axis
    size, as JAX's placement requires), on the mesh's device."""
    w = np.asarray(weights)
    n = mesh.shape[axis_name]
    if w.shape[0] % n:
        raise ValueError(f"dims {w.shape[0]} not divisible by {n} devices")
    stripe = w.shape[0] // n
    return torch.from_numpy(stripe_of(w, 0, w.shape[0], stripe,
                                      mesh.index(axis_name))).to(mesh.device)


def stripe_score(mesh: Mesh, axis_name: str, stripe: int):
    """The per-rank scoring body shared by sharded predict and sharded
    training's serving path (ShardedTrainer.make_predict): translate the
    global ids into the local [stripe] table, gather (foreign lanes add
    0), sum the partial dot products over the axis."""
    shard = mesh.index(axis_name)

    def local_score(w_local: torch.Tensor, indices, values) -> torch.Tensor:
        dev = w_local.device
        idx, val = translate_to_stripe(_to_device(indices, torch.int64, dev),
                                       _to_device(values, torch.float32, dev),
                                       shard, stripe)
        live, sidx = live_lanes(idx, w_local.shape[0])
        part = torch.sum(gather(w_local, sidx, live) * val, dim=-1)
        return psum(part, mesh, axis_name)

    return local_score


def make_sharded_predict(mesh: Mesh, dims: int,
                         axis_name: str = WORKER_AXIS):
    """Scoring with the weight table feature-sharded:
    ``predict(w_local, indices, values) -> scores [B]`` on every rank."""
    n = mesh.shape[axis_name]
    if dims % n:
        raise ValueError(f"dims {dims} not divisible by {n} devices")
    return stripe_score(mesh, axis_name, dims // n)
