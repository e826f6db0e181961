"""THE one copy of the feature-stripe index translation (the port of
``hivemall_tpu/core/striping.py``).

Every feature-dim sharded path (the linear engine, FM, FFM, multiclass,
sharded scoring) maps global hashed ids onto a rank's [stripe] table slice
the same way:

    local = global - shard_rank * stripe
    owned = 0 <= local < stripe
    foreign / pad lanes -> index ``stripe`` (one past the end), which the
    port's lane protocol treats as a dead lane (core/engine.py: a lane is
    live when 0 <= idx < D), and their values mask to 0 so they add
    nothing to the row partials.

The stripes are contiguous ranges, so each rank's slice is one dense
block (ref analog: ``hash(feature) mod numNodes`` server routing,
mix/client/MixRequestRouter.java:56-60).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def stripe_grid(dims: int, n_shards: int, align: int = 1):
    """``(stripe, dims_padded)`` for striping a [dims] feature axis across
    ``n_shards`` ranks: ``stripe = ceil(dims / n)`` (rounded up to a
    multiple of ``align``), ``dims_padded = stripe * n``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    stripe = -(-dims // n_shards)
    if align > 1:
        stripe = -(-stripe // align) * align
    return stripe, stripe * n_shards


def translate_to_stripe(idx: torch.Tensor, val: torch.Tensor,
                        shard_rank: int, stripe: int):
    """(local_idx, masked_val): global ids -> this rank's stripe-local
    indices (foreign and pad lanes -> the drop slot ``stripe``), values
    masked to 0 on lanes this rank does not own. Any shape."""
    local = idx - shard_rank * stripe
    owned = (local >= 0) & (local < stripe)
    local = torch.where(owned, local, torch.full_like(local, stripe))
    return local, val * owned.to(val.dtype)


def restripe_array(arr, axis: int, dims: int, dims_padded: int,
                   fill: float = 0.0) -> np.ndarray:
    """Move ONE striped table axis between stripe grids: unpad at the old
    grid (slice back to the logical ``dims``), re-pad at the new grid with
    ``fill``. No data id reaches a slot past ``dims``, so the unpad loses
    nothing; the fill must be the slot's init value (weights 0,
    covariances 1: a zero covariance puts inf into argminKLD's 1/cov)."""
    a = np.asarray(arr)
    if a.shape[axis] < dims:
        raise ValueError(
            f"striped axis {axis} has {a.shape[axis]} < dims {dims}")
    if a.shape[axis] > dims:
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, dims)
        a = a[tuple(sl)]
    if dims_padded > dims:
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, dims_padded - dims)
        a = np.pad(a, widths, constant_values=fill)
    return a


def stripe_of(arr, axis: int, dims: int, stripe: int, shard_rank: int,
              fill: float = 0.0) -> np.ndarray:
    """This rank's [stripe] slice of a host table whose ``axis`` holds the
    ``dims`` features (any old padding is cut first), padded with ``fill``
    past ``dims``: the slice `restripe_array` would place on this rank.
    Always a fresh array, never a view of ``arr``."""
    lo = shard_rank * stripe
    a = np.asarray(arr)
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(min(lo, dims), min(lo + stripe, dims))
    part = a[tuple(sl)]
    short = stripe - part.shape[axis]
    if short:
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, short)
        part = np.pad(part, widths, constant_values=fill)
    return np.array(part, order="C", copy=True)


def restripe(host: Dict[str, object], striped: Dict[str, int], dims: int,
             stripe: int, shard_rank: int, device,
             fills: Optional[Dict[str, float]] = None) -> Dict[str, object]:
    """Place a COLLAPSED host state on this rank (the elastic-resume N -> M
    placement): every field named in ``striped`` (field -> its feature
    axis) becomes this rank's [stripe] slice (`stripe_of`, padded past
    ``dims`` with ``fills[field]``, default 0), every other field a
    replicated tensor; None stays None. ``host`` maps field names to numpy
    arrays or numbers, or to dicts of them (``slots``, whose entries take
    their parent's axis and fill)."""
    fills = fills or {}

    def place(value, axis, fill):
        if value is None:
            return None
        if isinstance(value, dict):
            return {k: place(v, axis, fill) for k, v in value.items()}
        a = np.asarray(value)
        if axis is None:
            return torch.tensor(a, device=device)
        return torch.from_numpy(stripe_of(a, axis, dims, stripe, shard_rank,
                                          fill)).to(device)

    return {k: place(v, striped.get(k), fills.get(k, 0.0))
            for k, v in host.items()}
