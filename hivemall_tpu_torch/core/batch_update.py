"""The segment-sum batched update backend (`-batch B`).

The port of `hivemall_tpu/core/batch_update.py`. It runs the engine's
minibatch semantics — every row of a B-row chunk computed against the
chunk-start tables, deltas summed per feature in f32 and averaged by the
feature's update count (the reference's FloatAccumulator,
RegressionBaseUDTF.java:236-295) — through a plan staged on the host:

- staging builds ONE `StagedDedupPlan` per chunk of B rows in numpy (a
  stable argsort and a segment pass; ops/scatter.py), once per block; the
  fit uploads each block's plans once and replays them every epoch;
- the step walks the block's chunks in a Python loop; each chunk gathers
  every table ONCE at the plan's unique slots, fans the values out to the
  lanes, runs the rule batch-wise (`core.engine.make_batch_update`),
  reduces all delta columns with ONE prefix sum, and writes each table
  back with one compact write per unique live slot — U lanes instead of
  B*K, and no [D]-sized temporary anywhere.

The chunk loop never waits on the device: chunk sizes, slot buckets and
each chunk's count of live slots are host integers fixed at staging, so
no op reads a device value back (no `.item()`, no `nonzero`, no mask
indexing). Semantics are the JAX batch backend's up to float reduction
order; integer tables (`touched`, DELTA_SLOT counts) are exact.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.scatter import (StagedDedupPlan, broadcast_lanes,
                           build_staged_plan, pad_plan, staged_gather,
                           staged_plan_to_device, staged_scatter_add,
                           staged_scatter_set, staged_segment_totals,
                           staged_touch_max)
from .engine import DELTA_SLOT, Rule, _to_device, make_batch_update
from .state import LinearState


class BlockPlans(NamedTuple):
    """Staged plans for one block: `main` stacks the block's full B-row
    chunks ([nb, ...] leading axis, one shared U bucket); `tail` covers the
    remainder rows with its own shapes (no sentinel rows, so the example
    counter and the scalar globals stay exact)."""

    main: Optional[StagedDedupPlan]
    tail: Optional[StagedDedupPlan]

    @property
    def slot_bucket(self) -> int:
        return int(self.main.rep.shape[-1]) if self.main is not None else 0


def _chunk_plans(indices, batch_size: int, dims: int):
    """Host side: one unstacked plan per B-row chunk of a block [N, K],
    plus the remainder chunk's plan. Stacking to a common U bucket is
    pad_plan, never a re-sort."""
    n = int(indices.shape[0])
    b = min(batch_size, n)
    nb = n // b
    chunks: List[StagedDedupPlan] = [
        build_staged_plan(np.asarray(indices[c * b:(c + 1) * b]).reshape(-1),
                          dims)
        for c in range(nb)]
    tail = None
    if n - nb * b:
        tail = build_staged_plan(
            np.asarray(indices[nb * b:]).reshape(-1), dims)
    return chunks, tail


def _stack_chunks(chunks: List[StagedDedupPlan], slots: int,
                  dims: int) -> StagedDedupPlan:
    widened = [pad_plan(p, slots, dims) for p in chunks]
    return StagedDedupPlan(*[np.stack([getattr(p, f) for p in widened])
                             for f in StagedDedupPlan._fields])


def stage_block_plans(indices, batch_size: int, dims: int,
                      slots: Optional[int] = None) -> BlockPlans:
    """Host side: one dedup plan per B-row chunk of a staged block [N, K].
    `slots` pins the main chunks' U bucket from below."""
    chunks, tail = _chunk_plans(indices, batch_size, dims)
    main = None
    if chunks:
        u = max(p.rep.shape[0] for p in chunks)
        if slots is not None:
            u = max(u, slots)
        main = _stack_chunks(chunks, u, dims)
    return BlockPlans(main=main, tail=tail)


def stage_epoch_plans(indices, batch_size: int, dims: int) -> BlockPlans:
    """Plans for an epoch's stacked blocks [n_blocks, N, K]: every block's
    chunks share one U bucket ([n_blocks, nb, ...]). Blocks below the
    epoch-wide bucket are widened with pad_plan, never re-sorted."""
    n_blocks = int(indices.shape[0])
    per_block = [_chunk_plans(indices[i], batch_size, dims)
                 for i in range(n_blocks)]
    if any(t is not None for _, t in per_block):
        raise ValueError("epoch staging requires block rows divisible by "
                         "the batch size (blocks are operator-shaped; pad "
                         "or trim the trailing rows at the caller)")
    u = max(p.rep.shape[0] for chunks, _ in per_block for p in chunks)
    stacked = [_stack_chunks(chunks, u, dims) for chunks, _ in per_block]
    main = StagedDedupPlan(*[np.stack([getattr(sb, f) for sb in stacked])
                             for f in StagedDedupPlan._fields])
    return BlockPlans(main=main, tail=None)


class DeviceBlockPlans(NamedTuple):
    """A block's plans on the device (int64 tensors) beside each chunk's
    count of live slots (host ints: `rep` ascends, so the slots below
    `dims` are a prefix). The counts ride beside the plan, not in it, so
    the plan stays the reference's and the frozen ABI's."""

    main: Optional[StagedDedupPlan]
    main_live: Tuple[int, ...]
    tail: Optional[StagedDedupPlan]
    tail_live: int


def upload_block_plans(plans: BlockPlans, dims: int,
                       device: DeviceLike = None) -> DeviceBlockPlans:
    """Copy a block's host plans to `device` once (the fit caches the
    result across epochs)."""
    dev = resolve_device(device)

    def live(rep):
        return np.sum(np.asarray(rep) < dims, axis=-1)

    main = tail = None
    main_live: Tuple[int, ...] = ()
    tail_live = 0
    if plans.main is not None:
        main = staged_plan_to_device(plans.main, dev)
        main_live = tuple(int(c) for c in live(plans.main.rep))
    if plans.tail is not None:
        tail = staged_plan_to_device(plans.tail, dev)
        tail_live = int(live(plans.tail.rep))
    return DeviceBlockPlans(main, main_live, tail, tail_live)


def make_batch_train_fn(
    rule: Rule,
    hyper: dict,
    batch_size: int,
    mini_batch_average: bool = True,
    track_deltas: bool = False,
    device: DeviceLike = None,
):
    """`step(state, indices, values, labels, plans) -> (state, loss_sum)`,
    the batched backend's step. `plans` is
    `stage_block_plans(indices, batch_size, dims)` for the same indices,
    or its `upload_block_plans` form (host plans are uploaded per call).
    Tables are updated in place; the state passed in is consumed."""
    dev = resolve_device(device)
    use_cov = rule.use_covariance
    apply_update = make_batch_update(rule, hyper)

    def chunk_update(tables, idx, val, y, plan, live, t0, gl):
        weights, covars, slots, touched = tables
        bsz = idx.shape[0]
        ts = (t0 + 1 + torch.arange(bsz, device=dev)).float()
        if rule.pre_batch is not None:
            gl = rule.pre_batch(gl, y)

        # one gather per table at the unique slots (ascending ids), fanned
        # out to lanes; pad lanes belong to dropped slots, which read the
        # fill, and carry value 0. bf16 tables widen per [U] window only.
        def lanes(table, fill=0.0):
            u = staged_gather(table, plan, fill, live).float()
            return u, broadcast_lanes(u, plan).reshape(idx.shape)

        _, w_l = lanes(weights)
        cov_l = lanes(covars, 1.0)[1] if use_cov else None
        sl = {k: lanes(slots[k]) for k in rule.slot_names}
        out = apply_update(w_l, cov_l, {k: v[1] for k, v in sl.items()},
                           val, y, ts, gl)
        lane_upd = out.updated.float()[:, None].expand(idx.shape)

        # ALL delta columns reduce under the one plan: dw [+ dcov]
        # [+ dslots] + the update counts, stacked as rows so the prefix
        # sum runs along contiguous lanes
        cols = [out.dw]
        if use_cov and out.dcov is not None:
            cols.append(out.dcov)
        scat_slots = [k for k in rule.slot_names if k in out.dslots]
        cols += [out.dslots[k] for k in scat_slots]
        cols.append(lane_upd)
        stack = torch.stack([c.float().reshape(-1) for c in cols])
        sums = staged_segment_totals(plan, stack.t())  # [U, nd]
        counts = sums[:, -1]
        denom = counts if mini_batch_average else None

        staged_scatter_add(weights, plan, sums[:, 0], denom, live)
        pos = 1
        if use_cov and out.dcov is not None:
            staged_scatter_add(covars, plan, sums[:, pos], denom, live)
            pos += 1
        slot_sums = {}
        for k in scat_slots:
            slot_sums[k] = sums[:, pos]
            staged_scatter_add(slots[k], plan, slot_sums[k], None, live)
            pos += 1
        if rule.derive_w is not None:
            # dual-averaging weights are a pure function of the post-update
            # slots: computed per unique slot, no gather after the scatter
            sl_new = {k: sl[k][0] + slot_sums[k] if k in slot_sums
                      else sl[k][0] for k in rule.slot_names}
            w_new = rule.derive_w(sl_new, float(t0 + bsz), hyper)  # [U]
            staged_scatter_set(weights, plan, w_new, counts > 0, live)
        staged_touch_max(touched, plan, counts, live)
        if track_deltas:
            staged_scatter_add(slots[DELTA_SLOT], plan, counts, None, live)
        return gl, torch.sum(out.loss)

    def step(state: LinearState, indices, values, labels, plans):
        indices = _to_device(indices, torch.int64, dev)
        values = _to_device(values, torch.float32, dev)
        labels = _to_device(labels, torch.float32, dev)
        if isinstance(plans, BlockPlans):
            plans = upload_block_plans(plans, state.dims, dev)
        n = indices.shape[0]
        slots = dict(state.slots)
        tables = (state.weights, state.covars, slots, state.touched)
        gl = dict(state.globals)
        t = state.step
        loss_total = torch.zeros((), device=dev)
        n_main = 0
        if plans.main is not None:
            nb = plans.main.order.shape[0]
            b = (n // nb) if plans.tail is None else batch_size
            n_main = nb * b
            losses = []
            for c in range(nb):
                rows = slice(c * b, (c + 1) * b)
                plan = StagedDedupPlan(*(a[c] for a in plans.main))
                gl, loss = chunk_update(tables, indices[rows], values[rows],
                                        labels[rows], plan,
                                        plans.main_live[c], t, gl)
                losses.append(loss)
                t += b
            loss_total = torch.stack(losses).sum()
        if plans.tail is not None:
            rows = slice(n_main, n)
            gl, loss = chunk_update(tables, indices[rows], values[rows],
                                    labels[rows], plans.tail,
                                    plans.tail_live, t, gl)
            loss_total = loss_total + loss
        new_state = state.replace(slots=slots, step=state.step + n,
                                  globals=gl)
        return new_state, loss_total

    return step


def make_batch_train_step(
    rule: Rule,
    hyper: dict,
    batch_size: int,
    mini_batch_average: bool = True,
    track_deltas: bool = False,
    device: DeviceLike = None,
):
    """The step `fit_linear -batch B` runs: `make_batch_train_fn` as it is
    (the JAX package jits it here; torch runs it eagerly)."""
    return make_batch_train_fn(rule, hyper, batch_size,
                               mini_batch_average=mini_batch_average,
                               track_deltas=track_deltas, device=device)
