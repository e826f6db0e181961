"""The update engine shared by every hashed-feature linear learner.

The reference's hot loop is `process(row) -> train -> model.set(feature, ...)`
(ref: BinaryOnlineClassifierUDTF.java:111-247). Per FeatureBlock [B, K]:

- **scan mode** — a loop over the B rows; each row gathers its K touched
  slots, computes the rule's closed-form update, scatter-adds the deltas.
  Faithful to the reference's sequential semantics (parity tests and small
  models). On the card the exact scan runs as one CUDA kernel per block
  instead (kernels/linear_scan.py, `fit_linear -pallas`); this loop is the
  plain form that the kernel's reference shares its row math with.
- **minibatch mode** — one vectorized gather [B, K], the rule applied to all
  rows against the *stale* batch-start weights, deltas scatter-added
  (averaged per feature when `mini_batch_average`) — the reference's
  documented mini-batch semantic (ref: RegressionBaseUDTF.java:236-295 +
  utils/lang/FloatAccumulator.java:38-41). Batch size 1 equals scan mode.
  ``update_backend="mxu"`` (`-mini_batch B -mxu_scatter`) runs the same
  semantics over ops/mxu_scatter.py's sorted plan: one packed gather, one
  stacked scatter-add without float atomics, derive_w over the whole
  table.

Rules are written once for both modes: a row scalar (score, y, t, ...) has
shape [] in scan mode and [B] in minibatch mode, a lane tensor [K] or
[B, K], and rules broadcast scalars onto lanes with ``x[..., None]``. (The
JAX package keeps a separate optional `batch_update` per rule; one
broadcasting form serves both here.)

Padding: torch has no fill/drop indexing modes, so a lane is live when
``0 <= idx < D``. Gathers read the fill value (0, or 1.0 for covariance) on
dead lanes. Scan-mode scatters select the live lanes; minibatch scatters
accumulate into scratch tables of D + 1 entries whose last entry absorbs the
dead lanes and is dropped — no real slot ever receives a dead lane's value.

Steps update the state's tensors in place where that saves a copy and
return the new state: treat the state passed in as consumed (the JAX
package's steps donate it, the same contract).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .collectives import psum
from .state import LinearState
from .striping import translate_to_stripe


@dataclass
class RowContext:
    """Everything a rule sees for one row (or a [B] batch of rows)."""

    w: torch.Tensor  # [..., K] current weights (0 on dead lanes)
    cov: Optional[torch.Tensor]  # [..., K] covariance (1 on dead lanes)
    slots: Dict[str, torch.Tensor]  # [..., K] optimizer aux
    val: torch.Tensor  # [..., K] feature values
    y: torch.Tensor  # [...] label (+-1 or target)
    score: torch.Tensor  # [...] sum(w * val)
    sq_norm: torch.Tensor  # [...] sum(val^2)
    variance: torch.Tensor  # [...] sum(cov * val^2) (0 if no covariance)
    t: torch.Tensor  # [...] float 1-based example counter
    globals: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class RuleOutput:
    dw: torch.Tensor  # [..., K] additive weight delta
    loss: torch.Tensor  # [...] per-row loss contribution
    updated: torch.Tensor  # [...] bool — did the rule fire
    dcov: Optional[torch.Tensor] = None  # [..., K] additive covariance delta
    dslots: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass(frozen=True)
class Rule:
    """A learner's closed-form per-row update.

    `update(ctx, hyper) -> RuleOutput`. If `derive_w` is set, weights are a
    pure function of the slots (dual-averaging learners like AdaGradRDA):
    after slot deltas are applied the engine recomputes w at touched lanes
    (ref: AdaGradRDAUDTF.java:112-142 where w is rebuilt from u, G, t).
    `pre_row(globals, y)` runs before each row in scan mode;
    `pre_batch(globals, labels)` merges a whole block in minibatch mode.
    """

    name: str
    update: Callable[[RowContext, dict], RuleOutput]
    use_covariance: bool = False
    slot_names: Tuple[str, ...] = ()
    derive_w: Optional[Callable] = None
    global_names: Tuple[str, ...] = ()
    pre_row: Optional[Callable] = None
    pre_batch: Optional[Callable] = None
    is_regression: bool = False
    # How each optimizer slot merges across data-parallel replicas when a
    # mixed model collapses to one (parallel/mix.py merge_slot_arrays):
    # "sum" for additive per-example statistics (AdaGrad accumulators: the
    # replicas saw disjoint shards), "mean" for decayed ones (AdaDelta).
    # Unlisted slots default to "mean" over the replicas that touched the
    # feature.
    slot_merge: Tuple[Tuple[str, str], ...] = ()


DELTA_SLOT = "__delta_upd"  # per-feature update count since the last mix
# (ref: DenseModel.java:52 deltaUpdates)


def live_lanes(idx: torch.Tensor, dims: int):
    """(live mask, safe index): dead lanes index slot 0 and must be masked."""
    live = (idx >= 0) & (idx < dims)
    return live, torch.where(live, idx, torch.zeros_like(idx))


def gather(table: torch.Tensor, sidx: torch.Tensor, live: torch.Tensor,
           fill: float = 0.0) -> torch.Tensor:
    """float32 lanes of `table`, `fill` on dead lanes."""
    return torch.where(live, table[sidx].float(),
                       torch.full((), fill, dtype=torch.float32,
                                  device=table.device))


def row_context(tables, idx, val, y, t, use_cov, globals_=None):
    """Gather a row's (or a batch's) lanes and form its row scalars.
    Returns (ctx, live, sidx)."""
    weights, covars, slots = tables
    live, sidx = live_lanes(idx, weights.shape[0])
    w = gather(weights, sidx, live)
    cov = gather(covars, sidx, live, 1.0) if use_cov else None
    sl = {k: gather(v, sidx, live) for k, v in slots.items()}
    score = torch.sum(w * val, dim=-1)
    sq_norm = torch.sum(val * val, dim=-1)
    variance = torch.sum(cov * val * val, dim=-1) if use_cov \
        else torch.zeros_like(score)
    ctx = RowContext(w, cov, sl, val, y, score, sq_norm, variance, t,
                     globals_ or {})
    return ctx, live, sidx


def make_batch_update(rule: Rule, hyper: dict):
    """Apply a Rule to a whole minibatch in one call.

    Returns `apply(w, cov, sl, val, y, ts, gl) -> RuleOutput` where w/cov/
    val are [B, K], sl maps slot name -> [B, K], y/ts are [B] and gl is the
    rule's scalar globals dict."""
    use_cov = rule.use_covariance

    def apply(w, cov, sl, val, y, ts, gl):
        score = torch.sum(w * val, dim=-1)
        sq_norm = torch.sum(val * val, dim=-1)
        variance = torch.sum(cov * val * val, dim=-1) if use_cov \
            else torch.zeros_like(score)
        ctx = RowContext(w, cov, sl, val, y, score, sq_norm, variance, ts, gl)
        return rule.update(ctx, hyper)

    return apply


def set_last_lane_wins(table: torch.Tensor, sidx: torch.Tensor,
                       mask: torch.Tensor, value: torch.Tensor) -> None:
    """table[sidx[k]] = value[k] for lanes in `mask`; where lanes repeat a
    feature the LAST such lane wins (the kernel's and the Pallas kernel's
    lane order). Duplicates are resolved before the write, so the result
    does not depend on how the device orders colliding writes."""
    sel = torch.nonzero(mask.reshape(-1)).reshape(-1)
    i = sidx.reshape(-1)[sel]
    v = value.reshape(-1)[sel]
    pos = torch.arange(i.shape[0], device=i.device)
    later = (i[:, None] == i[None, :]) & (pos[None, :] > pos[:, None])
    keep = ~later.any(dim=1)
    table[i[keep]] = v[keep].to(table.dtype)


def _to_device(x, dtype, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).to(dtype)


def make_train_fn(
    rule: Rule,
    hyper: dict,
    mode: str = "minibatch",
    mini_batch_average: bool = True,
    track_deltas: bool = False,
    feature_shard: Optional[Tuple[str, int]] = None,
    update_backend: str = "xla",
    device: DeviceLike = None,
):
    """Build `step(state, indices, values, labels) -> (state, loss_sum)`.

    `mode='scan'` replays rows sequentially (reference-exact);
    `mode='minibatch'` applies the whole block against batch-start weights
    (reference's -mini_batch semantics). With `track_deltas`,
    state.slots[DELTA_SLOT] accumulates per-feature update counts.
    Inputs may be numpy arrays or tensors; they are moved to `device`.

    `feature_shard=(mesh, axis, stripe)` runs the same step on this rank's
    [stripe] slice of the model (parallel/sharded_train.py), the training
    analog of the reference's feature-sharded parameter store (ref:
    mix/client/MixRequestRouter.java:56-60): global ids translate to the
    stripe (core/striping.py; lanes this rank does not own are dead and
    their values 0), each row's score / sq_norm / variance partials are
    summed over the mesh axis in ONE all_reduce (a [3] tensor a row in
    scan mode, [3, B] a block in minibatch mode; [2] / [2, B] without a
    covariance), and scatters land in the
    local stripe only. Exact up to the order of that sum: every rule's
    lane update is a function of (global row scalars, lane-local state).
    """
    if mode not in ("scan", "minibatch"):
        raise ValueError(f"unknown mode {mode!r}")
    if update_backend not in ("xla", "mxu"):
        raise ValueError(f"unknown update_backend {update_backend!r}")
    if update_backend == "mxu":
        if mode != "minibatch":
            raise ValueError("update_backend='mxu' requires minibatch mode "
                             "(scan mode is sequential per row)")
        if feature_shard is not None:
            raise ValueError("update_backend='mxu' does not compose with "
                             "feature_shard yet; use the xla backend")
    dev = resolve_device(device)
    use_cov = rule.use_covariance
    n_partials = 3 if use_cov else 2

    def inputs(indices, values, labels):
        idx = _to_device(indices, torch.int64, dev)
        val = _to_device(values, torch.float32, dev)
        if feature_shard is not None:
            mesh, axis, stripe = feature_shard
            idx, val = translate_to_stripe(idx, val, mesh.index(axis),
                                           stripe)
        return idx, val, _to_device(labels, torch.float32, dev)

    def global_scalars(ctx: RowContext) -> RowContext:
        """Sharded: the row partials summed over the shard axis (one
        collective); unsharded: as they are."""
        if feature_shard is None:
            return ctx
        mesh, axis, _ = feature_shard
        parts = torch.stack([ctx.score, ctx.sq_norm, ctx.variance]
                            [:n_partials])
        parts = psum(parts, mesh, axis)
        ctx.score, ctx.sq_norm = parts[0], parts[1]
        if use_cov:
            ctx.variance = parts[2]
        return ctx

    def scan_step(state: LinearState, indices, values, labels):
        indices, values, labels = inputs(indices, values, labels)
        weights, covars, touched = state.weights, state.covars, state.touched
        slots = dict(state.slots)
        gl = dict(state.globals)
        t = state.step
        losses = []
        for b in range(indices.shape[0]):
            y = labels[b]
            tf = torch.tensor(float(t + 1), device=dev)
            if rule.pre_row is not None:
                gl = rule.pre_row(gl, y)
            ctx, live, sidx = row_context((weights, covars, slots),
                                          indices[b], values[b], y, tf,
                                          use_cov, gl)
            out = rule.update(global_scalars(ctx), hyper)  # graftcheck: disable=G036 (psum copies through the host only when gloo reduces CUDA tensors; NCCL sums on the card)
            lidx = sidx[live]
            # rule math runs in f32; bf16 tables take the delta cast to
            # their storage dtype
            weights.index_add_(0, lidx, out.dw[live].to(weights.dtype))
            if use_cov and out.dcov is not None:
                covars.index_add_(0, lidx, out.dcov[live].to(covars.dtype))
            for k, d in out.dslots.items():
                slots[k].index_add_(0, lidx, d[live].to(slots[k].dtype))
            if rule.derive_w is not None:
                # lane-wise slot values after this row's delta
                sl_new = {k: ctx.slots[k] + out.dslots.get(k, 0.0)
                          for k in slots}
                w_new = rule.derive_w(sl_new, tf, hyper)
                w_new = torch.where(out.updated, w_new, ctx.w)
                set_last_lane_wins(weights, sidx, live, w_new)
            upd = out.updated.to(torch.int8)
            touched[lidx] = torch.maximum(touched[lidx], upd)
            if track_deltas:
                slots[DELTA_SLOT].index_add_(
                    0, lidx, out.updated.to(slots[DELTA_SLOT].dtype)
                    .expand(lidx.shape[0]))
            t += 1
            losses.append(out.loss)
        loss = torch.stack(losses).sum() if losses \
            else torch.zeros((), device=dev)
        new_state = state.replace(weights=weights, covars=covars, slots=slots,
                                  touched=touched, step=t, globals=gl)
        return new_state, loss

    def minibatch_step(state: LinearState, indices, values, labels):
        indices, values, labels = inputs(indices, values, labels)
        b = indices.shape[0]
        d = state.dims
        t0 = state.step
        ts = (t0 + 1 + torch.arange(b, device=dev)).float()
        gl = dict(state.globals)
        if rule.pre_batch is not None:
            gl = rule.pre_batch(gl, labels)
        ctx, live, sidx = row_context(
            (state.weights, state.covars, state.slots), indices, values,
            labels, ts, use_cov, gl)
        outs = rule.update(global_scalars(ctx), hyper)
        lane_upd = outs.updated.float()[:, None] * torch.ones_like(values)
        # dead lanes land in the scratch tables' extra last entry
        sink = torch.where(live, indices, torch.full_like(indices, d)) \
            .reshape(-1)

        def scatter_sum(src):
            acc = torch.zeros(d + 1, dtype=torch.float32, device=dev)
            acc.index_add_(0, sink, src.reshape(-1).float())
            return acc[:d]

        counts = scatter_sum(lane_upd)
        denom = torch.clamp(counts, min=1.0) if mini_batch_average else None

        def apply(table, delta):
            # FloatAccumulator semantics: accumulate in f32 even over bf16
            # tables, cast once at the table write
            total = scatter_sum(delta)
            if denom is not None:
                total = total / denom
            return (table.float() + total).to(table.dtype)

        weights = apply(state.weights, outs.dw)
        covars = state.covars
        if use_cov and outs.dcov is not None:
            covars = apply(state.covars, outs.dcov)
        new_slots = dict(state.slots)
        for k in rule.slot_names:
            if k in outs.dslots:
                new_slots[k] = (state.slots[k]
                                + scatter_sum(outs.dslots[k])
                                .to(state.slots[k].dtype))
        if rule.derive_w is not None:
            # Dual-averaging weights are a pure function of the *updated*
            # accumulators. Every lane that fired computes the same w for its
            # feature (same slots, same t), so a lane that fired wins over
            # one that did not, and the write is deterministic on any
            # device (the JAX package's mxu backend rule, engine.py:471).
            tf_end = torch.tensor(float(t0 + b), device=dev)
            sl_g = {k: gather(new_slots[k], sidx, live) for k in new_slots}
            w_new = rule.derive_w(sl_g, tf_end, hyper)
            fired = (lane_upd > 0) & live
            target = torch.where(fired, indices, torch.full_like(indices, d))
            ext = torch.cat([weights, weights.new_zeros(1)])
            ext[target.reshape(-1)] = w_new.reshape(-1).to(ext.dtype)
            weights = ext[:d]
        touched = torch.maximum(state.touched, (counts > 0).to(torch.int8))
        if track_deltas:
            new_slots[DELTA_SLOT] = new_slots[DELTA_SLOT] + counts.to(
                new_slots[DELTA_SLOT].dtype)
        new_state = state.replace(weights=weights, covars=covars,
                                  slots=new_slots, touched=touched,
                                  step=t0 + b, globals=gl)
        return new_state, torch.sum(outs.loss)

    def minibatch_step_mxu(state: LinearState, indices, values, labels):
        """minibatch_step with every table access routed through
        ops/mxu_scatter's sorted plan — the FloatAccumulator semantics,
        f32 sums equal up to addition order. One packed gather serves w,
        cov and every slot; one stacked scatter-add into a zero table
        serves every delta column plus the update counts; derive_w rules
        recompute w over the whole table, kept where a feature fired."""
        from ..ops import mxu_scatter as mxu

        indices, values, labels = inputs(indices, values, labels)
        b, k = indices.shape
        d = state.dims
        t0 = state.step
        ts = (t0 + 1 + torch.arange(b, device=dev)).float()
        gl = dict(state.globals)
        if rule.pre_batch is not None:
            gl = rule.pre_batch(gl, labels)
        ids = indices.reshape(-1)
        plan = mxu.make_plan(ids, d)

        # ONE gather for everything: w [+ cov] [+ slots], padded to a
        # power-of-two column count
        slot_names = tuple(sorted(state.slots))
        cols = [state.weights] + ([state.covars] if use_cov else []) + \
            [state.slots[n] for n in slot_names]
        ncol = len(cols)
        cpad = mxu.pad_cols(ncol)
        packed = torch.stack([c.float() for c in cols]
                             + [cols[0].float()] * (cpad - ncol), dim=-1)
        g = mxu.gather(packed, plan).reshape(b, k, cpad)
        w_g = g[..., 0]
        pos = 1
        cov_g = None
        if use_cov:
            # an out-of-range lane reads covariance 1.0
            oob = (indices < 0) | (indices >= d)
            cov_g = torch.where(oob, 1.0, g[..., pos])
            pos += 1
        sl_g = {n: g[..., pos + i] for i, n in enumerate(slot_names)}
        outs = make_batch_update(rule, hyper)(w_g, cov_g, sl_g, values,
                                              labels, ts, gl)
        lane_upd = outs.updated.float()[:, None] * torch.ones_like(values)

        # ONE stacked scatter-add into zeros: dw [+ dcov] [+ dslots] + counts
        dcols = [outs.dw]
        if use_cov and outs.dcov is not None:
            dcols.append(outs.dcov)
        scat_slots = [n for n in rule.slot_names if n in outs.dslots]
        dcols += [outs.dslots[n] for n in scat_slots]
        dcols.append(lane_upd)
        nd = len(dcols)
        dstack = torch.stack([c.float() for c in dcols], dim=-1) \
            .reshape(b * k, nd)
        sums = mxu.scatter_add(
            torch.zeros((d, mxu.pad_cols(nd)), dtype=torch.float32,
                        device=dev), ids, dstack, plan)
        counts = sums[:, nd - 1]
        denom = torch.clamp(counts, min=1.0) if mini_batch_average \
            else torch.ones((), device=dev)
        weights = (state.weights.float() + sums[:, 0] / denom) \
            .to(state.weights.dtype)
        covars = state.covars
        pos = 1
        if use_cov and outs.dcov is not None:
            covars = (state.covars.float() + sums[:, pos] / denom) \
                .to(state.covars.dtype)
            pos += 1
        new_slots = dict(state.slots)
        for n in scat_slots:
            new_slots[n] = (state.slots[n].float() + sums[:, pos]) \
                .to(state.slots[n].dtype)
            pos += 1
        if rule.derive_w is not None:
            # w is a pure element-wise function of the slots: recompute it
            # over the WHOLE table and keep the old value where nothing
            # fired — no gather-after-scatter round trip
            tf_end = torch.tensor(float(t0 + b), device=dev)
            w_full = rule.derive_w({n: t.float() for n, t in
                                    new_slots.items()}, tf_end, hyper)
            weights = torch.where(counts > 0, w_full.to(weights.dtype),
                                  weights)
        touched = torch.maximum(state.touched, (counts > 0).to(torch.int8))
        if track_deltas:
            new_slots[DELTA_SLOT] = new_slots[DELTA_SLOT] + counts.to(
                new_slots[DELTA_SLOT].dtype)
        new_state = state.replace(weights=weights, covars=covars,
                                  slots=new_slots, touched=touched,
                                  step=t0 + b, globals=gl)
        return new_state, torch.sum(outs.loss)

    if mode == "scan":
        return scan_step
    return minibatch_step_mxu if update_backend == "mxu" else minibatch_step


def make_train_step(
    rule: Rule,
    hyper: dict,
    mode: str = "minibatch",
    mini_batch_average: bool = True,
    update_backend: str = "xla",
    device: DeviceLike = None,
):
    """The single-replica step: `make_train_fn` on ``device`` (None: the
    CUDA device, or raise). The JAX package jits the step here and donates
    the state passed in; eager torch has nothing to compile, and the
    port's steps consume the state they are given (the module docstring),
    the stand-in for that donation."""
    return make_train_fn(rule, hyper, mode=mode,
                         mini_batch_average=mini_batch_average,
                         update_backend=update_backend, device=device)


def make_epoch(step_fn):
    """Whole-epoch driver: a loop of `step_fn` over a stack of staged blocks.

    `step_fn(state, *block) -> (state, loss)`. Returns
    `epoch(state, *stacked) -> (state, losses)` where each element of
    `stacked` has a leading [n_blocks] axis and `losses` is the per-block
    loss stack.
    """

    def epoch(state, *stacked):
        losses = []
        for i in range(len(stacked[0])):
            state, loss = step_fn(state, *(s[i] for s in stacked))
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch


def make_predict(use_covariance: bool = False):
    """Batched predict: score [B] (and variance [B] for covariance
    learners) — the reference's calcScoreAndNorm/calcScoreAndVariance
    (ref: BinaryOnlineClassifierUDTF.java:169-229). Runs on the state's
    device."""

    def predict(state: LinearState, indices, values):
        dev = state.device
        indices = _to_device(indices, torch.int64, dev)
        values = _to_device(values, torch.float32, dev)
        live, sidx = live_lanes(indices, state.dims)
        score = torch.sum(gather(state.weights, sidx, live) * values, dim=-1)
        if use_covariance and state.covars is not None:
            cov = gather(state.covars, sidx, live, 1.0)
            return score, torch.sum(cov * values * values, dim=-1)
        return score

    return predict
