"""Collective model mixing: the port of ``hivemall_tpu/parallel/mix.py``.

The reference's MIX protocol (ref: SURVEY.md §2.18;
mix/client/MixClient.java:48-173, mixserv/.../MixServerHandler.java:54-158)
is an asynchronous, feature-sharded parameter server over Netty TCP. Under
synchronous data parallelism it collapses into collectives:

- each rank trains a full model replica on its data shard (the Hadoop
  mapper analog), with per-feature update counts since the last mix;
- every ``mix_every`` blocks, the replicas are averaged over the mesh axis
  with one of the reference's two reduction operators:
    * ``average``    — delta-weighted mean sum(w * delta) / sum(delta)
                       (ref: PartialAverage.java:43-67)
    * ``argmin_kld`` — precision-weighted mean sum(w/cov) / sum(1/cov),
                       cov' = 1/sum(1/cov) (ref: PartialArgminKLD.java:43-63)
- features untouched on every replica keep their local value (the server
  never saw them).

Each mix is ONE all_reduce of the stacked per-feature operands ([2, D] for
the average, [3, D] for argminKLD). Each rank holds its own replica with
no leading device axis (the JAX state carries ``[n_dev]``);
``final_state`` gathers the replicas to host numpy ``[n_dev, ...]`` arrays
and runs the same host collapse as the JAX package (these numpy functions
are copies of its).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.engine import DELTA_SLOT, Rule, make_train_fn
from ..core.state import (LinearState, init_linear_state,
                          linear_state_from_numpy, linear_state_to_numpy)
from ..runtime.tracing import TRACER
from .mesh import WORKER_AXIS, Mesh, all_gather_host, make_mesh, psum


def mix_average(weights: torch.Tensor, delta_upd: torch.Tensor, mesh: Mesh,
                axis: str = WORKER_AXIS):
    """Delta-weighted arithmetic mean across the mesh axis (ref:
    PartialAverage.java getWeight = scaledSumWeights/totalUpdates).
    Returns (mixed weights in the table's dtype, total updates)."""
    w = weights.float()
    total, wsum = psum(torch.stack([delta_upd, w * delta_upd]), mesh, axis)
    mixed = torch.where(total > 0.0, wsum / torch.clamp(total, min=1.0), w)
    return mixed.to(weights.dtype), total


def mix_argmin_kld(weights: torch.Tensor, covars: torch.Tensor,
                   delta_upd: torch.Tensor, mesh: Mesh,
                   axis: str = WORKER_AXIS):
    """Precision-weighted (inverse-variance) mean across the mesh axis
    (ref: PartialArgminKLD.java:43-63, ensemble/ArgminKLDistanceUDAF.java).
    Returns (mixed weights, mixed covariances, total updates)."""
    w, cov = weights.float(), covars.float()
    inv = 1.0 / cov
    total, sum_inv, sum_wdiv = psum(torch.stack([delta_upd, inv, w * inv]),
                                    mesh, axis)
    mixed_w = torch.where(total > 0.0, sum_wdiv / sum_inv, w)
    mixed_cov = torch.where(total > 0.0, 1.0 / sum_inv, cov)
    return mixed_w.to(weights.dtype), mixed_cov.to(covars.dtype), total


def grouped_mix_scan(local_body, mix, state, blocks, mix_every: int):
    """Consume ``blocks`` (a tuple of arrays, each [k, ...]) in groups of
    ``mix_every``: train locally within a group, then apply ``mix`` once
    (the sync-threshold semantic of every mix trainer, ref:
    MixServerHandler.java:142-148).

    local_body: (state, block_tuple) -> (state, loss)
    mix:        state -> state
    Returns (state, total local loss)."""
    k = blocks[0].shape[0]
    if k % mix_every != 0:
        raise ValueError(
            f"{k} blocks per device not divisible by mix_every={mix_every}")
    total = None
    for g0 in range(0, k, mix_every):
        losses = []
        for i in range(g0, g0 + mix_every):
            state, loss = local_body(state, tuple(b[i] for b in blocks))
            losses.append(loss)
        state = mix(state)
        group = torch.stack(losses).sum()
        total = group if total is None else total + group
    return state, total


def sum_loss(loss: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The replicas' losses summed over the axis (JAX's ``psum(loss)``)."""
    return psum(loss.float().reshape(1).clone(), mesh, axis)[0]


def merge_slot_arrays(slots: dict, touched_all: np.ndarray, kinds: dict,
                      drop: Tuple[str, ...] = ()) -> dict:
    """Merge per-replica optimizer-slot arrays ([n_dev, ...]) into one
    model per each slot's declared kind (Rule.slot_merge): "sum" for
    additive statistics over the replicas' disjoint data shards, "mean"
    (default) for decayed ones — weighted by which replicas touched each
    entry. Slots named in ``drop`` reset to zero."""
    tmask = touched_all.astype(np.float32)
    n_touch = np.maximum(tmask.sum(axis=0), 1.0)
    merged = {}
    for name, arr in slots.items():
        arr = np.asarray(arr)  # [n_dev, ...]
        if name in drop:
            merged[name] = np.zeros_like(arr[0])
            continue
        mask = tmask
        denom = n_touch
        while mask.ndim < arr.ndim:
            mask = mask[..., None]
            denom = denom[..., None]
        total = (arr * mask).sum(axis=0)
        if kinds.get(name, "mean") == "sum":
            merged[name] = total
        else:
            merged[name] = total / denom
    return merged


def split_replica_blocks(n_replicas: int, index: int, *arrays):
    """This replica's [k, B, ...] slice of host blocks [R * k, B, ...] (the
    JAX helper returns all [R, k, B, ...] replicas; a rank keeps its own)."""
    nk = arrays[0].shape[0]
    k = nk // n_replicas
    if k * n_replicas != nk:
        raise ValueError(f"{nk} blocks not divisible by {n_replicas} replicas")
    return tuple(a[index * k:(index + 1) * k] for a in arrays)


def make_linear_mix(reduction: str, mesh: Mesh, axis: str):
    """The collective mix of a LinearState replica: delta-weighted average
    or argminKLD over ``axis``, then the pending-delta counter resets.
    Shared by MixTrainer and the replica axis of Sharded2DTrainer."""

    def mix(st: LinearState) -> LinearState:
        delta = st.slots[DELTA_SLOT]
        if reduction == "argmin_kld":
            w, cov, _ = mix_argmin_kld(st.weights, st.covars, delta, mesh,
                                       axis)
            st = st.replace(weights=w, covars=cov)
        else:
            w, _ = mix_average(st.weights, delta, mesh, axis)
            st = st.replace(weights=w)
        return st.replace(slots={**st.slots,
                                 DELTA_SLOT: torch.zeros_like(delta)})

    return mix


def _welford_sub(nc, mc, m2c, n0, mu0, m20):
    """Chan-inverse: remove the base stream (n0, mu0, m20) from a combined
    (nc, mc, m2c), returning the local remainder — exact."""
    n_l = nc - n0
    if n_l <= 0:
        return 0.0, 0.0, 0.0
    mean_l = (mc * nc - mu0 * n0) / n_l
    m2_l = m2c - m20 - (n0 * n_l / nc) * (mean_l - mu0) ** 2
    return n_l, mean_l, max(m2_l, 0.0)


def _welford_add(n_a, mu_a, m2_a, n_b, mu_b, m2_b):
    """Chan parallel merge of two streams — exact."""
    n = n_a + n_b
    if n == 0:
        return 0.0, 0.0, 0.0
    delta = mu_b - mu_a
    mean = mu_a + delta * n_b / n
    m2 = m2_a + m2_b + delta * delta * n_a * n_b / n
    return n, mean, m2


_WELFORD = {"n", "mean", "m2"}


def strip_replica_base(host: dict, base: dict, slot_kinds: dict) -> dict:
    """Remove a warm-start base (the checkpoint every replica was seeded
    with) from each replica's ADDITIVE statistics, so the collapse does
    not count it once per replica: "sum"-kind slots and the step counter
    subtract the base per replica; Welford globals Chan-subtract it.
    ``host`` holds [n_dev, ...] fields, ``base`` one model's (both in
    `linear_state_to_numpy`'s layout)."""
    new_slots = dict(host.get("slots") or {})
    for name, kind in slot_kinds.items():
        if kind == "sum" and name in new_slots and name in base["slots"]:
            new_slots[name] = np.asarray(new_slots[name]) \
                - np.asarray(base["slots"][name])[None]
    gl = dict(host.get("globals") or {})
    if _WELFORD <= set(gl) and _WELFORD <= set(base.get("globals") or {}):
        b = base["globals"]
        n0, mu0, m20 = (float(np.asarray(b[k])) for k in ("n", "mean", "m2"))
        parts = [_welford_sub(float(gl["n"][r]), float(gl["mean"][r]),
                              float(gl["m2"][r]), n0, mu0, m20)
                 for r in range(np.asarray(gl["n"]).shape[0])]
        gl = {**gl, **{k: np.asarray([p[i] for p in parts], np.float32)
                       for i, k in enumerate(("n", "mean", "m2"))}}
    return {**host, "slots": new_slots, "globals": gl,
            "step": np.asarray(host["step"]) - int(base["step"])}


def add_replica_base(merged: dict, base: dict, slot_kinds: dict) -> dict:
    """Restore the warm-start base ONCE into a collapsed model (see
    strip_replica_base)."""
    new_slots = dict(merged.get("slots") or {})
    for name, kind in slot_kinds.items():
        if kind == "sum" and name in new_slots and name in base["slots"]:
            new_slots[name] = np.asarray(new_slots[name]) \
                + np.asarray(base["slots"][name])
    gl = dict(merged.get("globals") or {})
    if _WELFORD <= set(gl) and _WELFORD <= set(base.get("globals") or {}):
        b = base["globals"]
        n, mu, m2 = _welford_add(
            float(gl["n"]), float(gl["mean"]), float(gl["m2"]),
            float(b["n"]), float(b["mean"]), float(b["m2"]))
        gl = {**gl, "n": np.float32(n), "mean": np.float32(mu),
              "m2": np.float32(m2)}
    return {**merged, "slots": new_slots, "globals": gl,
            "step": np.int32(int(merged["step"]) + int(base["step"]))}


def collapse_linear_replicas(host: dict, slot_kinds: dict) -> dict:
    """Collapse a host state whose fields carry a leading replica axis
    (`linear_state_to_numpy`'s layout) into one model a warm restart can
    resume from (ref: LearnerBaseUDTF.java:215-333):

    - weights / covars: identical across replicas after the trailing mix,
      replica 0's copy is the mixed model;
    - touched: max (the union of features any replica updated);
    - optimizer slots: merged per the rule's declared kind over the
      replicas that touched each feature; the delta counter resets;
    - Welford globals (n, mean, m2): Chan's exact parallel merge; other
      globals keep replica 0's value;
    - step: the sum.
    """
    touched_all = np.asarray(host["touched"])
    merged = {
        "weights": np.asarray(host["weights"])[0],
        "covars": None if host.get("covars") is None
        else np.asarray(host["covars"])[0],
        "touched": np.max(touched_all, axis=0),
        "slots": {k: np.asarray(v)[0] for k, v in host["slots"].items()},
        "globals": {k: np.asarray(v)[0]
                    for k, v in host["globals"].items()},
    }
    if host["slots"]:
        merged["slots"] = merge_slot_arrays(host["slots"], touched_all,
                                            slot_kinds, drop=(DELTA_SLOT,))
    gl = {k: np.asarray(v) for k, v in host["globals"].items()}
    if _WELFORD <= set(gl):
        n = gl["n"].astype(np.float64)
        tot = n.sum()
        if tot > 0:
            mean = float((gl["mean"] * n).sum() / tot)
            m2 = float(gl["m2"].sum() + (n * (gl["mean"] - mean) ** 2).sum())
            merged["globals"] = {**merged["globals"], "n": np.float32(tot),
                                 "mean": np.float32(mean),
                                 "m2": np.float32(m2)}
    step_all = np.asarray(host["step"])
    merged["step"] = step_all.sum().astype(step_all.dtype)
    return merged


def gather_linear_host(state: LinearState, mesh: Mesh, axis: str) -> dict:
    """Every replica's fields along ``axis`` as host numpy [n, ...] arrays
    (`linear_state_to_numpy`'s layout, one leading axis more)."""
    def g(x):
        return all_gather_host(x, mesh, axis)

    return {
        "weights": g(state.weights),
        "covars": None if state.covars is None else g(state.covars),
        "slots": {k: g(v) for k, v in state.slots.items()},
        "touched": g(state.touched),
        "step": g(state.step).astype(np.int32),
        "globals": {k: g(v) for k, v in state.globals.items()},
    }


def host_linear(state) -> dict:
    """A LinearState (any device) or its numpy fields, as numpy fields."""
    return linear_state_to_numpy(state) if isinstance(state, LinearState) \
        else state


def resolve_reduction(reduction: str, use_covariance: bool) -> str:
    """``"auto"``: argminKLD for covariance rules (the reference's event
    selection for covariance learners), else the delta-weighted average."""
    if reduction == "auto":
        return "argmin_kld" if use_covariance else "average"
    if reduction not in ("average", "argmin_kld"):
        raise ValueError(f"unknown reduction {reduction!r}")
    return reduction


@dataclass(frozen=True)
class MixConfig:
    # Mix after this many blocks: the sync-threshold analog (ref:
    # mixserv/.../MixServerHandler.java:142-148). Each step() call's blocks
    # are consumed in groups of `mix_every`, with one collective mix after
    # each group. For covariance learners every argminKLD mix REPLACES the
    # covariance with 1/sum(1/cov), so mixing after every block shrinks it
    # ~n_dev-fold a block; the reference's effective cadence is tens of
    # updates between mixes (threshold 3 x syncThreshold 30).
    mix_every: int = 1
    reduction: str = "auto"  # average | argmin_kld | auto
    axis_name: str = WORKER_AXIS


class MixTrainer:
    """Data-parallel trainer: one model replica per rank of the mesh axis,
    with periodic collective mixing. ``step`` takes this rank's blocks
    ``[k, B, ...]`` (`shard_blocks` cuts them from the global
    ``[n_dev * k, B, ...]``); the loss it returns is summed over the
    replicas."""

    def __init__(self, rule: Rule, hyper: dict, dims: int,
                 mesh: Optional[Mesh] = None,
                 config: MixConfig = MixConfig(), mode: str = "minibatch"):
        self.rule = rule
        self.hyper = hyper
        self.dims = dims
        self.mesh = mesh if mesh is not None else make_mesh()
        self.config = config
        self.axis = config.axis_name
        self.reduction = resolve_reduction(config.reduction,
                                           rule.use_covariance)
        self.n_dev = self.mesh.shape[self.axis]
        self._resume_base = None  # set by init(from_state=...)
        self._local = make_train_fn(rule, hyper, mode=mode,
                                    track_deltas=True,
                                    device=self.mesh.device)
        self._mix = make_linear_mix(self.reduction, self.mesh, self.axis)

    def _init_one(self, **kw) -> LinearState:
        return init_linear_state(
            self.dims, use_covariance=self.rule.use_covariance,
            slot_names=tuple(self.rule.slot_names) + (DELTA_SLOT,),
            global_names=self.rule.global_names, device=self.mesh.device,
            **kw)

    def init(self, from_state=None) -> LinearState:
        """This rank's replica. ``from_state`` (a collapsed LinearState or
        its numpy fields: a final_state() result or a checkpoint) seeds
        every replica, the elastic restart on whatever mesh size survives;
        missing slots (e.g. the mix delta counter) start at zero. The seed
        is remembered so final_state() counts its additive statistics once
        (strip_replica_base / add_replica_base)."""
        self._resume_base = None
        one = self._init_one()
        if from_state is None:
            return one
        host = host_linear(from_state)
        if np.asarray(host["weights"]).shape[0] != self.dims:
            raise ValueError(
                f"checkpoint has dims {np.asarray(host['weights']).shape[0]}"
                f" != trainer dims {self.dims}; resume with the dims the"
                " model was trained at")
        self._resume_base = host
        dev = self.mesh.device

        def t(a, like):
            return torch.tensor(np.asarray(a), device=dev).to(like.dtype)

        have_s = host.get("slots") or {}
        have_g = host.get("globals") or {}
        return one.replace(
            weights=t(host["weights"], one.weights),
            covars=(t(host["covars"], one.covars)
                    if one.covars is not None
                    and host.get("covars") is not None else one.covars),
            slots={k: t(have_s[k], z) if k in have_s else z
                   for k, z in one.slots.items()},
            touched=t(host["touched"], one.touched),
            step=int(host["step"]),
            globals={k: t(have_g[k], z) if k in have_g else z
                     for k, z in one.globals.items()})

    def step(self, state: LinearState, indices, values, labels):
        """One mixed step over this rank's k blocks ([k, B, ...]): each
        group of mix_every blocks trains locally, then the replicas mix.
        Returns (state, loss summed over the replicas)."""
        with TRACER.span("train.compiled_step", args={"trainer": "mix_dp"}):
            state, loss = grouped_mix_scan(
                lambda s, blk: self._local(s, *blk), self._mix, state,
                (indices, values, labels), self.config.mix_every)
            return state, sum_loss(loss, self.mesh, self.axis)

    def shard_blocks(self, indices, values, labels):
        """This rank's [k, B, ...] slice of [n_dev * k, B, ...] host
        blocks."""
        with TRACER.span("train.data_prep", args={"trainer": "mix_dp"}):
            return split_replica_blocks(self.n_dev,
                                        self.mesh.index(self.axis),
                                        indices, values, labels)

    def collapse_host(self, host: dict) -> dict:
        """Collapse gathered replicas ([n_dev, ...] numpy fields) into one
        model's numpy fields (collapse_linear_replicas); a warm-started
        run strips the seed before and restores it once after."""
        kinds = dict(self.rule.slot_merge)
        base = self._resume_base
        if base is not None:
            host = strip_replica_base(host, base, kinds)
        merged = collapse_linear_replicas(host, kinds)
        if base is not None:
            merged = add_replica_base(merged, base, kinds)
        return merged

    def final_state(self, state: LinearState) -> LinearState:
        """Gather the replicas (a collective: every rank calls it) and
        collapse them into one host model (CPU tensors) a warm restart can
        resume from."""
        with TRACER.span("train.sync", args={"trainer": "mix_dp"}):
            host = gather_linear_host(state, self.mesh, self.axis)
        return linear_state_from_numpy(self.collapse_host(host),
                                       device="cpu")
