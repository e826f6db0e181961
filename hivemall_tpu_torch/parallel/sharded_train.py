"""Feature-dimension sharded TRAINING (the port of
``hivemall_tpu/parallel/sharded_train.py``).

The reference trains against a parameter store sharded across MIX servers
by feature hash (ref: mix/client/MixRequestRouter.java:56-60), so no single
node holds the whole 2^24-dim model. Here the model is striped along the
feature dim over the ranks of a mesh axis: each rank allocates only its
[stripe] of weights / covariances / optimizer slots, and a training step is

    gather:  each rank gathers its stripe's hits (lanes it does not own are
             dead, their values 0),
    reduce:  per-row score / squared-norm / variance partials are summed
             over the axis with ONE all_reduce, so every rank knows the
             full-row scalars,
    update:  the rule's closed form runs lane-wise on every rank with the
             global scalars, and deltas scatter into the local stripe only.

The step body is the ordinary engine step built with
``make_train_fn(..., feature_shard=(mesh, axis, stripe))`` (core/engine.py).
Blocks are replicated: every rank passes the same rows.

Arbitrary dims pad up to ``stripe * n`` (core/striping.stripe_grid): data
pad lanes carry value 0, every rule's lane deltas vanish there, and the
only writes that land in a padding slot are touched / delta-count marks
that no predict or export reads (final states slice back to [:dims]).

- `ShardedTrainer`: a 1-D mesh, ONE model too big for one card.
- `Sharded2DTrainer`: (replicas x stripes): each replica holds a
  feature-sharded model and trains its own data shard; every ``mix_every``
  blocks the replicas mix along the replica axis, stripe-local (the
  reference's topology of N mapper clients against M feature-sharded MIX
  servers, MixServerHandler.java:118-158).
- `FMShardedTrainer`, `FFMShardedTrainer`, `MCShardedTrainer`: the same for
  FM, FFM and multiclass.

``final_state`` is a collective (every rank calls it): it gathers the
stripes to host memory and returns the unpadded model as CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.engine import (DELTA_SLOT, Rule, _to_device, live_lanes,
                           make_train_fn)
from ..core.state import LinearState, init_linear_state, linear_state_from_numpy
from ..core.striping import restripe, stripe_grid, stripe_of, translate_to_stripe
from ..runtime.tracing import TRACER
from .mesh import Mesh, all_gather_host, make_mesh, make_mesh_2d, psum
from .mix import (MixConfig, add_replica_base, collapse_linear_replicas,
                  grouped_mix_scan, host_linear, make_linear_mix,
                  resolve_reduction, split_replica_blocks,
                  strip_replica_base, sum_loss)
from .sharded import stripe_score

_LINEAR_STRIPED = {"weights": 0, "covars": 0, "slots": 0, "touched": 0}


def _resolve_1d_mesh(mesh: Optional[Mesh], who: str):
    """(mesh, axis_name, n): the shared 1-D scaffold."""
    mesh = mesh if mesh is not None else make_mesh()
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{who} needs a 1-D mesh, got axes {mesh.axis_names}")
    axis = mesh.axis_names[0]
    return mesh, axis, mesh.shape[axis]


def gather_stripes(t: torch.Tensor, mesh: Mesh, axis: str,
                   dims: Optional[int], feat_axis: int = 0) -> np.ndarray:
    """The whole table from every rank's stripe (``feat_axis`` holds the
    features), as host numpy, cut back to ``dims`` (None keeps the
    padding)."""
    parts = all_gather_host(t, mesh, axis)  # [n, ...]
    full = np.concatenate(list(parts), axis=feat_axis)
    if dims is None:
        return full
    sl = [slice(None)] * full.ndim
    sl[feat_axis] = slice(0, dims)
    return full[tuple(sl)]


def _align_linear_host(host: dict, dims: int, use_covariance: bool,
                       slot_names: tuple, global_names: tuple) -> dict:
    """Normalize a checkpointed host state (`linear_state_to_numpy`'s
    fields) to THIS trainer's field structure: slots / globals the rule
    expects but the checkpoint lacks start at zero (e.g. the 2-D trainer's
    mix delta counter resuming from a plain sharded checkpoint), extras
    drop, and a covariance learner resuming a covariance-free checkpoint
    starts its covariance at 1.0. Any collapsed linear checkpoint thus
    seeds any linear trainer."""
    slots = dict(host.get("slots") or {})
    covars = host.get("covars")
    if use_covariance and covars is None:
        covars = np.ones(dims, np.float32)
    elif not use_covariance:
        covars = None
    gl = host.get("globals") or {}
    return {**host, "covars": covars,
            "slots": {k: np.asarray(slots[k]) if k in slots
                      else np.zeros(dims, np.float32) for k in slot_names},
            "globals": {k: np.asarray(gl.get(k, 0.0), np.float32)
                        for k in global_names}}


def _pad_initial(arr, dims_padded: int, fill: float = 0.0) -> np.ndarray:
    """Pad a [dims] warm-start array up to the padded table size. Weights
    pad with 0, covariances with 1.0 (the argminKLD mix reads 1/cov on
    every slot, so a zero would put inf / NaN in the padding lanes)."""
    arr = np.asarray(arr)
    if arr.shape[0] == dims_padded:
        return arr
    return np.pad(arr, (0, dims_padded - arr.shape[0]), constant_values=fill)


def _place_linear(host: dict, dims: int, stripe: int, shard: int, dtype,
                  device) -> LinearState:
    """This rank's stripe of a host linear state (numpy fields)."""
    t = restripe({k: v for k, v in host.items() if k != "step"},
                 _LINEAR_STRIPED, dims, stripe, shard, device,
                 fills={"covars": 1.0})
    return LinearState(
        weights=t["weights"].float().to(dtype),
        covars=None if t["covars"] is None else t["covars"].float().to(dtype),
        slots={k: v.float() for k, v in t["slots"].items()},
        touched=t["touched"].to(torch.int8), step=int(host["step"]),
        globals={k: v.float() for k, v in t["globals"].items()})


def _host_of_stripes(state: LinearState, mesh: Mesh, axis: str,
                     dims: Optional[int]) -> dict:
    """A striped LinearState's fields gathered to host numpy."""
    def g(x):
        return gather_stripes(x, mesh, axis, dims)

    return {"weights": g(state.weights),
            "covars": None if state.covars is None else g(state.covars),
            "slots": {k: g(v) for k, v in state.slots.items()},
            "touched": g(state.touched), "step": np.int32(state.step),
            "globals": {k: v.detach().cpu().numpy()
                        for k, v in state.globals.items()}}


def _cpu_state(host: dict, dtype) -> LinearState:
    st = linear_state_from_numpy(host, device="cpu")
    return st.replace(weights=st.weights.to(dtype),
                      covars=None if st.covars is None
                      else st.covars.to(dtype))


class ShardedTrainer:
    """Train a single feature-sharded model across the ranks of a 1-D mesh.

    The state of `init()` / `step()` is this rank's padded-dims stripe, a
    LinearState of [stripe] tables. Blocks are replicated (every rank
    passes every row; the model, not the data, is what does not fit)."""

    def __init__(self, rule: Rule, hyper: dict, dims: int,
                 mesh: Optional[Mesh] = None, mode: str = "minibatch",
                 mini_batch_average: bool = True, dtype=None):
        self.rule = rule
        self.hyper = hyper
        self.dims = dims
        self.mesh, self.axis, n = _resolve_1d_mesh(mesh, "ShardedTrainer")
        self.stripe, self.dims_padded = stripe_grid(dims, n)
        self.shard = self.mesh.index(self.axis)
        # SpaceEfficientDenseModel analog, the policy of models/base.py
        # fit_linear: above the reference's default 2^24 dims, tables store
        # bf16 (ref: LearnerBaseUDTF.java:172-175)
        if dtype is None:
            dtype = torch.bfloat16 if dims > (1 << 24) else torch.float32
        self.dtype = dtype
        self._step = make_train_fn(
            rule, hyper, mode=mode, mini_batch_average=mini_batch_average,
            feature_shard=(self.mesh, self.axis, self.stripe),
            device=self.mesh.device)

    def init(self, from_state=None, **kwargs) -> LinearState:
        """This rank's stripe of the initial state. kwargs pass through to
        init_linear_state (``initial_weights`` / ``initial_covars``, [dims]
        arrays, are the -loadmodel warm start, ref:
        LearnerBaseUDTF.java:215-333). ``from_state`` (a collapsed
        LinearState or its numpy fields, e.g. a final_state() under any
        rank count) re-stripes onto THIS mesh with its optimizer state."""
        if from_state is not None:
            if kwargs:
                raise ValueError("pass either from_state or init kwargs")
            host = _align_linear_host(host_linear(from_state), self.dims,
                                      self.rule.use_covariance,
                                      tuple(self.rule.slot_names),
                                      tuple(self.rule.global_names))
            return _place_linear(host, self.dims, self.stripe, self.shard,
                                 self.dtype, self.mesh.device)
        for key, fill in (("initial_weights", 0.0), ("initial_covars", 1.0)):
            if kwargs.get(key) is not None:
                kwargs[key] = stripe_of(np.asarray(kwargs[key]), 0,
                                        self.dims, self.stripe, self.shard,
                                        fill)
        return init_linear_state(
            self.stripe, use_covariance=self.rule.use_covariance,
            slot_names=tuple(self.rule.slot_names),
            global_names=self.rule.global_names, dtype=self.dtype,
            device=self.mesh.device, **kwargs)

    def step(self, state: LinearState, indices, values, labels):
        """One sharded train step. indices/values: [B, K]; labels: [B]
        (the same on every rank). The loss is the global one on every
        rank (computed from the summed row scalars)."""
        with TRACER.span("train.compiled_step",
                         args={"trainer": "sharded_1d"}):
            return self._step(state, indices, values, labels)

    def final_state(self, state: LinearState) -> LinearState:
        """The whole model with the padding sliced back off, as CPU
        tensors (a collective)."""
        with TRACER.span("train.sync", args={"trainer": "sharded_1d"}):
            host = _host_of_stripes(state, self.mesh, self.axis, self.dims)
        return _cpu_state(host, self.dtype)

    def make_predict(self):
        """Scoring that consumes the TRAINED stripes directly, with the same
        stripe_score body as parallel/sharded.make_sharded_predict:
        ``predict(state, indices, values) -> scores [B]`` on every rank."""
        score = stripe_score(self.mesh, self.axis, self.stripe)

        def predict(state: LinearState, indices, values):
            return score(state.weights, indices, values)

        return predict


class Sharded2DTrainer:
    """Replicas x feature stripes: R data-parallel replicas, each
    feature-sharded over S ranks. Row partials are summed along the stripe
    axis; every ``config.mix_every`` blocks the replicas mix along the
    replica axis with the delta-weighted average / argminKLD, stripe-local
    (no cross-stripe traffic). ``step`` takes this replica's blocks [k, B,
    K] (`shard_blocks`), the same on every stripe of the replica.

    Cadence: an argminKLD mix SHRINKS the covariance (1/sum(1/cov)) each
    time it fires; pick mix_every on the order of tens of blocks (the
    reference gates replies at syncThreshold = 30,
    MixServerHandler.java:142-148), not 1."""

    def __init__(self, rule: Rule, hyper: dict, dims: int,
                 mesh: Optional[Mesh] = None,
                 n_replicas: Optional[int] = None,
                 n_shards: Optional[int] = None,
                 config: MixConfig = MixConfig(), mode: str = "minibatch",
                 mini_batch_average: bool = True):
        self.rule = rule
        self.hyper = hyper
        self.dims = dims
        if mesh is None:
            if n_replicas is None or n_shards is None:
                raise ValueError(
                    "pass either a 2-D mesh or both n_replicas and n_shards")
            mesh = make_mesh_2d(n_replicas, n_shards)
        if len(mesh.axis_names) != 2:
            raise ValueError(f"Sharded2DTrainer needs a 2-D mesh, got axes "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.replica_axis, self.shard_axis = mesh.axis_names
        self.n_replicas = mesh.shape[self.replica_axis]
        self.n_shards = mesh.shape[self.shard_axis]
        self.config = config
        self.stripe, self.dims_padded = stripe_grid(dims, self.n_shards)
        self.shard = mesh.index(self.shard_axis)
        self._resume_base = None  # set by init(from_state=...)
        self.reduction = resolve_reduction(config.reduction,
                                           rule.use_covariance)
        self._slot_names = tuple(rule.slot_names) + (DELTA_SLOT,)
        self._local = make_train_fn(
            rule, hyper, mode=mode, mini_batch_average=mini_batch_average,
            track_deltas=True,
            feature_shard=(mesh, self.shard_axis, self.stripe),
            device=mesh.device)
        self._mix = make_linear_mix(self.reduction, mesh, self.replica_axis)

    def init(self, from_state=None, **kwargs) -> LinearState:
        """This rank's [stripe] of its replica. ``from_state`` seeds every
        replica from a collapsed checkpoint (the elastic restart over both
        axes at once: re-striped to this mesh's grid AND re-replicated to
        its replica count); the seed is remembered so final_state() counts
        its additive statistics once."""
        self._resume_base = None
        if from_state is not None:
            if kwargs:
                raise ValueError("pass either from_state or init kwargs")
            host = _align_linear_host(
                host_linear(from_state), self.dims, self.rule.use_covariance,
                self._slot_names, tuple(self.rule.global_names))
            dp = self.dims_padded
            host = {**host,
                    "weights": _pad_initial(host["weights"], dp),
                    "covars": None if host["covars"] is None
                    else _pad_initial(host["covars"], dp, 1.0),
                    "slots": {k: _pad_initial(v, dp)
                              for k, v in host["slots"].items()},
                    "touched": _pad_initial(host["touched"], dp)}
            self._resume_base = host
            return _place_linear(host, dp, self.stripe, self.shard,
                                 torch.float32, self.mesh.device)
        for key, fill in (("initial_weights", 0.0), ("initial_covars", 1.0)):
            if kwargs.get(key) is not None:
                kwargs[key] = stripe_of(np.asarray(kwargs[key]), 0,
                                        self.dims, self.stripe, self.shard,
                                        fill)
        return init_linear_state(
            self.stripe, use_covariance=self.rule.use_covariance,
            slot_names=self._slot_names,
            global_names=self.rule.global_names, device=self.mesh.device,
            **kwargs)

    def step(self, state: LinearState, indices, values, labels):
        """This replica's k blocks ([k, B, ...]): each group of mix_every
        blocks trains locally, then the replicas mix. Returns (state, loss
        summed over the replicas)."""
        with TRACER.span("train.compiled_step",
                         args={"trainer": "sharded_2d"}):
            state, loss = grouped_mix_scan(
                lambda s, blk: self._local(s, *blk), self._mix, state,
                (indices, values, labels), self.config.mix_every)
            return state, sum_loss(loss, self.mesh, self.replica_axis)

    def shard_blocks(self, indices, values, labels):
        """This replica's [k, B, ...] slice of [R * k, B, ...] blocks."""
        with TRACER.span("train.data_prep", args={"trainer": "sharded_2d"}):
            return split_replica_blocks(
                self.n_replicas, self.mesh.index(self.replica_axis),
                indices, values, labels)

    def final_state(self, state: LinearState) -> LinearState:
        """Collapse the replica axis (collapse_linear_replicas) and slice
        the padding off: a plain [dims] model as CPU tensors (a
        collective). A warm-started run strips the seed from each replica's
        additive statistics before the merge and restores it once after."""
        mesh, ra, sa = self.mesh, self.replica_axis, self.shard_axis

        def g(x):  # [R, dims_padded]: replicas of the whole padded table
            by_rep = all_gather_host(x, mesh, ra)  # [R, stripe]
            full = all_gather_host(torch.from_numpy(by_rep).to(mesh.device),
                                   mesh, sa)  # [S, R, stripe]
            return np.concatenate(list(full), axis=1)

        with TRACER.span("train.sync", args={"trainer": "sharded_2d"}):
            host = {"weights": g(state.weights),
                    "covars": None if state.covars is None
                    else g(state.covars),
                    "slots": {k: g(v) for k, v in state.slots.items()},
                    "touched": g(state.touched),
                    "step": all_gather_host(state.step, mesh, ra)
                    .astype(np.int32),
                    "globals": {k: all_gather_host(v, mesh, ra)
                                for k, v in state.globals.items()}}
        kinds = dict(self.rule.slot_merge)
        base = self._resume_base
        if base is not None:
            host = strip_replica_base(host, base, kinds)
        merged = collapse_linear_replicas(host, kinds)
        if base is not None:
            merged = add_replica_base(merged, base, kinds)
        d = self.dims
        merged = {**merged, "weights": merged["weights"][:d],
                  "covars": None if merged["covars"] is None
                  else merged["covars"][:d],
                  "slots": {k: v[:d] for k, v in merged["slots"].items()},
                  "touched": merged["touched"][:d]}
        return _cpu_state(merged, torch.float32)

    def make_predict(self):
        """Score with this replica's trained stripes (the shared
        stripe_score body, summed over the stripe axis)."""
        score = stripe_score(self.mesh, self.shard_axis, self.stripe)

        def predict(state: LinearState, indices, values):
            return score(state.weights, indices, values)

        return predict


class FMShardedTrainer:
    """Feature-dim sharded FM: w and V stripe [D/S] / [D/S, kp] across the
    ranks like the linear ShardedTrainer; per row the three prediction
    partials are summed over the axis (models/fm.py
    sharded_gather_predict) and lane updates scatter locally. Blocks are
    replicated; arbitrary dims pad up to stripe * n."""

    def __init__(self, hyper, dims: int, mesh: Optional[Mesh] = None,
                 mode: str = "minibatch", mini_batch_average: bool = True):
        from ..models.fm import FMHyper, make_fm_step

        if not isinstance(hyper, FMHyper):
            raise TypeError("FMShardedTrainer takes an FMHyper")
        self.hyper = hyper
        self.dims = dims
        self.mesh, self.axis, n = _resolve_1d_mesh(mesh, "FMShardedTrainer")
        self.stripe, self.dims_padded = stripe_grid(dims, n)
        self.shard = self.mesh.index(self.axis)
        self._step = make_fm_step(
            hyper, mode, mini_batch_average=mini_batch_average,
            feature_shard=(self.mesh, self.axis, self.stripe),
            device=self.mesh.device)

    def init(self, from_state=None):
        """Default: the JAX package's fresh draw at the padded shape (V =
        normal(PRNGKey(seed), (dims_padded, k)) * sigma, drawn whole on the
        host), this rank's stripe of it. ``from_state`` (a collapsed
        FMState or its numpy fields) re-stripes onto THIS mesh: w / V /
        touched along the feature axis (pad rows are never gathered, so a
        zero fill is exact), scalars replicated."""
        from ..models.fm import (FMState, fm_state_to_numpy, init_fm_state)

        if from_state is None:
            host = fm_state_to_numpy(init_fm_state(self.dims_padded,
                                                   self.hyper, device="cpu"))
        else:
            host = fm_state_to_numpy(from_state) \
                if isinstance(from_state, FMState) else from_state
        t = restripe({k: v for k, v in host.items() if k != "step"},
                     {"w": 0, "v": 0, "touched": 0}, self.dims, self.stripe,
                     self.shard, self.mesh.device)
        return FMState(w0=t["w0"].float(), w=t["w"].float(),
                       v=t["v"].float(), lambda_w0=t["lambda_w0"].float(),
                       lambda_w=t["lambda_w"].float(),
                       lambda_v=t["lambda_v"].float(),
                       touched=t["touched"].to(torch.int8),
                       step=int(host["step"]))

    def step(self, state, indices, values, labels, va=None):
        """indices/values: [B, K]; labels: [B] (the same on every rank)."""
        if va is None:
            va = np.zeros(np.shape(labels), np.float32)
        with TRACER.span("train.compiled_step",
                         args={"trainer": "fm_sharded"}):
            return self._step(state, indices, values, labels, va)

    def final_state(self, state):
        """The whole model with the padding sliced off, as CPU tensors (a
        collective)."""
        from ..models.fm import fm_state_from_numpy

        with TRACER.span("train.sync", args={"trainer": "fm_sharded"}):
            host = {k: gather_stripes(getattr(state, k), self.mesh,
                                      self.axis, self.dims)
                    for k in ("w", "v", "touched")}
        host.update({k: getattr(state, k).detach().cpu().numpy()
                     for k in ("w0", "lambda_w0", "lambda_w", "lambda_v")},
                    step=state.step)
        return fm_state_from_numpy(host, device="cpu")

    def make_predict(self):
        """Scores from the trained stripes through the SAME
        sharded_gather_predict body the train step uses."""
        from ..models.fm import sharded_gather_predict

        def predict(state, indices, values):
            dev = state.w.device
            return sharded_gather_predict(
                state.w, state.v, state.w0,
                _to_device(indices, torch.int64, dev),
                _to_device(values, torch.float32, dev), self.mesh,
                self.axis, self.stripe)[4]

        return predict


class FFMShardedTrainer:
    """Feature-dim sharded FFM: the linear tables ([num_features]) and the
    hashed pairwise V tables ([v_dims, k] + gg) stripe across the ranks
    with independent stripe sizes. A row's [K, K, k] pair block is rebuilt
    on every rank with one all_reduce of the owner-gathered entries
    (models/ffm.py sharded_ffm_gather), updates scatter back owned entries
    only, and keys hash with the ORIGINAL v_dims, so the sharded model
    computes the same function as the unsharded one. Composes with
    ``row_chunk`` (one all_reduce a chunk). Blocks are replicated."""

    def __init__(self, hyper, mesh: Optional[Mesh] = None,
                 mode: str = "minibatch", row_chunk: Optional[int] = None):
        from ..models.ffm import FFMHyper, make_ffm_step

        if not isinstance(hyper, FFMHyper):
            raise TypeError("FFMShardedTrainer takes an FFMHyper")
        self.hyper = hyper
        self.mesh, self.axis, n = _resolve_1d_mesh(mesh, "FFMShardedTrainer")
        self.shard = self.mesh.index(self.axis)
        self.stripe_w, self.nf_padded = stripe_grid(hyper.num_features, n)
        self.stripe_v, self.dv_padded = stripe_grid(hyper.v_dims, n)
        self._step = make_ffm_step(
            hyper, mode, row_chunk=row_chunk,
            feature_shard=(self.mesh, self.axis, self.stripe_w,
                           self.stripe_v),
            device=self.mesh.device)

    def init(self, from_state=None):
        """Default: V ~ normal(PRNGKey(seed), (v_dims padded, k)) * sigma,
        the JAX trainer's draw at the padded shape, zero linear tables;
        ``from_state`` (an unsharded FFMState or its numpy fields) seeds it
        instead. This rank's stripes of either."""
        from ..models.ffm import FFMState, ffm_state_to_numpy

        h = self.hyper
        if from_state is None:
            from ..utils.jax_prng import normal

            nf, dv = h.num_features, h.v_dims
            host = {"w0": np.float32(0.0), "w": np.zeros(nf, np.float32),
                    "z": np.zeros(nf, np.float32),
                    "n": np.zeros(nf, np.float32),
                    "v": normal(h.seed, (self.dv_padded, h.factors))
                    * np.float32(h.sigma),
                    "v_gg": np.zeros(dv, np.float32),
                    "touched": np.zeros(nf, np.int8), "step": 0}
        else:
            host = ffm_state_to_numpy(from_state) \
                if isinstance(from_state, FFMState) else from_state
        dev = self.mesh.device
        tw = restripe({k: host[k] for k in ("w", "z", "n", "touched")},
                      {"w": 0, "z": 0, "n": 0, "touched": 0},
                      h.num_features, self.stripe_w, self.shard, dev)
        tv = restripe({k: host[k] for k in ("v", "v_gg")},
                      {"v": 0, "v_gg": 0}, h.v_dims, self.stripe_v,
                      self.shard, dev)
        return FFMState(
            w0=torch.tensor(np.float32(host["w0"]), device=dev),
            w=tw["w"].float(), z=tw["z"].float(), n=tw["n"].float(),
            v=tv["v"].float(), v_gg=tv["v_gg"].float(),
            touched=tw["touched"].to(torch.int8), step=int(host["step"]))

    def step(self, state, indices, values, fields, labels):
        """indices/values/fields: [B, K]; labels: [B] (the same on every
        rank)."""
        with TRACER.span("train.compiled_step",
                         args={"trainer": "ffm_sharded"}):
            return self._step(state, indices, values, fields, labels)

    def make_predict(self):
        """Scores from the trained stripes through the SAME
        sharded_ffm_gather body the train step uses (the full V table is
        never materialised)."""
        from ..models.ffm import sharded_ffm_gather

        def predict(state, indices, values, fields):
            dev = state.w.device
            return sharded_ffm_gather(
                state, _to_device(indices, torch.int64, dev),
                _to_device(values, torch.float32, dev),
                _to_device(fields, torch.int64, dev), self.hyper,
                self.mesh, self.axis, self.stripe_w, self.stripe_v)[0]

        return predict

    def final_state(self, state):
        """The whole model with both paddings sliced off (linear tables at
        num_features, V at v_dims), as CPU tensors (a collective)."""
        from ..models.ffm import ffm_state_from_numpy

        nf, dv = self.hyper.num_features, self.hyper.v_dims
        with TRACER.span("train.sync", args={"trainer": "ffm_sharded"}):
            host = {k: gather_stripes(getattr(state, k), self.mesh,
                                      self.axis, nf)
                    for k in ("w", "z", "n", "touched")}
            host.update({k: gather_stripes(getattr(state, k), self.mesh,
                                           self.axis, dv)
                         for k in ("v", "v_gg")})
        host.update(w0=state.w0.detach().cpu().numpy(), step=state.step)
        return ffm_state_from_numpy(host, device="cpu")


class MCShardedTrainer:
    """Feature-dim sharded multiclass: the stacked [L, D] weight (and
    covariance) tensor stripes along the feature dim, [L, D/S] a rank. Per
    row the per-label score / variance partials are summed over the axis
    (models/multiclass.py make_mc_train_step feature_shard), the margin and
    closed-form alpha / beta come from the global scalars, and the correct
    / missed rows' updates scatter into the local stripe. Blocks are
    replicated; arbitrary dims pad up."""

    def __init__(self, rule, hyper: dict, num_labels: int, dims: int,
                 mesh: Optional[Mesh] = None, mode: str = "minibatch"):
        from ..models.multiclass import MCRule, make_mc_train_step

        if not isinstance(rule, MCRule):
            raise TypeError("MCShardedTrainer takes an MCRule")
        self.rule = rule
        self.num_labels = num_labels
        self.dims = dims
        self.mesh, self.axis, n = _resolve_1d_mesh(mesh, "MCShardedTrainer")
        self.stripe, self.dims_padded = stripe_grid(dims, n)
        self.shard = self.mesh.index(self.axis)
        self._step = make_mc_train_step(
            rule, hyper, mode,
            feature_shard=(self.mesh, self.axis, self.stripe),
            device=self.mesh.device)

    def init(self):
        from ..models.multiclass import init_mc_state

        return init_mc_state(self.num_labels, self.stripe,
                             self.rule.use_covariance,
                             device=self.mesh.device)

    def step(self, state, indices, values, labels):
        """indices/values: [B, K]; labels: [B] label indices (the same on
        every rank)."""
        with TRACER.span("train.compiled_step",
                         args={"trainer": "mc_sharded"}):
            return self._step(state, indices, values, labels)

    def final_state(self, state):
        """The whole [L, dims] model, as CPU tensors (a collective)."""
        from ..models.multiclass import mc_state_from_numpy

        def g(x):
            return gather_stripes(x, self.mesh, self.axis, self.dims,
                                  feat_axis=1)

        with TRACER.span("train.sync", args={"trainer": "mc_sharded"}):
            host = {"weights": g(state.weights),
                    "covars": None if state.covars is None
                    else g(state.covars),
                    "touched": g(state.touched), "step": state.step}
        return mc_state_from_numpy(host, device="cpu")

    def make_predict(self):
        """Per-label scores [B, L] from the stripes: local [L, B, K] gather
        and one all_reduce over the axis."""
        from ..models.multiclass import _lane_sum, _take2

        def predict(state, indices, values):
            dev = state.weights.device
            lidx, vmask = translate_to_stripe(
                _to_device(indices, torch.int64, dev),
                _to_device(values, torch.float32, dev), self.shard,
                self.stripe)
            live, sidx = live_lanes(lidx, self.stripe)
            return psum(_lane_sum(_take2(state.weights, sidx, live, 0.0),
                                  vmask), self.mesh, self.axis)

        return predict
