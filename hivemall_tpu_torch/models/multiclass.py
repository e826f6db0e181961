"""Multiclass online classifiers: train_multiclass_{perceptron, pa, pa1, pa2,
cw, arow, arowh, scw, scw2} — the port of `hivemall_tpu/models/multiclass.py`.

The reference keeps a lazily-grown per-label model map
(`Map<Object, PredictionModel> label2model`,
ref: classifier/multiclass/MulticlassOnlineClassifierUDTF.java:70-110); the
JAX package stacks it into ONE weight tensor [num_labels, dims], and so does
the port: scoring every label is an [L, K] gather and a lane sum, and the
correct/missed row updates are two scatter-adds into the same tensor.

Semantics note (the JAX package's): the "max another" margin runs over the
full fixed label vocabulary (unseen rows score 0 from zero weights),
identical to the reference once every label has occurred.

Update rules (file:line of the reference in the JAX package's copy):
- perceptron: misclassify -> +x to actual, -x to predicted
  (ref: MulticlassPerceptronUDTF.java:50-57)
- PA: loss = 1 - margin, eta = loss/(2|x|^2); PA1 clips at C; PA2
  eta = loss/(2|x|^2 + 1/2C) (ref: MulticlassPassiveAggressiveUDTF.java:51-123)
- CW: gamma from margin + variance(correct) + variance(missed), covariance
  1/(1/cov + 2*alpha*phi*x^2) on both rows
  (ref: MulticlassConfidenceWeightedUDTF.java:112-192)
- AROW: alpha = (1-m)*beta, beta = 1/(var + r); AROWh: alpha = (c-m)*beta when
  c-m > 0; covariance cov - beta*(cov*x)^2 on both rows
  (ref: MulticlassAROWClassifierUDTF.java:99-234)
- SCW1/SCW2: binary SCW closed forms with m := margin, var := var_correct +
  var_missed (ref: MulticlassSoftConfidenceWeightedUDTF.java)

The JAX step is plain XLA (a `lax.scan` of rows, or a `vmap` over the block
and four scatters), so the port's is plain torch on the device. A row's
math is written once, over a leading batch axis: the minibatch step runs
it on the whole block against the block-start tables, and the exact scan
runs it on one-row slices in order, which is what the JAX scan body does
row by row. Padding follows the port's protocol: a lane is live when
``0 <= idx < dims``; the weight gather fills dead lanes with 0.0 and the
covariance gather with 1.0 (JAX's ``mode="fill"``), and the scatter-adds
send them to flat slot 0 with value -0.0, which changes nothing (JAX's
``mode="drop"``).

`step` is a host int. Steps update the state's tensors in place and
return it: treat the state passed in as consumed (the JAX steps donate
it).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import DEFAULT_NUM_FEATURES
from ..core.batch import iter_blocks, pad_to_bucket
from ..core.engine import _to_device, live_lanes
from ..core.state import _numpy
from ..core.striping import translate_to_stripe
from ..device import DeviceLike, resolve_device
from ..core.collectives import psum
from ..utils.options import Options
from .base import FeatureRows, _stage_rows, base_options
from .classifier import _resolve_phi, _safe_div

NEG_INF = -3.0e38


@dataclass
class MulticlassState:
    weights: torch.Tensor  # [L, D]
    covars: Optional[torch.Tensor]  # [L, D] init 1.0
    touched: torch.Tensor  # [L, D] int8
    step: int  # processed-example counter
    # optimizer accumulators ([L, D] each), merged across replicas per
    # MCRule.slot_merge (parallel/mc_mix.py); no current rule fills them
    slots: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def num_labels(self) -> int:
        return self.weights.shape[0]

    @property
    def dims(self) -> int:
        return self.weights.shape[1]

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def replace(self, **changes) -> "MulticlassState":
        return dataclasses.replace(self, **changes)


def init_mc_state(num_labels: int, dims: int, use_covariance: bool,
                  device: DeviceLike = None) -> MulticlassState:
    """A fresh model on ``device``: zero weights, unit covariances (for the
    covariance rules), nothing touched."""
    dev = resolve_device(device)
    shape = (num_labels, dims)
    return MulticlassState(
        weights=torch.zeros(shape, dtype=torch.float32, device=dev),
        covars=torch.ones(shape, dtype=torch.float32, device=dev)
        if use_covariance else None,
        touched=torch.zeros(shape, dtype=torch.int8, device=dev),
        step=0)


def mc_state_from_numpy(d: dict, device: DeviceLike = None) -> MulticlassState:
    """Build a state from the JAX MulticlassState's fields as numpy arrays
    (``weights``, ``covars`` or None, ``touched``, ``step``). Every tensor
    is a fresh copy."""
    dev = resolve_device(device)

    def t(x, dt):
        return torch.tensor(np.asarray(x), dtype=dt, device=dev)

    return MulticlassState(
        weights=t(d["weights"], torch.float32),
        covars=None if d.get("covars") is None
        else t(d["covars"], torch.float32),
        touched=t(d["touched"], torch.int8),
        step=int(d.get("step", 0)))


def mc_state_to_numpy(state: MulticlassState) -> dict:
    """The inverse of `mc_state_from_numpy`: numpy copies of every field,
    ``step`` as np.int32 (the JAX state's type)."""
    return {
        "weights": _numpy(state.weights),
        "covars": None if state.covars is None else _numpy(state.covars),
        "touched": _numpy(state.touched),
        "step": np.int32(state.step),
    }


@dataclass(frozen=True)
class MCRule:
    """alpha/beta from (margin m, variance, sq_norm); cov_kind selects the
    covariance update shape ('none' | 'arow' | 'cw')."""

    name: str
    compute: Callable  # (m, var, sq_norm, hyper) -> (alpha, beta, loss, updated)
    cov_kind: str = "none"
    # (slot_name, "sum"|"mean") merge kinds for a distributed final_state,
    # the contract of core.engine.Rule.slot_merge; empty for every current
    # rule (no multiclass rule carries accumulator slots)
    slot_merge: Tuple[Tuple[str, str], ...] = ()

    @property
    def use_covariance(self) -> bool:
        return self.cov_kind != "none"


def _perceptron_compute(m, var, sq_norm, hyper):
    updated = m <= 0.0  # predicted (max other) >= correct
    one = torch.where(updated, 1.0, 0.0)
    return one, torch.zeros_like(m), one, updated


def _pa_compute_factory(variant: str):
    def compute(m, var, sq_norm, hyper):
        loss = 1.0 - m
        if variant == "pa":
            eta = _safe_div(loss, 2.0 * sq_norm)
        elif variant == "pa1":
            eta = torch.clamp(_safe_div(loss, 2.0 * sq_norm), max=hyper["c"])
        else:
            eta = loss / (2.0 * sq_norm + 0.5 / hyper["c"])
        updated = (loss > 0.0) & (sq_norm > 0.0)
        return (torch.where(updated, eta, 0.0), torch.zeros_like(m),
                torch.clamp(loss, min=0.0), updated)

    return compute


def _cw_compute(m, var, sq_norm, hyper):
    phi = hyper["phi"]
    b = 1.0 + 2.0 * phi * m
    disc = torch.clamp(b * b - 8.0 * phi * (m - phi * var), min=0.0)
    gamma = _safe_div(-b + torch.sqrt(disc), 4.0 * phi * var)
    updated = gamma > 0.0
    alpha = torch.where(updated, gamma, 0.0)
    return alpha, alpha * phi, torch.where(m <= 0.0, 1.0, 0.0), updated


def _arow_compute_factory(hinge: bool):
    def compute(m, var, sq_norm, hyper):
        beta = 1.0 / (var + hyper["r"])
        loss = (hyper["c"] - m) if hinge else (1.0 - m)
        updated = loss > 0.0
        alpha = torch.where(updated, loss * beta, 0.0)
        beta = torch.where(updated, beta, 0.0)
        return alpha, beta, torch.clamp(loss, min=0.0), updated

    return compute


def _scw_compute_factory(variant: int):
    def compute(m, var, sq_norm, hyper):
        phi, c = hyper["phi"], hyper["c"]
        loss = torch.clamp(phi * torch.sqrt(torch.clamp(var, min=0.0)) - m,
                           min=0.0)
        sq_phi = phi * phi
        if variant == 1:
            psi = 1.0 + sq_phi / 2.0
            zeta = 1.0 + sq_phi
            numer = -m * psi + torch.sqrt(torch.clamp(
                m * m * sq_phi * sq_phi / 4.0 + var * sq_phi * zeta,
                min=0.0))
            alpha = _safe_div(numer, var * zeta)
            # mirrors the reference's max()
            alpha = torch.where(alpha <= 0.0, 0.0,
                                torch.clamp(alpha, min=c))
        else:
            n = var + c / 2.0
            vpp = var * sq_phi
            vppm = vpp * m
            term = vppm * m * var + 4.0 * n * var * (n + vpp)
            gamma = phi * torch.sqrt(torch.clamp(term, min=0.0))
            numer = -(2.0 * m * n + vppm) + gamma
            alpha = torch.where(numer <= 0.0, 0.0,
                                _safe_div(numer, 2.0 * (n * n + n * vpp)))
        beta_numer = alpha * phi
        vap = var * beta_numer
        u = -vap + torch.sqrt(torch.clamp(vap * vap + 4.0 * var, min=0.0))
        beta = _safe_div(beta_numer, u / 2.0 + vap)
        updated = (loss > 0.0) & (alpha != 0.0) & (beta != 0.0)
        return (torch.where(updated, alpha, 0.0),
                torch.where(updated, beta, 0.0), loss, updated)

    return compute


MC_PERCEPTRON = MCRule("mc_perceptron", _perceptron_compute)
MC_PA = MCRule("mc_pa", _pa_compute_factory("pa"))
MC_PA1 = MCRule("mc_pa1", _pa_compute_factory("pa1"))
MC_PA2 = MCRule("mc_pa2", _pa_compute_factory("pa2"))
MC_CW = MCRule("mc_cw", _cw_compute, cov_kind="cw")
MC_AROW = MCRule("mc_arow", _arow_compute_factory(False), cov_kind="arow")
MC_AROWH = MCRule("mc_arowh", _arow_compute_factory(True), cov_kind="arow")
MC_SCW1 = MCRule("mc_scw1", _scw_compute_factory(1), cov_kind="arow")
MC_SCW2 = MCRule("mc_scw2", _scw_compute_factory(2), cov_kind="arow")


def _take2(table: torch.Tensor, sidx: torch.Tensor, live: torch.Tensor,
           fill: float) -> torch.Tensor:
    """[L, D] gathered at [B, K] lanes -> float32 [L, B, K]; dead lanes
    ``fill`` (JAX's take(axis=1, mode="fill"))."""
    return torch.where(live, table[:, sidx].float(),
                       torch.full((), fill, dtype=torch.float32,
                                  device=table.device))


def _lane_sum(table_rows: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """[L, B, K] x [B, K] -> [B, L]: each label's lane sum of one row, as an
    elementwise product and sum (no matmul, so no TF32 on the card)."""
    return torch.sum(table_rows * val, dim=-1).transpose(0, 1)


def _pick(rows: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """rows [L, B, K] at each row's label [B] -> [B, K]."""
    b = torch.arange(rows.shape[1], device=rows.device)
    return rows[label, b]


def _margin_from_scores(scores, variances, COV, label, use_cov):
    """Margin / missed label / variance / cov rows from per-label scores
    [B, L]: the JAX package's `_margin_from_scores`, over a batch. The
    missed label is the first index of the largest other score (argmax
    takes the first maximal index on both devices, as jnp.argmax does)."""
    b, L = scores.shape
    rows = torch.arange(b, device=scores.device)
    correct = scores[rows, label]
    if L == 1:
        # No other label yet: the reference scores "max another" as 0 with
        # a null missed label and only updates the correct row
        # (ref: MulticlassOnlineClassifierUDTF.getMargin:211-229 null branch)
        missed = label
        m = correct
    else:
        # a scalar scatter, not an index_put_ of a Python float (whose CPU
        # copy a CUDA graph capture refuses)
        others = scores.scatter(1, label[:, None], NEG_INF)
        missed = torch.argmax(others, dim=1)
        m = correct - others[rows, missed]
    if use_cov:
        var = variances[rows, label] + torch.where(
            missed == label, 0.0, variances[rows, missed])
        cov_a, cov_m = _pick(COV, label), _pick(COV, missed)
    else:
        var = torch.zeros_like(m)
        cov_a = cov_m = None
    return m, var, missed, cov_a, cov_m


def _cov_delta(kind, cov, val, alpha, beta):
    """Per-lane covariance delta; alpha/beta are row scalars [B]."""
    if kind == "arow":
        cv = cov * val
        return -beta[:, None] * cv * cv
    # cw: new = cov / (1 + 2*beta_term*x^2*cov) with beta_term = alpha*phi
    denom = 1.0 + 2.0 * beta[:, None] * val * val * cov
    return cov / denom - cov


def make_mc_train_step(rule: MCRule, hyper: dict, mode: str = "scan",
                       feature_shard=None, device: DeviceLike = None):
    """Build ``step(state, indices, values, labels) -> (state, loss_sum)``.
    ``mode="scan"`` replays rows sequentially (reference-exact);
    ``"minibatch"`` reads every row against the block-start tables, then
    scatter-adds the correct and missed rows' deltas. ``labels`` are label
    indices into the state's [L, D] rows.

    ``feature_shard=(mesh, axis, stripe)`` runs the same step on this
    rank's [L, stripe] slice of the tables (parallel/sharded_train.py
    MCShardedTrainer): ids translate to the stripe, the per-label score
    (and variance) partials of each row are summed over the axis in one
    all_reduce, sq_norm comes from the whole row's values, and the
    correct / missed rows' updates scatter into the local stripe only."""
    if mode not in ("scan", "minibatch"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    use_cov = rule.use_covariance

    def inputs(indices, values, labels):
        return (_to_device(indices, torch.int64, dev),
                _to_device(values, torch.float32, dev),
                _to_device(labels, torch.int64, dev))

    def apply_rows(st: MulticlassState, idx, val, label, scan_touch: bool):
        """One batch of rows against ``st``: gather, closed form, then the
        scatter-adds into ``st``'s tables (in place). Returns the loss
        sum. ``scan_touch`` marks the missed row where the rule fired and
        missed != label (the JAX scan body); otherwise where it fired (the
        JAX minibatch step) — the same entries, since a missed row equal
        to the label row is marked already."""
        L, d = st.weights.shape
        # sq_norm from the whole row's values: a global row scalar
        sq_norm = torch.sum(val * val, dim=-1)
        if feature_shard is not None:
            mesh, axis, stripe = feature_shard
            idx, val = translate_to_stripe(idx, val, mesh.index(axis),
                                           stripe)
        live, sidx = live_lanes(idx, d)
        W = _take2(st.weights, sidx, live, 0.0)  # [L, B, K]
        scores = _lane_sum(W, val)  # [B, L]
        COV = variances = None
        if use_cov:
            COV = _take2(st.covars, sidx, live, 1.0)
            variances = _lane_sum(COV, val * val)
        if feature_shard is not None:
            parts = psum(scores if variances is None
                         else torch.cat([scores, variances], dim=1),
                         mesh, axis)
            scores = parts[:, :L]
            if use_cov:
                variances = parts[:, L:]
        m, var, missed, cov_a, cov_m = _margin_from_scores(
            scores, variances, COV, label, use_cov)
        alpha, beta, loss, updated = rule.compute(m, var, sq_norm, hyper)
        upd = updated.to(val.dtype)[:, None]
        has_miss = torch.where(missed == label, 0.0, 1.0)[:, None]
        a1 = alpha[:, None]
        if use_cov:
            dwa = upd * a1 * cov_a * val
            dwm = -upd * has_miss * a1 * cov_m * val
        else:  # the JAX step's unit cov rows
            dwa = upd * a1 * val
            dwm = -upd * has_miss * a1 * val
        # flat slots label * D + idx; dead lanes -> slot 0 with -0.0
        zero = torch.zeros_like(sidx)
        fa = torch.where(live, label[:, None] * d + sidx, zero).reshape(-1)
        fm = torch.where(live, missed[:, None] * d + sidx, zero).reshape(-1)

        def add(table, flat, delta):
            table.view(-1).index_add_(
                0, flat, torch.where(live, delta, -0.0).reshape(-1)
                .to(table.dtype))

        add(st.weights, fa, dwa)
        add(st.weights, fm, dwm)
        if use_cov:
            add(st.covars, fa, upd * _cov_delta(rule.cov_kind, cov_a, val,
                                                alpha, beta))
            add(st.covars, fm, upd * has_miss * _cov_delta(
                rule.cov_kind, cov_m, val, alpha, beta))
        miss_mark = (updated & (missed != label)) if scan_touch else updated
        # the int8 .at[].max of 0/1 marks as one amax scatter; dead lanes
        # and unmarked rows send a 0 (to slot 0 for dead lanes), which
        # leaves every entry as it is
        marks = torch.cat([(live & updated[:, None]).reshape(-1),
                           (live & miss_mark[:, None]).reshape(-1)])
        st.touched.view(-1).scatter_reduce_(
            0, torch.cat([fa, fm]), marks.to(torch.int8), reduce="amax")
        return torch.sum(loss)

    def scan_step(state: MulticlassState, indices, values, labels):
        indices, values, labels = inputs(indices, values, labels)
        b = indices.shape[0]
        losses = [apply_rows(state, indices[r:r + 1], values[r:r + 1],
                             labels[r:r + 1], True) for r in range(b)]
        loss = torch.stack(losses).sum() if losses \
            else torch.zeros((), device=dev)
        return state.replace(step=state.step + b), loss

    def minibatch_step(state: MulticlassState, indices, values, labels):
        indices, values, labels = inputs(indices, values, labels)
        loss = apply_rows(state, indices, values, labels, False)
        return state.replace(step=state.step + indices.shape[0]), loss

    return scan_step if mode == "scan" else minibatch_step


def _mc_scores(weights: torch.Tensor, indices, values) -> torch.Tensor:
    """Scores [B, L] of a padded block on the table's device: the one
    scorer of TrainedMulticlassModel and the f32/bf16 multiclass servable.
    A bf16 table's gathered [L, B, K] window widens to f32 before the
    product (jnp.einsum's promotion); the table itself never does."""
    dev = weights.device
    indices = _to_device(indices, torch.int64, dev)
    values = _to_device(values, torch.float32, dev)
    live, sidx = live_lanes(indices, weights.shape[1])
    return _lane_sum(_take2(weights, sidx, live, 0.0), values)


@dataclass
class TrainedMulticlassModel:
    state: MulticlassState
    label_vocab: List
    dims: int

    def scores(self, features: FeatureRows) -> np.ndarray:
        """Per-label scores [n, L] on the state's device, in blocks of
        1024 rows; numpy results."""
        idx_rows, val_rows = _stage_rows(features, self.dims)
        n = len(idx_rows)
        width = pad_to_bucket(max((len(r) for r in idx_rows), default=1))
        out = [_mc_scores(self.state.weights, blk.indices, blk.values)
               for blk in iter_blocks(idx_rows, val_rows, np.zeros(n),
                                      self.dims, 1024, width)]
        if not out:
            return np.zeros((0, self.state.num_labels), np.float32)
        return torch.cat(out).cpu().numpy()[:n]

    def predict(self, features: FeatureRows) -> List:
        s = self.scores(features)
        return [self.label_vocab[i] for i in np.argmax(s, axis=1)]

    def model_rows(self):
        """(label, feature, weight[, covar]) rows over touched entries —
        the reference's per-label close() emission."""
        t = _numpy(self.state.touched) != 0
        lab_i, feat_i = np.nonzero(t)
        labels = [self.label_vocab[i] for i in lab_i]
        weights = _numpy(self.state.weights)[lab_i, feat_i]
        if self.state.covars is not None:
            return (labels, feat_i, weights,
                    _numpy(self.state.covars)[lab_i, feat_i])
        return labels, feat_i, weights


def _fit_multiclass(rule: MCRule, hyper: dict, cl, features: FeatureRows,
                    labels: Sequence, num_classes: Optional[int] = None,
                    device: DeviceLike = None) -> TrainedMulticlassModel:
    dev = resolve_device(device)
    dims = cl.get_int("dims") or DEFAULT_NUM_FEATURES
    mini_batch = cl.get_int("mini_batch", 1)
    iters = cl.get_int("iters", 1)
    vocab = sorted(set(labels), key=lambda x: str(x))
    if num_classes is not None and num_classes > len(vocab):
        vocab = vocab + [f"__unused_{i}"
                         for i in range(num_classes - len(vocab))]
    lab2i = {l: i for i, l in enumerate(vocab)}
    y = np.array([lab2i[l] for l in labels], dtype=np.int32)
    idx_rows, val_rows = _stage_rows(features, dims)
    width = pad_to_bucket(max((len(r) for r in idx_rows), default=1))
    state = init_mc_state(len(vocab), dims, rule.use_covariance, device=dev)
    mode = "minibatch" if mini_batch > 1 else "scan"
    block = mini_batch if mode == "minibatch" else cl.get_int("block_size",
                                                               4096)
    step = make_mc_train_step(rule, hyper, mode, device=dev)
    for _ in range(max(1, iters)):
        for blk in iter_blocks(idx_rows, val_rows, y, dims, block, width):
            state, _ = step(state, blk.indices, blk.values,
                            blk.labels.astype(np.int32))
    return TrainedMulticlassModel(state=state, label_vocab=vocab, dims=dims)


def _mc_opts(phi: bool = False, c: bool = False, r: bool = False) -> Options:
    o = base_options()
    if phi:
        o.add("phi", "confidence", True, "Confidence parameter [default 1.0]",
              type=float)
        o.add("eta", "hyper_c", True, "Confidence hyperparameter in (0.5, 1]",
              type=float)
    if c:
        o.add("c", "aggressiveness", True,
              "Aggressiveness parameter C [default 1.0]", default=1.0,
              type=float)
    if r:
        o.add("r", "regularization", True,
              "Regularization parameter r [default 0.1]", default=0.1,
              type=float)
    return o


def _make_train(name, rule, opts_kw, hyper_fn):
    def train(features: FeatureRows, labels, options: Optional[str] = None,
              num_classes: Optional[int] = None,
              device: DeviceLike = None) -> TrainedMulticlassModel:
        """Train on the CUDA device (``device="cpu"`` asks for the CPU);
        ``-mini_batch B`` > 1 is the stale-weight minibatch, the default
        the exact per-row scan."""
        cl = _mc_opts(**opts_kw).parse(options, name)
        return _fit_multiclass(rule, hyper_fn(cl), cl, features, labels,
                               num_classes, device=device)

    train.__name__ = name
    return train


train_multiclass_perceptron = _make_train(
    "train_multiclass_perceptron", MC_PERCEPTRON, {}, lambda cl: {})
train_multiclass_pa = _make_train(
    "train_multiclass_pa", MC_PA, {}, lambda cl: {})
train_multiclass_pa1 = _make_train(
    "train_multiclass_pa1", MC_PA1, {"c": True},
    lambda cl: {"c": cl.get_float("c", 1.0)})
train_multiclass_pa2 = _make_train(
    "train_multiclass_pa2", MC_PA2, {"c": True},
    lambda cl: {"c": cl.get_float("c", 1.0)})
train_multiclass_cw = _make_train(
    "train_multiclass_cw", MC_CW, {"phi": True},
    lambda cl: {"phi": _resolve_phi(cl)})
train_multiclass_arow = _make_train(
    "train_multiclass_arow", MC_AROW, {"r": True},
    lambda cl: {"r": cl.get_float("r", 0.1)})
train_multiclass_arowh = _make_train(
    "train_multiclass_arowh", MC_AROWH, {"r": True, "c": True},
    lambda cl: {"r": cl.get_float("r", 0.1), "c": cl.get_float("c", 1.0)})
train_multiclass_scw = _make_train(
    "train_multiclass_scw", MC_SCW1, {"phi": True, "c": True},
    lambda cl: {"phi": _resolve_phi(cl), "c": cl.get_float("c", 1.0)})
train_multiclass_scw2 = _make_train(
    "train_multiclass_scw2", MC_SCW2, {"phi": True, "c": True},
    lambda cl: {"phi": _resolve_phi(cl), "c": cl.get_float("c", 1.0)})
