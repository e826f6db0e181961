"""Factorization Machines: train_fm / fm_predict — the port of
`hivemall_tpu/models/fm.py`.

Mirrors the reference FM subsystem (ref: fm/FactorizationMachineUDTF.java:115-560,
fm/FactorizationMachineModel.java:118-300, fm/FMHyperParameters.java:30-110):

- prediction  p = w0 + sum_i w_i x_i + 1/2 sum_f [(sum_i V_if x_i)^2 - sum_i V_if^2 x_i^2]
- dloss: classification (sigmoid(p*y) - 1)*y with y in {-1,1}; regression
  p clamped to [min_target, max_target], p - y
- SGD updates with per-group L2: w0 -= eta*(g + 2*lambda_w0*w0),
  wi -= eta*(g*xi + 2*lambda_w*wi),
  Vif -= eta*(g*(xi*sumVfX_f - Vif*xi^2) + 2*lambda_Vf*Vif)
- adaptive regularization (-adareg): a validation fraction of rows updates
  the lambdas instead of theta (ref: FactorizationMachineModel.java:253-300)
- multi-epoch: the staged blocks re-run, with the ConversionState early exit.

The JAX step is plain XLA (no Pallas kernel), so the port's step is plain
torch ops on the card: V is one [D, kp] table, a block's factor rows are
one [B, K, kp] gather, and the updates are one `index_add_` of rows
(ops/scatter.scatter_rows_flat). Padding follows the port's protocol
(core/engine.py): a lane is live when ``0 <= idx < D``; gathers mask dead
lanes to 0, and scatters send them to row 0 with value -0.0, which adds
nothing.

**Initial V is the JAX package's.** JAX draws V from
``jax.random.normal(PRNGKey(seed), (dims, k)) * sigma``; the port draws the
same numbers on the host with its numpy copy of that stream
(utils/jax_prng.py, equal to JAX's) and copies them to the device, so a
port `train_fm` and a JAX one with the same ``-seed`` start from the same
V. `fm_state_from_numpy` / `fm_state_to_numpy` carry any other state
across.

`step` is a host int (as in core/state.LinearState). Steps update the
state's tensors in place where that saves a copy and return the new
state: treat the state passed in as consumed (the JAX steps donate it).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import DEFAULT_NUM_FEATURES
from ..core.batch import iter_blocks, pad_to_bucket, shuffle_rows
from ..core.engine import _to_device, gather, live_lanes
from ..core.state import _numpy
from ..core.striping import translate_to_stripe
from ..device import DeviceLike, resolve_device
from ..ops.convergence import ConversionState
from ..ops.eta import EtaEstimator, get_eta
from ..ops.scatter import scatter_rows_flat
from ..core.collectives import psum
from ..utils.options import Options
from .base import FeatureRows, _stage_rows, base_options, later_slice

# the JAX backend of train_fm that is a later slice of the port: refused by
# name where the JAX package would run it
_LATER_SLICE = {
    "mxu_scatter": "the sorted-window gather/scatter (-mini_batch B "
                   "-mxu_scatter, ops/mxu_scatter.py)",
}


@dataclass
class FMState:
    w0: torch.Tensor  # [] f32
    w: torch.Tensor  # [D]
    v: torch.Tensor  # [D, kp]; lanes past `factors` stay 0
    lambda_w0: torch.Tensor  # []
    lambda_w: torch.Tensor  # []
    lambda_v: torch.Tensor  # [kp]; 0 on the pad lanes
    touched: torch.Tensor  # [D] int8
    step: int  # processed-example counter

    @property
    def dims(self) -> int:
        return self.w.shape[0]

    @property
    def device(self) -> torch.device:
        return self.w.device

    def replace(self, **changes) -> "FMState":
        return dataclasses.replace(self, **changes)


_TENSOR_FIELDS = ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v",
                  "touched")


@dataclass(frozen=True)
class FMHyper:
    factors: int = 5
    classification: bool = False
    lambda0: float = 0.01
    sigma: float = 0.1
    min_target: float = -3.0e38
    max_target: float = 3.0e38
    eta: EtaEstimator = EtaEstimator("invscaling", 0.05, power_t=0.1)
    adareg: bool = False
    va_ratio: float = 0.05
    seed: int = 31

    @property
    def padded_factors(self) -> int:
        """Lane count of the V table: k rounded up to a multiple of 8 when
        k > 4 (the JAX package's layout, kept so artifacts and carried
        states have one shape in both packages). Pad lanes start at 0 and
        stay 0: their gradient terms are products with their own zero V
        entries and their lambda_v is 0; model_rows slices them off."""
        k = self.factors
        if k > 4 and k % 8:
            return k + (8 - k % 8)
        return k


def init_fm_state(dims: int, hyper: FMHyper,
                  device: DeviceLike = None) -> FMState:
    """A fresh model on ``device``: w0 = w = 0, V = JAX's
    ``normal(PRNGKey(seed), (dims, k)) * sigma`` drawn on the host
    (utils/jax_prng.py), lane-padded with zeros, lambdas at lambda0 (0 on
    pad lanes)."""
    from ..utils.jax_prng import normal

    dev = resolve_device(device)
    k, k_pad = hyper.factors, hyper.padded_factors
    v = torch.from_numpy(normal(hyper.seed, (dims, k))
                         * np.float32(hyper.sigma))
    if k_pad != k:
        v = torch.cat([v, torch.zeros((dims, k_pad - k))], dim=1)

    def scalar(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return FMState(
        w0=scalar(0.0),
        w=torch.zeros((dims,), dtype=torch.float32, device=dev),
        v=v.to(dev),
        lambda_w0=scalar(hyper.lambda0),
        lambda_w=scalar(hyper.lambda0),
        lambda_v=torch.tensor([hyper.lambda0] * k + [0.0] * (k_pad - k),
                              dtype=torch.float32, device=dev),
        touched=torch.zeros((dims,), dtype=torch.int8, device=dev),
        step=0,
    )


def fm_state_from_numpy(d: dict, device: DeviceLike = None) -> FMState:
    """Build a state from the JAX FMState's fields as numpy arrays (``w0``,
    ``w``, ``v``, ``lambda_w0``, ``lambda_w``, ``lambda_v``, ``touched``,
    ``step``). Every tensor is a fresh copy."""
    dev = resolve_device(device)
    fields = {k: torch.tensor(np.asarray(d[k]), device=dev)
              for k in _TENSOR_FIELDS}
    fields["touched"] = fields["touched"].to(torch.int8)
    return FMState(step=int(d.get("step", 0)), **fields)


def fm_state_to_numpy(state: FMState) -> dict:
    """The inverse of `fm_state_from_numpy`: numpy copies of every field,
    ``step`` as np.int32 (the JAX state's type)."""
    out = {k: _numpy(getattr(state, k)) for k in _TENSOR_FIELDS}
    out["step"] = np.int32(state.step)
    return out


def _gather_rows(table: torch.Tensor, sidx: torch.Tensor,
                 live: torch.Tensor) -> torch.Tensor:
    """float32 rows ``table[sidx]`` ([..., K, kp]), 0 on dead lanes."""
    return torch.where(live[..., None], table[sidx].float(),
                       torch.zeros((), dtype=torch.float32,
                                   device=table.device))


def _row_predict(w0, wg, vg, val):
    """p [...] and sumVfX [..., kp] from gathered lanes (dead lanes are 0);
    rows batch over the leading axes."""
    linear = torch.sum(wg * val, dim=-1)
    vx = vg * val[..., None]  # [..., K, kp]
    sum_vfx = torch.sum(vx, dim=-2)
    sum_v2x2 = torch.sum(vx * vx, dim=-2)
    p = w0 + linear + 0.5 * torch.sum(sum_vfx * sum_vfx - sum_v2x2, dim=-1)
    return p, sum_vfx


def _psum_predict(w0, wg, vg, val, mesh, axis: str):
    """`_row_predict` on a feature stripe: the three prediction partials
    (linear [...], sumVfX [..., kp], sumV2X2 [..., kp]) of the owned lanes
    summed over the mesh axis in ONE all_reduce, then p."""
    kp = vg.shape[-1]
    vx = vg * val[..., None]
    parts = torch.cat([torch.sum(wg * val, dim=-1)[..., None],
                       torch.sum(vx, dim=-2), torch.sum(vx * vx, dim=-2)],
                      dim=-1)
    parts = psum(parts, mesh, axis)
    linear, sum_vfx = parts[..., 0], parts[..., 1:1 + kp]
    sum_v2x2 = parts[..., 1 + kp:]
    p = w0 + linear + 0.5 * torch.sum(sum_vfx * sum_vfx - sum_v2x2, dim=-1)
    return p, sum_vfx


def sharded_gather_predict(w, v, w0, idx, val, mesh, axis: str,
                           stripe: int):
    """The ONE copy of the feature-sharded FM gather + prediction, used by
    the sharded train step and by sharded scoring (FMShardedTrainer.
    make_predict), so train-time and serve-time p cannot drift: translate
    global ids into the local [stripe] tables (core/striping.py), gather
    the owned lanes, and sum the three prediction partials over the axis
    in one all_reduce. idx/val are [..., K] on w's device. Returns (wg,
    vg, vmask, lidx, p, sumVfX)."""
    lidx, vmask = translate_to_stripe(idx, val, mesh.index(axis), stripe)
    live, sidx = live_lanes(lidx, w.shape[0])
    wg = gather(w, sidx, live)
    vg = _gather_rows(v, sidx, live)
    p, sum_vfx = _psum_predict(w0, wg, vg, vmask, mesh, axis)
    return wg, vg, vmask, lidx, p, sum_vfx


def _dloss_and_loss(p, y, hyper: FMHyper):
    if hyper.classification:
        # dloss = (sigmoid(p*y) - 1)*y; loss = log(1 + exp(-p*y)), which is
        # jnp.logaddexp(0, -z) exactly (F.softplus switches to its linear
        # branch past a threshold and answers differently)
        z = p * y
        g = (torch.sigmoid(z) - 1.0) * y
        loss = torch.logaddexp(torch.zeros_like(z), -z)
    else:
        g = torch.clamp(p, hyper.min_target, hyper.max_target) - y
        loss = 0.5 * g * g  # squared loss for cv tracking
    return g, loss


def _fm_rows(state: FMState, indices, values):
    """(p [B], sumVfX [B, kp]) of a padded block on the state's device:
    the row math of every FM scorer, and the query staging of top-K
    retrieval (serving/retrieval.py)."""
    dev = state.device
    indices = _to_device(indices, torch.int64, dev)
    values = _to_device(values, torch.float32, dev)
    live, sidx = live_lanes(indices, state.dims)
    wg = gather(state.w, sidx, live)
    vg = _gather_rows(state.v, sidx, live)
    return _row_predict(state.w0, wg, vg, values)


def _fm_scores(state: FMState, indices, values) -> torch.Tensor:
    """Margin scores [B] of a padded block on the state's device — the one
    scorer of TrainedFMModel.predict and the f32/bf16 FM servable."""
    return _fm_rows(state, indices, values)[0]


def make_fm_step(hyper: FMHyper, mode: str = "minibatch",
                 mini_batch_average: bool = True,
                 feature_shard: Optional[Tuple[str, int]] = None,
                 pack_w: bool = True,
                 update_backend: str = "xla",
                 device: DeviceLike = None):
    """Build ``step(state, indices, values, labels, va_mask) -> (state,
    loss_sum)``. ``mode="scan"`` replays rows sequentially (reference-
    exact); ``"minibatch"`` applies the block against its start
    parameters, each parameter's summed delta divided by its update count
    under ``mini_batch_average`` (w/V per feature, w0 by the batch), the
    raw sums without it. ``va_mask`` [B] marks adareg validation rows
    (1.0): they update the lambdas, not theta.

    ``pack_w`` is accepted for the JAX signature: there it selects whether
    w rides a V pad lane through one row gather and scatter, a layout the
    JAX tests pin equal to the split one. The port computes both the same
    way (w and V as separate tables). ``update_backend="mxu"`` is a later
    slice of the port and raises.

    ``feature_shard=(mesh, axis, stripe)`` runs the same step on this
    rank's [stripe] slice of w and V (parallel/sharded_train.py
    FMShardedTrainer): ids translate to the stripe, each row's prediction
    partials are summed over the axis (`sharded_gather_predict`), and the
    lane updates, functions of (global g, global sumVfX, lane-local w /
    V), scatter into the local stripe only. Exact up to the order of that
    sum. adareg is refused sharded, as in JAX (its lambda updates need
    cross-stripe sums)."""
    if mode not in ("scan", "minibatch"):
        raise ValueError(f"unknown mode {mode!r}")
    if feature_shard is not None and hyper.adareg:
        raise ValueError("adareg is not supported with feature_shard")
    if update_backend not in ("xla", "mxu"):
        raise ValueError(f"unknown update_backend {update_backend!r}")
    if update_backend == "mxu":
        raise ValueError("update_backend='mxu' (the sorted-window gather/"
                         "scatter, ops/mxu_scatter.py) is a later slice of "
                         "the torch port: ROADMAP Queue 2 #3; use the "
                         "default backend")
    del pack_w  # one layout serves both settings (see the docstring)
    dev = resolve_device(device)
    k = hyper.factors

    def inputs(indices, values, labels):
        idx = _to_device(indices, torch.int64, dev)
        val = _to_device(values, torch.float32, dev)
        if feature_shard is not None:
            mesh, axis, stripe = feature_shard
            idx, val = translate_to_stripe(idx, val, mesh.index(axis),
                                           stripe)
        return idx, val, _to_device(labels, torch.float32, dev)

    def row_predict(w0, wg, vg, val):
        if feature_shard is None:
            return _row_predict(w0, wg, vg, val)
        return _psum_predict(w0, wg, vg, val, *feature_shard[:2])

    def theta_deltas(st: FMState, eta, g, val, wg, vg, sum_vfx):
        """dw0 [...], dw [..., K], dv [..., K, kp] of rows against `st`;
        eta and g are row scalars ([] or [B])."""
        e1, g1 = eta[..., None], g[..., None]
        dw0 = -eta * (g + 2.0 * st.lambda_w0 * st.w0)
        dw = -e1 * (g1 * val + 2.0 * st.lambda_w * wg)
        x2 = val * val
        grad_v = val[..., None] * sum_vfx[..., None, :] - vg * x2[..., None]
        dv = -e1[..., None] * (g1[..., None] * grad_v
                               + 2.0 * st.lambda_v * vg)
        return dw0, dw, dv

    def lambda_deltas(st: FMState, eta, g, val, wg, vg, sum_vfx):
        """Adaptive-regularization lambda deltas of rows against `st`
        (ref: FactorizationMachineModel.java:253-300)."""
        e1, g1 = eta[..., None], g[..., None]
        dl_w0 = -eta * g * (-2.0 * eta * st.w0)
        sum_wx = torch.sum(wg * val, dim=-1)
        dl_w = -eta * g * (-2.0 * eta * sum_wx)
        grad_v = val[..., None] * sum_vfx[..., None, :] \
            - vg * (val * val)[..., None]
        v_dash = vg - e1[..., None] * (g1[..., None] * grad_v
                                       + 2.0 * st.lambda_v * vg)
        sum_f_dash = torch.sum(val[..., None] * v_dash, dim=-2)
        sum_f_dash_f = torch.sum(val[..., None] * v_dash * val[..., None]
                                 * vg, dim=-2)
        dl_v = -e1 * g1 * (-2.0 * e1 * (sum_f_dash * sum_vfx
                                        - sum_f_dash_f))
        return dl_w0, dl_w, dl_v

    def touched_after(st: FMState, indices, live, trained):
        """touched |= the live lanes of the rows in `trained` [B] (the JAX
        int8 .at[].max of 0/1, as index_fill_ of 1 through a D + 1 scratch
        whose extra entry takes the other lanes)."""
        d = st.dims
        sink = torch.where(live & trained[:, None], indices,
                           torch.full_like(indices, d))
        ext = torch.cat([st.touched, st.touched.new_zeros(1)])
        ext.index_fill_(0, sink.reshape(-1), 1)
        return ext[:d]

    def scan_step(state: FMState, indices, values, labels, va_mask):
        indices, values, labels = inputs(indices, values, labels)
        # the validation mask steers host control flow: one copy a block
        va = np.asarray(va_mask.cpu() if torch.is_tensor(va_mask)
                        else va_mask, np.float32)
        b_rows = indices.shape[0]
        live, sidx = live_lanes(indices, state.dims)
        # every row's eta at once, on the device: a row reads a view
        etas = hyper.eta.eta(
            (state.step + 1 + torch.arange(b_rows, device=dev)).float())
        st = state
        losses = []
        for b in range(b_rows):
            eta = etas[b]
            lv, si, val = live[b], sidx[b], values[b]
            wg = gather(st.w, si, lv)
            vg = _gather_rows(st.v, si, lv)
            p, sum_vfx = row_predict(st.w0, wg, vg, val)
            g, loss = _dloss_and_loss(p, labels[b], hyper)
            if va[b] > 0:  # theta = 0: theta's update adds exact zeros
                if hyper.adareg:
                    dl_w0, dl_w, dl_v = lambda_deltas(st, eta, g, val, wg,
                                                      vg, sum_vfx)
                    st = st.replace(
                        lambda_w0=torch.clamp(st.lambda_w0 + dl_w0, min=0.0),
                        lambda_w=torch.clamp(st.lambda_w + dl_w, min=0.0),
                        lambda_v=torch.clamp(st.lambda_v + dl_v, min=0.0))
                continue
            # a training row: its lambda update is is_va * delta = 0
            dw0, dw, dv = theta_deltas(st, eta, g, val, wg, vg, sum_vfx)
            st.w.index_add_(0, si, torch.where(lv, dw, -0.0))
            scatter_rows_flat(st.v, si, dv)
            st = st.replace(w0=st.w0 + dw0)
            losses.append(loss)
        trained = torch.from_numpy(va <= 0).to(dev)
        loss = torch.stack(losses).sum() if losses \
            else torch.zeros((), device=dev)
        return st.replace(touched=touched_after(st, indices, live, trained),
                          step=state.step + b_rows), loss

    def minibatch_step(state: FMState, indices, values, labels, va_mask):
        indices, values, labels = inputs(indices, values, labels)
        va = _to_device(va_mask, torch.float32, dev)
        b, d = indices.shape[0], state.dims
        ts = (state.step + 1 + torch.arange(b, device=dev)).float()
        eta = hyper.eta.eta(ts)
        live, sidx = live_lanes(indices, d)
        wg = gather(state.w, sidx, live)
        vg = _gather_rows(state.v, sidx, live)
        p, sum_vfx = row_predict(state.w0, wg, vg, values)
        g, loss = _dloss_and_loss(p, labels, hyper)
        dw0, dw, dv = theta_deltas(state, eta, g, values, wg, vg, sum_vfx)
        theta = 1.0 - va  # [B]
        lane_dw = torch.where(live, theta[:, None] * dw, -0.0)
        lane_dv = theta[:, None, None] * dv[..., :k]
        if mini_batch_average:
            # FloatAccumulator semantics: delta sums and update counts into
            # zeroed tables, one elementwise apply
            counts = torch.zeros(d, dtype=torch.float32, device=dev) \
                .index_add_(0, sidx.reshape(-1),
                            torch.where(live, theta[:, None], -0.0)
                            .reshape(-1))
            denom = torch.clamp(counts, min=1.0)
            dw_sum = torch.zeros_like(counts).index_add_(
                0, sidx.reshape(-1), lane_dw.reshape(-1))
            new_w = (state.w.float() + dw_sum / denom).to(state.w.dtype)
            dv_sum = scatter_rows_flat(
                torch.zeros(state.v.shape, dtype=torch.float32, device=dev),
                indices, lane_dv)
            new_v = (state.v.float() + dv_sum / denom[:, None]) \
                .to(state.v.dtype)
            new_w0 = state.w0 + torch.sum(theta * dw0) / torch.clamp(
                torch.sum(theta), min=1.0)
        else:
            new_w = state.w.index_add_(0, sidx.reshape(-1),
                                       lane_dw.reshape(-1))
            new_v = scatter_rows_flat(state.v, indices, lane_dv)
            new_w0 = state.w0 + torch.sum(theta * dw0)
        new_state = state.replace(
            w0=new_w0, w=new_w, v=new_v,
            touched=touched_after(state, indices, live, theta > 0),
            step=state.step + b)
        if hyper.adareg:
            dl_w0, dl_w, dl_v = lambda_deltas(state, eta, g, values, wg, vg,
                                              sum_vfx)
            new_state = new_state.replace(
                lambda_w0=torch.clamp(
                    state.lambda_w0 + torch.sum(va * dl_w0), min=0.0),
                lambda_w=torch.clamp(
                    state.lambda_w + torch.sum(va * dl_w), min=0.0),
                lambda_v=torch.clamp(
                    state.lambda_v + torch.sum(va[:, None] * dl_v, dim=0),
                    min=0.0))
        return new_state, torch.sum(theta * loss)

    return scan_step if mode == "scan" else minibatch_step


@dataclass
class TrainedFMModel:
    state: FMState
    hyper: FMHyper
    dims: int

    def predict(self, features: FeatureRows) -> np.ndarray:
        """Margin scores on the state's device, in blocks of 4096 rows;
        numpy results."""
        idx_rows, val_rows = _stage_rows(features, self.dims)
        n = len(idx_rows)
        width = pad_to_bucket(max((len(r) for r in idx_rows), default=1))
        out = [_fm_scores(self.state, blk.indices, blk.values)
               for blk in iter_blocks(idx_rows, val_rows, np.zeros(n),
                                      self.dims, 4096, width)]
        if not out:
            return np.zeros(0, np.float32)
        return torch.cat(out).cpu().numpy()[:n]

    def model_rows(self):
        """(w0, feature, Wi, Vi[factors]) over touched features (feature 0
        carries w0 in the reference, ref: forwardAsIntFeature
        FactorizationMachineUDTF.java:446-519); V's pad lanes are sliced
        back to the logical k."""
        touched = _numpy(self.state.touched) != 0
        feats = np.nonzero(touched)[0].astype(np.int64)
        w = _numpy(self.state.w)[feats]
        v = _numpy(self.state.v)[feats][:, :self.hyper.factors]
        return float(self.state.w0), feats, w, v


def _fm_options() -> Options:
    o = base_options()
    o.add("c", "classification", False, "Act as classification")
    o.add("seed", None, True, "Seed value [default: 31]", default=31, type=int)
    o.add("p", "num_features", True, "The size of feature dimensions", type=int)
    o.add("factor", "factors", True, "Number of latent factors [default: 5]",
          default=5, type=int)
    o.add("sigma", None, True, "Stddev for initializing V [default: 0.1]",
          default=0.1, type=float)
    o.add("lambda0", "lambda", True, "Regularization lambda [default: 0.01]",
          default=0.01, type=float)
    o.add("min", "min_target", True, "Min target value", type=float)
    o.add("max", "max_target", True, "Max target value", type=float)
    o.add("eta", None, True, "Fixed learning rate", type=float)
    o.add("eta0", None, True, "Initial learning rate [default 0.05]", default=0.05,
          type=float)
    o.add("t", "total_steps", True, "Total training steps", type=int)
    o.add("power_t", None, True, "Inverse-scaling exponent [default 0.1]",
          default=0.1, type=float)
    o.add("adareg", "adaptive_regularizaion", False, "Adaptive regularization")
    o.add("va_ratio", "validation_ratio", True, "Validation ratio [default 0.05]",
          default=0.05, type=float)
    o.add("int_feature", "feature_as_integer", False, "Parse features as integers")
    return o


def train_fm(features: FeatureRows, targets, options: Optional[str] = None,
             device: DeviceLike = None) -> TrainedFMModel:
    """Train an FM on the CUDA device (``device="cpu"`` asks for the CPU).
    Default ``-mini_batch 1`` is the exact per-row scan; ``-mini_batch B``
    the averaged minibatch; ``-native_scan`` the exact scan through the
    native C row loop on the host, its model then placed on the device.
    ``-mxu_scatter`` with ``-mini_batch`` is a later slice of the port and
    raises; in scan mode it is ignored, as in the JAX package."""
    cl = _fm_options().parse(options, "train_fm")
    dev = resolve_device(device)
    dims = cl.get_int("dims") or cl.get_int("p") or DEFAULT_NUM_FEATURES
    hyper = FMHyper(
        factors=cl.get_int("factor", 5),
        classification=cl.has("c"),
        lambda0=cl.get_float("lambda0", 0.01),
        sigma=cl.get_float("sigma", 0.1),
        min_target=cl.get_float("min", -3.0e38),
        max_target=cl.get_float("max", 3.0e38),
        eta=get_eta(cl, 0.05),
        adareg=cl.has("adareg"),
        va_ratio=cl.get_float("va_ratio", 0.05),
        seed=cl.get_int("seed", 31),
    )
    targets = np.asarray(targets, dtype=np.float32)
    if hyper.classification:
        targets = np.where(targets > 0, 1.0, -1.0).astype(np.float32)
    idx_rows, val_rows = _stage_rows(features, dims)
    n = len(idx_rows)
    width = pad_to_bucket(max((len(r) for r in idx_rows), default=1))
    mini_batch = cl.get_int("mini_batch", 1)
    mode = "minibatch" if mini_batch > 1 else "scan"
    block = mini_batch if mode == "minibatch" else cl.get_int("block_size", 4096)
    iters = cl.get_int("iters", 1)
    if cl.has("native_scan"):
        return _train_fm_native_scan(cl, hyper, dims, idx_rows, val_rows,
                                     targets, width, block, mode, iters, dev)
    if cl.has("mxu_scatter") and mode == "minibatch":
        raise later_slice("mxu_scatter", _LATER_SLICE["mxu_scatter"])
    step = make_fm_step(hyper, mode, device=dev)
    state = init_fm_state(dims, hyper, device=dev)
    # the JAX package's validation-row stream, draw for draw
    rng = np.random.RandomState(hyper.seed)
    conv = ConversionState(not cl.has("disable_cv"), cl.get_float("cv_rate", 0.005))
    for it in range(max(1, iters)):
        if cl.has("shuffle") and it > 0:
            idx_rows, val_rows, targets = shuffle_rows(idx_rows, val_rows, targets,
                                                       hyper.seed + it)
        # block losses stay on the device; ONE transfer per epoch, summed
        # on the host in block order as the JAX loop does
        losses = []
        for blk in iter_blocks(idx_rows, val_rows, targets, dims, block, width):
            va = (rng.rand(blk.batch_size) < hyper.va_ratio).astype(np.float32) \
                if hyper.adareg else np.zeros(blk.batch_size, np.float32)
            state, loss = step(state, blk.indices, blk.values, blk.labels, va)
            losses.append(loss)
        conv.incr_loss(sum(torch.stack(losses).cpu().tolist()) if losses
                       else 0.0)
        if iters > 1 and conv.is_converged(n):
            break
    return TrainedFMModel(state=state, hyper=hyper, dims=dims)


def _train_fm_native_scan(cl, hyper: FMHyper, dims, idx_rows, val_rows,
                          targets, width, block, mode, iters,
                          dev) -> TrainedFMModel:
    """`-native_scan`: exact sequential FM epochs through the C row loop
    (native/hivemall_native.cpp::hm_fm_reference_rowloop) on host numpy
    tables, the JAX package's host path. Envelope = where the C loop and
    the scan step coincide: -classification, a FIXED -eta, no -adareg,
    per-row scan mode; anything else refuses. It starts from the port's
    own `init_fm_state` (drawn on the host), so it matches the port's scan
    mode from the same V, with one pinned deviation: a feature repeated
    WITHIN a row sees in-place partial updates lane to lane, like the
    reference's per-feature loop, where the scan gathers the row once. The
    C loop also sums a row's score in float64. The trained state is placed
    on `dev`, V's lane padding restored."""
    from .. import native

    problems = []
    if not hyper.classification:
        problems.append("-classification (the C loop is the logistic form)")
    if hyper.eta.kind != "fixed":
        problems.append("a fixed -eta (C runs a constant learning rate)")
    if hyper.adareg:
        problems.append("no -adareg")
    if mode != "scan":
        problems.append("per-row scan mode (drop -mini_batch)")
    if problems:
        raise ValueError("-native_scan for train_fm requires: "
                         + "; ".join(problems))
    d0 = fm_state_to_numpy(init_fm_state(dims, hyper, device="cpu"))
    k = hyper.factors
    # one sentinel slot at index dims: block padding writes land there and
    # are sliced off (value-0 lanes still take the L2 decay term, like the
    # reference's own loop — confined to the sentinel)
    st = {
        "w0": np.zeros(1, np.float32),
        "w": np.concatenate([d0["w"], np.zeros(1, np.float32)]),
        "V": np.concatenate([d0["v"][:, :k], np.zeros((1, k), np.float32)]),
        "touch": np.zeros(dims + 1, np.uint8),
    }
    # zero-row probe: builds and loads the library (raising if it cannot)
    # without touching the state (a fake row would shift the global w0)
    native.fm_reference_rowloop(
        np.zeros((0, 1), np.int32), np.zeros((0, 1), np.float32),
        np.zeros(0, np.float32), dims + 1, k=k, eta=hyper.eta.eta0,
        lam=hyper.lambda0, state=st, track_touched=True)
    n = len(idx_rows)
    conv = ConversionState(not cl.has("disable_cv"),
                           cl.get_float("cv_rate", 0.005))
    for it in range(max(1, iters)):
        if cl.has("shuffle") and it > 0:
            idx_rows, val_rows, targets = shuffle_rows(
                idx_rows, val_rows, targets, hyper.seed + it)
        epoch_errors = 0
        for blk in iter_blocks(idx_rows, val_rows, targets, dims, block,
                               width):
            epoch_errors += native.fm_reference_rowloop(
                blk.indices, blk.values, blk.labels, dims + 1, k=k,
                eta=hyper.eta.eta0, lam=hyper.lambda0, state=st,
                track_touched=True)
        # convergence proxy = sign-error count (the C loop's return);
        # the scan tracks logloss — a documented deviation
        conv.incr_loss(float(epoch_errors))
        if iters > 1 and conv.is_converged(n):
            break
    v_back = st["V"][:dims]
    if hyper.padded_factors != k:  # restore the physical lane padding
        v_back = np.concatenate(
            [v_back, np.zeros((dims, hyper.padded_factors - k), np.float32)],
            axis=1)
    d0.update(w0=st["w0"][0], w=st["w"][:dims], v=v_back,
              touched=(st["touch"][:dims] != 0).astype(np.int8),
              step=n * (it + 1))
    return TrainedFMModel(state=fm_state_from_numpy(d0, device=dev),
                          hyper=hyper, dims=dims)


def fm_predict(w0: float, w: Sequence[float], v: Sequence[Sequence[float]],
               feats: Sequence[int], xs: Sequence[float]) -> float:
    """`fm_predict` UDAF equivalent: score one row from model rows
    (ref: fm/FMPredictGenericUDAF.java) — p = w0 + sum w_i x_i + pairwise V
    term, in float64 on the host."""
    w = np.asarray(w, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    x = np.asarray(xs, dtype=np.float64)
    linear = float(np.sum(w * x))
    vx = v * x[:, None]
    s = np.sum(vx, axis=0)
    s2 = np.sum(vx * vx, axis=0)
    return float(w0 + linear + 0.5 * np.sum(s * s - s2))
