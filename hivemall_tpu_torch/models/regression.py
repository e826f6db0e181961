"""Online regressors: train_logistic_regr (logress) / train_adagrad_regr /
train_adadelta_regr / train_pa1_regr / train_pa1a_regr / train_pa2_regr /
train_pa2a_regr / train_arow_regr / train_arowe_regr / train_arowe2_regr.

Update formulas mirror the reference:
- Logress: SGD on the logistic "gradient" target - sigmoid(p) with the
  EtaEstimator schedules (ref: regression/LogressUDTF.java:35-83,
  common/EtaEstimator.java).
- AdaGrad: per-feature eta / sqrt(eps + G) with the x100 scaling trick
  (ref: regression/AdaGradUDTF.java:97-143).
- AdaDelta: rho/eps accumulators over g^2 and dx^2
  (ref: regression/AdaDeltaUDTF.java:97-140).
- PA regressors: epsilon-insensitive loss, eta = min(C, loss/|x|^2) (PA1) or
  loss/(|x|^2 + 1/2C) (PA2); the "a" variants scale epsilon by the running
  target stddev (ref: regression/PassiveAggressiveRegressionUDTF.java:39-216).
- AROW regression + e/e2 variants (ref: regression/AROWRegressionUDTF.java:41-232).

The mini-batch path (`-mini_batch`) reproduces RegressionBaseUDTF's
accumulate-then-apply-average semantics (ref: RegressionBaseUDTF.java:236-295).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.engine import Rule, RuleOutput
from ..ops.eta import get_eta
from .base import FeatureRows, base_options, fit_linear

# Java Float.MAX_VALUE (PA default aggressiveness), exactly: torch refuses
# a Python float that rounds up past the float32 range
FLOAT_MAX = 3.4028234663852886e38


def _lanes(x):
    """Broadcast a row scalar ([] or [B]) onto the lane axis."""
    return x[..., None]


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _logistic_grad(target, predicted):
    # LossFunctions.logisticLoss(target, predicted) (ref: LossFunctions.java:381-392)
    return torch.where(predicted > -100.0, target - _sigmoid(predicted), target)


def _always(ctx):
    return torch.ones_like(ctx.score, dtype=torch.bool)


# ---------------------------------------------------------------- logress

def _make_logress_rule(eta_est):
    def update(ctx, hyper):
        gradient = _logistic_grad(ctx.y, ctx.score)
        coeff = eta_est.eta(ctx.t) * gradient  # (ref: LogressUDTF.java:78-82)
        dw = _lanes(coeff) * ctx.val
        loss = gradient * gradient  # squared residual proxy for convergence
        return RuleOutput(dw=dw, loss=loss, updated=_always(ctx))

    return Rule("logress", update, is_regression=True)


def logress_hyper(eta_est) -> dict:
    """The eta schedule's fields under the names of the CUDA scan kernel's
    logress form (kernels/csrc/linear_scan.cu); the rule's own update reads
    `eta_est` and ignores them."""
    return {"schedule": eta_est.kind, "eta0": eta_est.eta0,
            "total_steps": eta_est.total_steps, "power_t": eta_est.power_t}


def train_logistic_regr(features: FeatureRows, targets, options: Optional[str] = None, **kw):
    o = base_options()
    o.add("t", "total_steps", True, "total of n_samples * epochs time steps", type=int)
    o.add("power_t", None, True, "Exponent for inverse scaling learning rate [default 0.1]",
          default=0.1, type=float)
    o.add("eta0", None, True, "Initial learning rate [default 0.1]", default=0.1, type=float)
    o.add("eta", None, True, "Fixed learning rate", type=float)
    o.add("boldDriver", None, False, "Use bold-driver eta adjustment")
    cl = o.parse(options, "train_logistic_regr")
    eta_est = get_eta(cl)
    return fit_linear(_make_logress_rule(eta_est), logress_hyper(eta_est), cl,
                      features, targets, **kw)


train_logress = train_logistic_regr


# ---------------------------------------------------------------- adagrad

def _adagrad_update(ctx, hyper):
    gradient = _logistic_grad(ctx.y, ctx.score)
    g_g = gradient * (gradient / hyper["scale"])  # (ref: AdaGradUDTF.java:104)
    new_sqg = ctx.slots["sum_sqgrad"] + _lanes(g_g)
    eta_t = hyper["eta"] / torch.sqrt(hyper["eps"] + new_sqg * hyper["scale"])  # (:139-143)
    dw = eta_t * _lanes(gradient) * ctx.val
    # g_g is lane-independent: every live lane's slot takes it
    dslots = {"sum_sqgrad": _lanes(g_g).expand_as(ctx.val)}
    return RuleOutput(dw=dw, loss=gradient * gradient, updated=_always(ctx),
                      dslots=dslots)


ADAGRAD_REGR = Rule("adagrad_regr", _adagrad_update, slot_names=("sum_sqgrad",),
                    is_regression=True, slot_merge=(("sum_sqgrad", "sum"),))


def train_adagrad_regr(features: FeatureRows, targets, options: Optional[str] = None, **kw):
    o = base_options()
    o.add("eta", "eta0", True, "Initial learning rate [default 1.0]", default=1.0, type=float)
    o.add("eps", None, True, "Denominator constant [default 1.0]", default=1.0, type=float)
    o.add("scale", None, True, "Internal scaling factor [default 100]", default=100.0,
          type=float)
    cl = o.parse(options, "train_adagrad_regr")
    hyper = {"eta": cl.get_float("eta", 1.0), "eps": cl.get_float("eps", 1.0),
             "scale": cl.get_float("scale", 100.0)}
    return fit_linear(ADAGRAD_REGR, hyper, cl, features, targets, **kw)


# ---------------------------------------------------------------- adadelta

def _adadelta_update(ctx, hyper):
    decay, eps, scale = hyper["rho"], hyper["eps"], hyper["scale"]
    gradient = _logistic_grad(ctx.y, ctx.score)
    g_g = _lanes(gradient * (gradient / scale))
    old_sqg = ctx.slots["sum_sqgrad"]
    old_sqdx = ctx.slots["sum_sq_dx"]
    new_sqg = decay * old_sqg + (1.0 - decay) * g_g
    dx = torch.sqrt((old_sqdx + eps) / (old_sqg * scale + eps)) * _lanes(gradient)
    new_sqdx = decay * old_sqdx + (1.0 - decay) * dx * dx
    # (ref: AdaDeltaUDTF.java:120-140)
    dw = dx * ctx.val
    dslots = {"sum_sqgrad": new_sqg - old_sqg, "sum_sq_dx": new_sqdx - old_sqdx}
    return RuleOutput(dw=dw, loss=gradient * gradient, updated=_always(ctx),
                      dslots=dslots)


ADADELTA_REGR = Rule("adadelta_regr", _adadelta_update,
                     slot_names=("sum_sqgrad", "sum_sq_dx"), is_regression=True,
                     slot_merge=(("sum_sqgrad", "mean"), ("sum_sq_dx", "mean")))


def train_adadelta_regr(features: FeatureRows, targets, options: Optional[str] = None, **kw):
    o = base_options()
    o.add("rho", "decay", True, "Decay rate [default 0.95]", default=0.95, type=float)
    o.add("eps", None, True, "Denominator constant [default 1e-6]", default=1e-6, type=float)
    o.add("scale", None, True, "Internal scaling factor [default 100]", default=100.0,
          type=float)
    cl = o.parse(options, "train_adadelta_regr")
    hyper = {"rho": cl.get_float("rho", 0.95), "eps": cl.get_float("eps", 1e-6),
             "scale": cl.get_float("scale", 100.0)}
    return fit_linear(ADADELTA_REGR, hyper, cl, features, targets, **kw)


# ----------------------------------------------------- Welford target stddev

def _welford_pre_row(gl, y):
    # single-observation Welford step (ref: common/OnlineVariance.java:24-44)
    n = gl["n"] + 1.0
    delta = y - gl["mean"]
    mean = gl["mean"] + delta / n
    m2 = gl["m2"] + delta * (y - mean)
    return {"n": n, "mean": mean, "m2": m2}


def _welford_pre_batch(gl, labels):
    # Chan et al. parallel merge of the block's stats into the running stats
    # the row count as a Python float: a launch argument, not a copy to the
    # device (the -batch chunk loop must not wait on one)
    b = float(labels.shape[0])
    bmean = torch.mean(labels)
    bm2 = torch.sum((labels - bmean) ** 2)
    n = gl["n"]
    tot = n + b
    delta = bmean - gl["mean"]
    mean = gl["mean"] + delta * b / tot
    m2 = gl["m2"] + bm2 + delta * delta * n * b / tot
    return {"n": tot, "mean": mean, "m2": m2}


def _stddev(gl):
    var = torch.where(gl["n"] > 1.0,
                      gl["m2"] / torch.clamp(gl["n"] - 1.0, min=1.0), 0.0)
    return torch.sqrt(torch.clamp(var, min=0.0))


# ------------------------------------------------------------ PA regressors

def _pa_regr_update_factory(variant: str, adaptive: bool):
    def update(ctx, hyper):
        eps = hyper["epsilon"] * (_stddev(ctx.globals) if adaptive else 1.0)
        predicted = ctx.score
        loss = torch.clamp(torch.abs(ctx.y - predicted) - eps, min=0.0)
        sign = torch.where(ctx.y - predicted > 0.0, 1.0, -1.0)
        if variant == "pa1":
            eta = torch.clamp(torch.where(
                ctx.sq_norm == 0.0, FLOAT_MAX,
                loss / torch.clamp(ctx.sq_norm, min=1e-38)), max=hyper["c"])
        else:  # pa2
            eta = loss / (ctx.sq_norm + 0.5 / hyper["c"])
        coeff = sign * eta
        updated = (loss > 0.0) & torch.isfinite(coeff)
        dw = torch.where(_lanes(updated), _lanes(coeff) * ctx.val, 0.0)
        return RuleOutput(dw=dw, loss=loss, updated=updated)

    return update


def _pa_regr_rule(variant: str, adaptive: bool) -> Rule:
    kw = {}
    if adaptive:
        kw = dict(global_names=("n", "mean", "m2"), pre_row=_welford_pre_row,
                  pre_batch=_welford_pre_batch)
    return Rule(f"{variant}{'a' if adaptive else ''}_regr",
                _pa_regr_update_factory(variant, adaptive), is_regression=True, **kw)


PA1_REGR = _pa_regr_rule("pa1", False)
PA1A_REGR = _pa_regr_rule("pa1", True)
PA2_REGR = _pa_regr_rule("pa2", False)
PA2A_REGR = _pa_regr_rule("pa2", True)


def _pa_regr_train(rule: Rule, name: str, default_c: float):
    def train(features: FeatureRows, targets, options: Optional[str] = None, **kw):
        o = base_options()
        o.add("c", "aggressiveness", True, "Aggressiveness parameter C", default=default_c,
              type=float)
        o.add("e", "epsilon", True, "Sensitivity to prediction mistakes [default 0.1]",
              default=0.1, type=float)
        cl = o.parse(options, name)
        hyper = {"c": cl.get_float("c", default_c), "epsilon": cl.get_float("e", 0.1)}
        return fit_linear(rule, hyper, cl, features, targets, **kw)

    train.__name__ = name
    return train


# PA1 default C = Float.MAX_VALUE; PA2 default C = 1
# (ref: PassiveAggressiveRegressionUDTF.java:94-98, 174-178)
train_pa1_regr = _pa_regr_train(PA1_REGR, "train_pa1_regr", FLOAT_MAX)
train_pa1a_regr = _pa_regr_train(PA1A_REGR, "train_pa1a_regr", FLOAT_MAX)
train_pa2_regr = _pa_regr_train(PA2_REGR, "train_pa2_regr", 1.0)
train_pa2a_regr = _pa_regr_train(PA2A_REGR, "train_pa2a_regr", 1.0)


# ---------------------------------------------------------- AROW regressors

def _arow_regr_update_factory(variant: str):
    def update(ctx, hyper):
        predicted = ctx.score
        beta = 1.0 / (ctx.variance + hyper["r"])
        cv = ctx.cov * ctx.val
        if variant == "arow":
            # always updates; coeff = (target - predicted)
            # (ref: AROWRegressionUDTF.java:90-143)
            coeff = ctx.y - predicted
            updated = _always(ctx)
            loss = coeff * coeff
        else:
            # e / e2: epsilon-insensitive gate (ref: :176-190)
            eps = hyper["epsilon"] * (_stddev(ctx.globals) if variant == "arowe2" else 1.0)
            l = torch.clamp(torch.abs(ctx.y - predicted) - eps, min=0.0)
            coeff = torch.where(ctx.y - predicted > 0.0, l, -l)
            updated = l > 0.0
            loss = l
        dw = torch.where(_lanes(updated), _lanes(coeff) * cv * _lanes(beta), 0.0)
        dcov = torch.where(_lanes(updated), _lanes(-beta) * cv * cv, 0.0)
        return RuleOutput(dw=dw, loss=loss, updated=updated, dcov=dcov)

    return update


AROW_REGR = Rule("arow_regr", _arow_regr_update_factory("arow"), use_covariance=True,
                 is_regression=True)
AROWE_REGR = Rule("arowe_regr", _arow_regr_update_factory("arowe"), use_covariance=True,
                  is_regression=True)
AROWE2_REGR = Rule("arowe2_regr", _arow_regr_update_factory("arowe2"), use_covariance=True,
                   is_regression=True, global_names=("n", "mean", "m2"),
                   pre_row=_welford_pre_row, pre_batch=_welford_pre_batch)


def _arow_regr_train(rule: Rule, name: str, with_eps: bool):
    def train(features: FeatureRows, targets, options: Optional[str] = None, **kw):
        o = base_options()
        o.add("r", "regularization", True, "Regularization parameter r > 0 [default 0.1]",
              default=0.1, type=float)
        if with_eps:
            o.add("e", "epsilon", True, "Sensitivity to prediction mistakes [default 0.1]",
                  default=0.1, type=float)
        cl = o.parse(options, name)
        hyper = {"r": cl.get_float("r", 0.1)}
        if with_eps:
            hyper["epsilon"] = cl.get_float("e", 0.1)
        return fit_linear(rule, hyper, cl, features, targets, **kw)

    train.__name__ = name
    return train


train_arow_regr = _arow_regr_train(AROW_REGR, "train_arow_regr", False)
train_arowe_regr = _arow_regr_train(AROWE_REGR, "train_arowe_regr", True)
train_arowe2_regr = _arow_regr_train(AROWE2_REGR, "train_arowe2_regr", True)
