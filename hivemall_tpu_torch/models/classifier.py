"""Binary online classifiers: train_perceptron / train_pa / train_pa1 /
train_pa2 / train_cw / train_arow / train_arowh / train_scw / train_scw2 /
train_adagrad_rda.

Each learner is a closed-form per-row update Rule executed by the engine
(core/engine.py) or, under `-pallas` on the card, by the CUDA scan kernel
(kernels/csrc/linear_scan.cu carries the same closed forms). Update formulas
mirror the reference exactly:

- Perceptron (ref: classifier/PerceptronUDTF.java:34-50)
- PA/PA1/PA2 (ref: classifier/PassiveAggressiveUDTF.java:38-135)
- CW (ref: classifier/ConfidenceWeightedUDTF.java:51-164)
- AROW/AROWh (ref: classifier/AROWClassifierUDTF.java:49-212)
- SCW1/SCW2 (ref: classifier/SoftConfideceWeightedUDTF.java:45-246)
- AdaGradRDA (ref: classifier/AdaGradRDAUDTF.java:40-143)

Row scalars have shape [] (scan) or [B] (minibatch); `x[..., None]`
broadcasts them onto the K lanes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.engine import Rule, RuleOutput
from ..utils.options import CommandLine, Options
from .base import FeatureRows, TrainedLinearModel, base_options, binary_label_map, fit_linear


def _probit(p: float, bound: float = 5.0) -> float:
    """probit(p) = sqrt(2) * erfinv(2p - 1), clamped to [-bound, bound]
    (ref: utils/math/StatsUtils.java:35-60)."""
    if p == 0.0:
        return -bound
    if p == 1.0:
        return bound
    erf_inv = float(torch.special.erfinv(
        torch.tensor(2.0 * p - 1.0, dtype=torch.float32)))
    v = math.sqrt(2.0) * erf_inv
    return max(-bound, min(bound, v))


def _resolve_phi(cl: CommandLine) -> float:
    """-phi directly, else probit(-eta) (ref: ConfidenceWeightedUDTF.java:85-104)."""
    if cl.has("phi"):
        return cl.get_float("phi")
    if cl.has("eta"):
        eta = cl.get_float("eta")
        if eta <= 0.5 or eta > 1.0:
            raise ValueError(f"eta must be in (0.5, 1]: {eta}")
        return _probit(eta, 5.0)
    return 1.0


def _safe_div(num, den):
    """x/y with 0 where y == 0 — the reference's explicit divide-by-zero guards."""
    zero = den == 0.0
    return torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))


def _lanes(x):
    """Broadcast a row scalar ([] or [B]) onto the lane axis."""
    return x[..., None]


# ---------------------------------------------------------------- perceptron

def _perceptron_update(ctx, hyper):
    # on misclassify (y * score <= 0): w += y * x (ref: PerceptronUDTF.java:44-50)
    updated = ctx.y * ctx.score <= 0.0
    dw = torch.where(_lanes(updated), _lanes(ctx.y) * ctx.val, 0.0)
    loss = torch.where(updated, 1.0, 0.0)
    return RuleOutput(dw=dw, loss=loss, updated=updated)


PERCEPTRON = Rule("perceptron", _perceptron_update)


# ------------------------------------------------------------------- PA family

def _pa_update_factory(variant: str):
    def update(ctx, hyper):
        loss = torch.clamp(1.0 - ctx.y * ctx.score, min=0.0)  # hinge
        if variant == "pa":
            eta = _safe_div(loss, ctx.sq_norm)  # (ref: PassiveAggressiveUDTF.java:67-68)
        elif variant == "pa1":
            eta = torch.clamp(_safe_div(loss, ctx.sq_norm), max=hyper["c"])  # (:109-112)
        else:  # pa2
            eta = loss / (ctx.sq_norm + 0.5 / hyper["c"])  # (:125-128)
        updated = loss > 0.0
        dw = torch.where(_lanes(updated), _lanes(eta * ctx.y) * ctx.val, 0.0)
        return RuleOutput(dw=dw, loss=loss, updated=updated)

    return update


PA = Rule("pa", _pa_update_factory("pa"))
PA1 = Rule("pa1", _pa_update_factory("pa1"))
PA2 = Rule("pa2", _pa_update_factory("pa2"))


# -------------------------------------------------------------------------- CW

def _cw_update(ctx, hyper):
    phi = hyper["phi"]
    score = ctx.score * ctx.y
    var = ctx.variance
    b = 1.0 + 2.0 * phi * score
    disc = torch.clamp(b * b - 8.0 * phi * (score - phi * var), min=0.0)
    gamma = _safe_div(-b + torch.sqrt(disc), 4.0 * phi * var)  # (ref: ConfidenceWeightedUDTF.java:126-136)
    updated = gamma > 0.0
    alpha = torch.where(updated, gamma, 0.0)
    coeff = _lanes(alpha * ctx.y)
    dw = coeff * ctx.cov * ctx.val
    # new_cov = 1/(1/cov + 2*alpha*phi*x^2), written div-safe as
    # cov/(1 + 2*alpha*phi*x^2*cov) (ref: ConfidenceWeightedUDTF.java:161)
    denom = 1.0 + _lanes(2.0 * alpha * phi) * ctx.val * ctx.val * ctx.cov
    dcov = ctx.cov / denom - ctx.cov
    loss = torch.where(ctx.score * ctx.y < 0.0, 1.0, 0.0)
    return RuleOutput(dw=dw, loss=loss, updated=updated, dcov=dcov)


CW = Rule("cw", _cw_update, use_covariance=True)


# ------------------------------------------------------------------------ AROW

def _arow_update_factory(hinge: bool):
    def update(ctx, hyper):
        r = hyper["r"]
        m = ctx.score * ctx.y
        if hinge:  # AROWh: loss = max(0, c - m) (ref: AROWClassifierUDTF.java:190-209)
            loss = torch.clamp(hyper["c"] - m, min=0.0)
            updated = loss > 0.0
            alpha_scale = loss
        else:  # AROW: fire when m < 1, alpha = (1 - m) * beta (ref: :101-108)
            updated = m < 1.0
            alpha_scale = 1.0 - m
            loss = torch.where(m < 0.0, 1.0, 0.0)  # 0-1 loss (ref: :113-116)
        beta = 1.0 / (ctx.variance + r)
        alpha = torch.where(updated, alpha_scale * beta, 0.0)
        cv = ctx.cov * ctx.val
        dw = _lanes(ctx.y * alpha) * cv
        dcov = torch.where(_lanes(updated), _lanes(-beta) * cv * cv, 0.0)  # (ref: :147)
        return RuleOutput(dw=dw, loss=loss, updated=updated, dcov=dcov)

    return update


AROW = Rule("arow", _arow_update_factory(False), use_covariance=True)
AROWH = Rule("arowh", _arow_update_factory(True), use_covariance=True)


# ------------------------------------------------------------------- SCW1/SCW2

def _scw_update_factory(variant: int):
    def update(ctx, hyper):
        phi = hyper["phi"]
        c = hyper["c"]
        m = ctx.score
        var = ctx.variance
        y = ctx.y
        # loss = max(0, phi*sqrt(var) - y*m) (ref: SoftConfideceWeightedUDTF.java:141-146)
        loss = torch.clamp(phi * torch.sqrt(torch.clamp(var, min=0.0)) - y * m,
                           min=0.0)
        sq_phi = phi * phi
        if variant == 1:
            psi = 1.0 + sq_phi / 2.0
            zeta = 1.0 + sq_phi
            alpha_numer = -m * psi + torch.sqrt(torch.clamp(
                (m * m * sq_phi * sq_phi / 4.0) + var * sq_phi * zeta, min=0.0))
            alpha = _safe_div(alpha_numer, var * zeta)
            # NB: the reference applies Math.max(c, alpha) here (the SCW paper
            # uses min); we mirror the reference (ref: SoftConfideceWeightedUDTF.java:186)
            alpha = torch.where(alpha <= 0.0, 0.0, torch.clamp(alpha, min=c))
        else:
            n = var + c / 2.0
            v_phi_phi = var * sq_phi
            v_phi_phi_m = v_phi_phi * m
            term = v_phi_phi_m * m * var + 4.0 * n * var * (n + v_phi_phi)
            gamma = phi * torch.sqrt(torch.clamp(term, min=0.0))
            alpha_numer = -(2.0 * m * n + v_phi_phi_m) + gamma
            alpha_denom = 2.0 * (n * n + n * v_phi_phi)
            alpha = torch.where(alpha_numer <= 0.0, 0.0,
                                _safe_div(alpha_numer, alpha_denom))
        # beta (shared) (ref: SoftConfideceWeightedUDTF.java:197-214)
        beta_numer = alpha * phi
        var_alpha_phi = var * beta_numer
        u = -var_alpha_phi + torch.sqrt(torch.clamp(
            var_alpha_phi * var_alpha_phi + 4.0 * var, min=0.0))
        beta = _safe_div(beta_numer, u / 2.0 + var_alpha_phi)
        updated = (loss > 0.0) & (alpha != 0.0) & (beta != 0.0)
        alpha = torch.where(updated, alpha, 0.0)
        beta = torch.where(updated, beta, 0.0)
        cv = ctx.cov * ctx.val
        dw = _lanes(y * alpha) * cv  # (ref: :263-278)
        dcov = _lanes(-beta) * cv * cv
        return RuleOutput(dw=dw, loss=loss, updated=updated, dcov=dcov)

    return update


SCW1 = Rule("scw1", _scw_update_factory(1), use_covariance=True)
SCW2 = Rule("scw2", _scw_update_factory(2), use_covariance=True)


# ------------------------------------------------------------------ AdaGradRDA

def _adagrad_rda_update(ctx, hyper):
    scaling = hyper["scale"]
    loss = torch.clamp(1.0 - ctx.y * ctx.score, min=0.0)  # hinge (ref: AdaGradRDAUDTF.java:91-95)
    updated = loss > 0.0
    gradient = _lanes(-ctx.y) * ctx.val  # subgradient per feature (ref: :104-113)
    scaled_g = torch.where(_lanes(updated), gradient * scaling, 0.0)
    return RuleOutput(
        dw=torch.zeros_like(ctx.val),
        loss=loss,
        updated=updated,
        dslots={"sum_grad": scaled_g, "sum_sqgrad": scaled_g * scaled_g},
    )


def _adagrad_rda_derive_w(slots, t, hyper):
    # w = -sign(u) * eta * t / sqrt(G) * (|u|/t - lambda), 0 when inside the
    # L1 ball (ref: AdaGradRDAUDTF.java:120-141, incl. the float-overflow
    # scaling trick :112-125). `t` is a scalar for every lane of the call.
    scaling = hyper["scale"]
    sum_grad = slots["sum_grad"] * scaling
    sum_sqgrad = slots["sum_sqgrad"] * scaling
    sign = torch.where(sum_grad > 0.0, 1.0, -1.0)
    mog = sign * sum_grad / t - hyper["lambda"]
    denom = torch.sqrt(torch.clamp(sum_sqgrad, min=1e-30))
    w = -1.0 * sign * hyper["eta"] * t * mog / denom
    return torch.where(mog < 0.0, 0.0, w)


ADAGRAD_RDA = Rule(
    "adagrad_rda",
    _adagrad_rda_update,
    slot_names=("sum_grad", "sum_sqgrad"),
    derive_w=_adagrad_rda_derive_w,
    slot_merge=(("sum_grad", "sum"), ("sum_sqgrad", "sum")),
)


# -------------------------------------------------------------- public train_*

def _train(rule: Rule, hyper: dict, opts: Options, features: FeatureRows, labels,
           options: Optional[str], name: str, **kw) -> TrainedLinearModel:
    cl = opts.parse(options, name)
    hyper = dict(hyper)
    for k in list(hyper):
        if cl.has(k):
            hyper[k] = cl.get_float(k)
    return fit_linear(rule, hyper, cl, features, labels, label_map=binary_label_map, **kw)


def train_perceptron(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    return _train(PERCEPTRON, {}, base_options(), features, labels, options,
                  "train_perceptron", **kw)


def _pa_opts(with_c: bool) -> Options:
    o = base_options()
    if with_c:
        o.add("c", "aggressiveness", True, "Aggressiveness parameter C [default 1.0]",
              default=1.0, type=float)
    return o


def train_pa(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    return _train(PA, {}, _pa_opts(False), features, labels, options, "train_pa", **kw)


def train_pa1(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    return _train(PA1, {"c": 1.0}, _pa_opts(True), features, labels, options, "train_pa1", **kw)


def train_pa2(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    return _train(PA2, {"c": 1.0}, _pa_opts(True), features, labels, options, "train_pa2", **kw)


def _cw_opts(with_c: bool = False) -> Options:
    o = base_options()
    o.add("phi", "confidence", True, "Confidence parameter [default 1.0]", type=float)
    o.add("eta", "hyper_c", True, "Confidence hyperparameter in (0.5, 1] [default 0.85]",
          type=float)
    if with_c:
        o.add("c", "aggressiveness", True, "Aggressiveness parameter C [default 1.0]",
              default=1.0, type=float)
    return o


def train_cw(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    cl = _cw_opts().parse(options, "train_cw")
    hyper = {"phi": _resolve_phi(cl)}
    return fit_linear(CW, hyper, cl, features, labels, label_map=binary_label_map, **kw)


def _arow_opts(with_c: bool) -> Options:
    o = base_options()
    o.add("r", "regularization", True, "Regularization parameter r [default 0.1]",
          default=0.1, type=float)
    if with_c:
        o.add("c", "aggressiveness", True, "Aggressiveness parameter C [default 1.0]",
              default=1.0, type=float)
    return o


def train_arow(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    cl = _arow_opts(False).parse(options, "train_arow")
    hyper = {"r": cl.get_float("r", 0.1)}
    return fit_linear(AROW, hyper, cl, features, labels, label_map=binary_label_map, **kw)


def train_arowh(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    cl = _arow_opts(True).parse(options, "train_arowh")
    hyper = {"r": cl.get_float("r", 0.1), "c": cl.get_float("c", 1.0)}
    return fit_linear(AROWH, hyper, cl, features, labels, label_map=binary_label_map, **kw)


def train_scw(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    cl = _cw_opts(with_c=True).parse(options, "train_scw")
    hyper = {"phi": _resolve_phi(cl), "c": cl.get_float("c", 1.0)}
    return fit_linear(SCW1, hyper, cl, features, labels, label_map=binary_label_map, **kw)


def train_scw2(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    cl = _cw_opts(with_c=True).parse(options, "train_scw2")
    hyper = {"phi": _resolve_phi(cl), "c": cl.get_float("c", 1.0)}
    return fit_linear(SCW2, hyper, cl, features, labels, label_map=binary_label_map, **kw)


def train_adagrad_rda(features: FeatureRows, labels, options: Optional[str] = None, **kw):
    o = base_options()
    o.add("eta", "eta0", True, "Learning rate eta [default 0.1]", default=0.1, type=float)
    o.add("lambda", None, True, "lambda constant of RDA [default 1e-6]",
          default=1e-6, type=float)
    o.add("scale", None, True, "Internal scaling factor [default 100]",
          default=100.0, type=float)
    cl = o.parse(options, "train_adagrad_rda")
    hyper = {
        "eta": cl.get_float("eta", 0.1),
        "lambda": cl.get_float("lambda", 1e-6),
        "scale": cl.get_float("scale", 100.0),
    }
    return fit_linear(ADAGRAD_RDA, hyper, cl, features, labels,
                      label_map=binary_label_map, **kw)
