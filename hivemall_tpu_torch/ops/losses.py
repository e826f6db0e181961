"""Loss functions as element-wise torch ops — the port of
`hivemall_tpu/ops/losses.py`.

Mirrors hivemall.common.LossFunctions (ref: core/.../common/LossFunctions.java:26-379):
SquaredLoss, LogLoss, HingeLoss, SquaredHingeLoss, QuantileLoss,
EpsilonInsensitiveLoss — each with `loss(p, y)` and `dloss(p, y)`.

Every function is element-wise over tensors of any shape and device (the
reference computes them per row). Numbers and numpy arrays are taken too
and become tensors first. Binary losses take y in {-1, +1}. Result dtypes
follow the JAX package's: a literal takes the operand's float dtype
(`_pin`), so bf16 in gives bf16 out, and int operands compute in the
default float dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LossFunction(NamedTuple):
    name: str
    loss: Callable
    dloss: Callable
    is_binary: bool


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def _pin(value, like) -> torch.Tensor:
    """A literal as a 0-d tensor of the operand's dtype, so the constant
    follows the data and never promotes a bf16 expression. Non-float
    operands (int labels through the public loss API) pin to the default
    float dtype instead, as a bare float literal would promote them."""
    like = _t(like)
    dt = like.dtype
    if not dt.is_floating_point:
        dt = torch.get_default_dtype()
    return torch.tensor(value, dtype=dt, device=like.device)


def _float(x: torch.Tensor) -> torch.Tensor:
    """x itself when floating point, else in the default float dtype (the
    promotion jnp's transcendental functions apply to ints)."""
    return x if x.dtype.is_floating_point else x.to(torch.get_default_dtype())


def _squared_loss(p, y):
    z = _t(p) - _t(y)
    return _pin(0.5, z) * z * z


def _squared_dloss(p, y):
    return _t(p) - _t(y)


def _log_loss(p, y):
    # log(1 + exp(-y*p)), numerically stable (ref: LossFunctions.java
    # LogLoss.loss, which branches at |z| > 18): jnp.logaddexp(0, -z), whose
    # torch twin is logaddexp against a zero (F.softplus switches to its
    # linear branch past a threshold and answers differently)
    z = _float(_t(y) * _t(p))
    return torch.logaddexp(torch.zeros_like(z), -z)


def _log_dloss(p, y):
    y = _t(y)
    z = y * _t(p)
    return -y / (torch.exp(z) + _pin(1.0, z))


def _hinge_loss(p, y, threshold=1.0):
    return torch.clamp(threshold - _t(y) * _t(p), min=0.0)


def _hinge_dloss(p, y, threshold=1.0):
    y = _t(y)
    return torch.where(threshold - y * _t(p) > 0.0, -y, 0.0)


def _squared_hinge_loss(p, y):
    p = _t(p)
    d = torch.clamp(_pin(1.0, p) - _t(y) * p, min=0.0)
    return d * d


def _squared_hinge_dloss(p, y):
    p, y = _t(p), _t(y)
    d = _pin(1.0, p) - y * p
    return torch.where(d > 0.0, _pin(-2.0, d) * d * y, 0.0)


def _quantile_loss(p, y, tau=0.5):
    e = _t(y) - _t(p)
    return torch.where(e > 0.0, tau * e, -(_pin(1.0, e) - tau) * e)


def _quantile_dloss(p, y, tau=0.5):
    e = _t(y) - _t(p)
    return torch.where(e == 0.0, 0.0,
                       torch.where(e > 0.0, -tau, _pin(1.0, e) - tau))


def _eps_insensitive_loss(p, y, epsilon=0.1):
    return torch.clamp(torch.abs(_t(y) - _t(p)) - epsilon, min=0.0)


def _eps_insensitive_dloss(p, y, epsilon=0.1):
    p, y = _t(p), _t(y)
    return torch.where(y - p > epsilon, -1.0,
                       torch.where(p - y > epsilon, 1.0, 0.0))


SquaredLoss = LossFunction("SquaredLoss", _squared_loss, _squared_dloss, False)
LogLoss = LossFunction("LogLoss", _log_loss, _log_dloss, True)
HingeLoss = LossFunction("HingeLoss", _hinge_loss, _hinge_dloss, True)
SquaredHingeLoss = LossFunction("SquaredHingeLoss", _squared_hinge_loss,
                                _squared_hinge_dloss, True)
QuantileLoss = LossFunction("QuantileLoss", _quantile_loss, _quantile_dloss,
                            False)
EpsilonInsensitiveLoss = LossFunction(
    "EpsilonInsensitiveLoss", _eps_insensitive_loss, _eps_insensitive_dloss,
    False)

_REGISTRY = {
    f.name.lower(): f
    for f in (SquaredLoss, LogLoss, HingeLoss, SquaredHingeLoss, QuantileLoss,
              EpsilonInsensitiveLoss)
}


def get_loss_function(name: str) -> LossFunction:
    """By-name lookup, case-insensitive (ref: LossFunctions.getLossFunction,
    LossFunctions.java:33-46)."""
    f = _REGISTRY.get(name.lower())
    if f is None:
        raise ValueError(f"Unsupported loss type: {name}")
    return f


def logistic_loss(target, predicted):
    """logisticLoss(target, predicted) for probability targets
    (ref: LossFunctions.java:381-392)."""
    target, predicted = _t(target), _t(predicted)
    one = _pin(1.0, predicted)
    return torch.where(predicted > -100.0,
                       target - one / (one + torch.exp(-predicted)), target)
