"""Known-negative G003 cases: pinned or promotion-safe constants.

# graftcheck: dtype-module
"""
import torch


def _pin(value, like):
    return torch.as_tensor(value, dtype=like.dtype)


def pinned_half_squared(z):
    return _pin(0.5, z) * z * z


def call_arg_literal(x):
    return torch.clamp(x, min=1.0)  # call args follow weak promotion: fine


def integer_literals(t):
    return t / 2 + 1  # int literals never widen a float dtype


def comparison_threshold(p):
    return torch.where(p > -100.0, p, 0.0)


def explicit_f32(xs):
    return torch.as_tensor(xs, dtype=torch.float32)
