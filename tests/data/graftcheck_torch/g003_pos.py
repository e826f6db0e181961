"""Known-positive G003 dtype-drift cases.  # graftcheck: dtype-module"""
import torch
import numpy as np


def unpinned_eta(eta0, t):
    denom = 1.0 + t  # EXPECT: G003
    return eta0 / denom


def unpinned_half_squared(z):
    return 0.5 * z * z  # EXPECT: G003


def f64_staging(xs):
    return torch.as_tensor(xs, dtype=torch.float64)  # EXPECT: G003


def f64_cast(w):
    return w.double()  # EXPECT: G003


def f64_scalar(x):
    return torch.tensor(x, dtype=torch.double)  # EXPECT: G003
