"""Known-negative G018 cases: pinned dtypes and trusted forms.

# graftcheck: serving-module
"""
import torch
import numpy as np


def pinned_payload(instances):
    return torch.as_tensor(instances, dtype=torch.float32)


def pinned_zeros(n):
    return np.zeros(n, np.float32)


def pinned_kwarg(n):
    return np.zeros((n, 4), dtype=np.int32)


def torch_defaults_are_f32(n):
    return torch.zeros((n,))


def follows_input(x):
    return torch.as_tensor(x)  # dtype follows the input: trusted


def like_follows_input(x):
    return torch.zeros_like(x)


def int_fill(n):
    return torch.as_tensor(np.full((n,), 0))  # int fill: no float64 default


def dynamic_args(shape_args):
    return torch.as_tensor(np.zeros(*shape_args))  # *args may carry the dtype: trusted
