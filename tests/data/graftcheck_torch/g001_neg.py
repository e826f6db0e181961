"""Known-negative G001 cases: trace-safe control flow."""
from functools import partial

import torch
import torch.nn.functional as F


@torch.compile
def structure_check(cov, w):
    if cov is not None:  # pytree structure: static under trace
        return w * cov
    return w


@torch.compile
def static_branch(x, mode: str):
    if mode == "relu":  # static arg: a Python constant per trace
        return F.relu(x)
    return x


def make_scaled_step(scale_by_two):
    def scaled_step(x):
        if scale_by_two:  # closure var: Python constant at trace time
            return x * 2
        return x

    return torch.compile(scaled_step)


@torch.compile
def data_dependent_value_flow(x):
    return torch.where(x > 0, x, -x)


@torch.compile
def membership_on_structure(slots, deltas):
    out = dict(slots)
    for k in ("g", "u"):
        if k in deltas:  # dict-key membership: static structure
            out[k] = slots[k] + deltas[k]
    return out
