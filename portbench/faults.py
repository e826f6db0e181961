"""Faults planted in the timed path, under the trainer the window calls,
for showing that the check catches them (`tests/test_portbench_faults.py`
on the CPU; `control.py --faults` at a cell's own size on the card):

- `unchanged`: the step returns the state it was given;
- `half`: the step trains the first half of each block only;
- `altered`: the step's answer is altered where it is produced: the
  weights of each block's first row's features come out 1.0 higher.

The exact scan's step is `hivemall_tpu_torch.kernels.linear_scan.
linear_scan`, which the `-pallas` fit calls for every block (the CUDA
kernels on the card, their plain torch version on the CPU).
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")


def _altered(state, indices):
    first = indices[0][(indices[0] >= 0) & (indices[0] < state.dims)]
    state.weights[first.long()] += 1.0
    return state


@contextlib.contextmanager
def planted(fault: str):
    """The scan step broken by `fault` while the context is open."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    import torch
    from hivemall_tpu_torch.kernels import linear_scan as module

    real = module.linear_scan

    def step(rule, hyper, state, indices, values, labels, **kw):
        if fault == "unchanged":
            return state, torch.zeros(labels.shape[0], device=labels.device)
        if fault == "half":
            h = indices.shape[0] // 2
            return real(rule, hyper, state, indices[:h], values[:h],
                        labels[:h], **kw)
        new_state, losses = real(rule, hyper, state, indices, values, labels,
                                 **kw)
        return _altered(new_state, indices), losses

    module.linear_scan = step
    try:
        yield
    finally:
        module.linear_scan = real
