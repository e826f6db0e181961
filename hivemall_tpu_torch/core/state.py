"""Model state: the device-resident "parameter store".

Mirrors the reference model layer (ref: core/.../model/DenseModel.java:36-52):
a dense weight table plus optional covariance and optimizer slot tables, all
fixed-shape device tensors — DenseModel's struct-of-arrays layout maps 1:1.
The `touched` bitmap reproduces the close() behavior of emitting only
weights actually updated (ref: BinaryOnlineClassifierUDTF.java:249-298).

`step` is a host integer here (the JAX state keeps an int32 device scalar):
the kernel takes it as a launch argument, and keeping it on the host saves a
device-to-host copy per block. `linear_state_from_numpy` /
`linear_state_to_numpy` carry a state between the two packages field by
field, so both can start from one warm state.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass
class LinearState:
    """State for all hashed-feature linear learners (binary + regression)."""

    weights: torch.Tensor  # [D] float32 (bf16 above 2^24 dims)
    covars: Optional[torch.Tensor]  # [D], init 1.0 (covariance learners)
    slots: Dict[str, torch.Tensor]  # per-feature optimizer aux, init 0.0
    touched: torch.Tensor  # [D] int8 — 1 where an update landed
    step: int  # processed-example counter
    globals: Dict[str, torch.Tensor]  # 0-d float32 running stats (e.g. target
    # stddev, ref: common/OnlineVariance.java used by PA1a/PA2a/AROWe2)

    @property
    def dims(self) -> int:
        return self.weights.shape[0]

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def replace(self, **changes) -> "LinearState":
        return dataclasses.replace(self, **changes)


def init_linear_state(
    dims: int,
    use_covariance: bool = False,
    slot_names: tuple = (),
    global_names: tuple = (),
    dtype=torch.float32,
    initial_weights: Optional[np.ndarray] = None,
    initial_covars: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> LinearState:
    """Create a zeroed model (covariance initialized to 1.0, the implicit
    default for absent entries in the reference, ref: AROWClassifierUDTF.java:140).

    `initial_weights`/`initial_covars` support warm start, mirroring
    `-loadmodel` (ref: LearnerBaseUDTF.java:215-333). They are numpy arrays
    or tensors; a bf16 tensor loaded at `dtype=torch.bfloat16` stays bf16
    (numpy has no bf16, so it never passes through numpy).
    """
    dev = resolve_device(device)

    def table(x):
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return t.to(device=dev, dtype=dtype, copy=True)

    if initial_weights is not None:
        weights = table(initial_weights)
    else:
        weights = torch.zeros((dims,), dtype=dtype, device=dev)
    covars = None
    if use_covariance:
        if initial_covars is not None:
            covars = table(initial_covars)
        else:
            covars = torch.ones((dims,), dtype=dtype, device=dev)
    slots = {name: torch.zeros((dims,), dtype=torch.float32, device=dev)
             for name in slot_names}
    if initial_weights is not None:
        # from the caller's values, before any narrowing to `dtype`
        w0 = initial_weights if torch.is_tensor(initial_weights) \
            else torch.as_tensor(np.asarray(initial_weights))
        touched = (w0.to(dev) != 0).to(torch.int8)
    else:
        touched = torch.zeros((dims,), dtype=torch.int8, device=dev)
    return LinearState(
        weights=weights,
        covars=covars,
        slots=slots,
        touched=touched,
        step=0,
        globals={name: torch.zeros((), dtype=torch.float32, device=dev)
                 for name in global_names},
    )


def linear_state_from_numpy(d: dict, device: DeviceLike = None) -> LinearState:
    """Build a state from the JAX state's fields as numpy arrays:
    ``weights``, ``covars`` (or None), ``slots`` {name: [D]}, ``touched``,
    ``step`` and ``globals`` {name: scalar}. Every tensor is a fresh copy."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    covars = d.get("covars")
    return LinearState(
        weights=t(d["weights"]),
        covars=None if covars is None else t(covars),
        slots={k: t(v) for k, v in d.get("slots", {}).items()},
        touched=t(np.asarray(d["touched"], dtype=np.int8)),
        step=int(d.get("step", 0)),
        globals={k: t(np.asarray(v, dtype=np.float32))
                 for k, v in d.get("globals", {}).items()},
    )


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor; bf16 comes back as float32."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy().copy()


def linear_state_to_numpy(state: LinearState) -> dict:
    """The inverse of `linear_state_from_numpy`: numpy copies of every
    field (bf16 tables come back as float32; ``step`` as np.int32, the JAX
    state's type)."""
    return {
        "weights": _numpy(state.weights),
        "covars": None if state.covars is None else _numpy(state.covars),
        "slots": {k: _numpy(v) for k, v in state.slots.items()},
        "touched": _numpy(state.touched),
        "step": np.int32(state.step),
        "globals": {k: _numpy(v) for k, v in state.globals.items()},
    }


def model_rows(state: LinearState, filter_zero: bool = False):
    """Dump the model as (feature, weight[, covar]) numpy arrays over
    touched entries — the close() model emission
    (ref: BinaryOnlineClassifierUDTF.java:254-291)."""
    touched = _numpy(state.touched) != 0
    weights = _numpy(state.weights)
    if filter_zero:
        touched &= weights != 0.0
    feats = np.nonzero(touched)[0].astype(np.int64)
    if state.covars is not None:
        return feats, weights[feats], _numpy(state.covars)[feats]
    return feats, weights[feats]
