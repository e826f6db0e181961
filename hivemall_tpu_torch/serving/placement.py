"""Servable placement — where a model's score tables live.

The JAX package makes placement a parameter of ``make_servable`` /
``ServingEngine`` (`hivemall_tpu/serving/placement.py`): single-device,
replicated over a batch axis, or striped over a model axis. The port has
the single-device placement; ``replicated`` and ``model_sharded`` are a
later slice (sharded serving) and raise by name.

``device_byte_budget`` simulates a device memory ceiling: a placement
refuses (``ModelExceedsDeviceBudget``) at load when its resident
score-table bytes exceed the budget, instead of running out of memory at
the first request.
"""

from __future__ import annotations

from typing import Optional, Union


class ModelExceedsDeviceBudget(ValueError):
    """Resident score-table bytes exceed the placement's
    ``device_byte_budget`` — the model does not fit this placement."""


class Placement:
    """Base placement: single-device."""

    kind = "single_device"

    def __init__(self, device_byte_budget: Optional[int] = None) -> None:
        self.device_byte_budget = (None if device_byte_budget is None
                                   else int(device_byte_budget))

    def describe(self) -> dict:
        """The /models placement block (the JAX package's keys)."""
        return {"kind": self.kind, "devices": 1, "mesh_shape": None,
                "batch_shards": 1, "model_shards": 1}

    def check_budget(self, per_device_bytes: int, what: str) -> None:
        if self.device_byte_budget is not None \
                and per_device_bytes > self.device_byte_budget:
            raise ModelExceedsDeviceBudget(
                f"{what}: {per_device_bytes} resident score-table bytes per "
                f"device exceed the {self.kind} placement's budget of "
                f"{self.device_byte_budget} bytes — raise device_byte_budget "
                f"(sharded placement is a later slice of the torch port)")


SingleDevice = Placement

_LATER_SLICE = ("replicated", "model_sharded", "sharded")


def resolve_placement(placement: Union[None, str, Placement]) -> Placement:
    """None | kind-string | Placement -> Placement (the make_servable /
    ServingEngine / ModelRegistry.deploy argument surface)."""
    if placement is None:
        return SingleDevice()
    if isinstance(placement, str):
        if placement == "single_device":
            return SingleDevice()
        if placement in _LATER_SLICE:
            raise ValueError(
                f"placement {placement!r}: sharded and replicated serving "
                f"(serving/sharded.py) are a later slice of the torch port "
                f"(hivemall_tpu_torch); serve single_device")
        raise ValueError(
            f"unknown placement {placement!r}; one of "
            f"{sorted(('single_device',) + _LATER_SLICE)}")
    if isinstance(placement, Placement):
        return placement
    raise TypeError(f"placement must be None, a kind string, or a "
                    f"Placement, got {type(placement).__name__}")
