"""Servable placement — where a model's score tables live (the port of
``hivemall_tpu/serving/placement.py``).

Placement is a parameter of ``make_servable`` / ``ServingEngine`` /
``ModelRegistry.deploy``, not a property of the servable classes:

- ``SingleDevice()``   — the default; the per-family servables of
  serving/engine.py, every table on one device;
- ``Replicated()``     — every device holds the full tables; a request
  batch splits along the ``batch`` axis, each shard scored on its own
  replica (throughput from idle devices, no size headroom);
- ``ModelSharded(n)``  — the tables stripe along the feature axis over the
  ``model`` axis (serving/sharded.py); batches optionally split along
  ``batch``: a table bigger than one device serves.

**One process over a grid of local devices.** The JAX package's serving
placement is single-controller: one process builds a ``(batch, model)``
mesh over its devices and places the striped tables on it with
``NamedSharding``. The port keeps that shape: ``mesh()`` is the
``[batch_shards][model_shards]`` grid of ``torch.device``s, each stripe is
a tensor on its own device, and JAX's ``psum`` over the model axis is the
sum of the stripes' partials on the batch row's lead device. It is not
the process-per-rank mesh of ``parallel/`` (training and recovery): an
HTTP server whose every dispatch had to be broadcast to follower ranks has
no counterpart in the JAX package. A device may repeat in the grid
(``devices=[torch.device("cuda:0")] * 4``), the counterpart of the
reference tests' forced host device count: stripes then share the card.

``Replicated`` IS ``ModelSharded`` with an ``(n, 1)`` grid: a stripe that
spans the whole table is a replica. One implementation, three placements.

``device_byte_budget`` simulates a device memory ceiling: a placement
refuses (``ModelExceedsDeviceBudget``) at load when its per-device
resident score-table bytes exceed the budget — checked before anything is
placed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

# The serving grid's axes (distinct from the training mesh's
# "workers" / "shards": a serving grid is request-batch x table-stripe)
BATCH_AXIS = "batch"
MODEL_AXIS = "model"


class ModelExceedsDeviceBudget(ValueError):
    """Per-device resident score-table bytes exceed the placement's
    ``device_byte_budget`` — the model does not fit this placement; shard
    it (or raise the budget)."""


class Placement:
    """Base placement: single-device."""

    kind = "single_device"

    def __init__(self, device_byte_budget: Optional[int] = None) -> None:
        self.device_byte_budget = (None if device_byte_budget is None
                                   else int(device_byte_budget))

    @property
    def batch_shards(self) -> int:
        return 1

    @property
    def model_shards(self) -> int:
        return 1

    def describe(self) -> dict:
        """The /models placement block (the JAX package's keys)."""
        return {"kind": self.kind, "devices": 1, "mesh_shape": None,
                "batch_shards": self.batch_shards,
                "model_shards": self.model_shards}

    def check_budget(self, per_device_bytes: int, what: str) -> None:
        if self.device_byte_budget is not None \
                and per_device_bytes > self.device_byte_budget:
            raise ModelExceedsDeviceBudget(
                f"{what}: {per_device_bytes} resident score-table bytes per "
                f"device exceed the {self.kind} placement's budget of "
                f"{self.device_byte_budget} bytes — serve it model-sharded "
                f"(ModelSharded) or raise device_byte_budget")


SingleDevice = Placement


def _cuda_devices() -> List[torch.device]:
    """Every CUDA device, or a RuntimeError without one (the port's entry
    points run on the card unless the caller names another device)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a sharded or replicated placement defaults to "
            "every CUDA device; pass devices=[torch.device('cpu')] * n to "
            "place on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ModelSharded(Placement):
    """Stripe the score tables over ``model_shards`` devices; split request
    batches over ``batch_shards``. The grid is ``(batch, model)`` over the
    first ``batch_shards * model_shards`` of ``devices`` (None: every CUDA
    device, raising without one). ``model_shards=None`` takes every device
    the batch axis leaves."""

    kind = "model_sharded"

    def __init__(self, model_shards: Optional[int] = None, *,
                 batch_shards: int = 1,
                 devices: Optional[Sequence] = None,
                 device_byte_budget: Optional[int] = None) -> None:
        super().__init__(device_byte_budget)
        if model_shards is not None and model_shards < 1:
            raise ValueError(f"model_shards must be >= 1, got {model_shards}")
        if batch_shards < 1 or (batch_shards & (batch_shards - 1)):
            # batch buckets are powers of two (engine.batch_buckets), so a
            # non-power-of-two batch axis could never divide them evenly
            raise ValueError(
                f"batch_shards must be a power of two, got {batch_shards}")
        self._model_shards = model_shards
        self._batch_shards = int(batch_shards)
        self._devices = None if devices is None \
            else [torch.device(d) for d in devices]
        self._mesh = None

    def devices(self) -> List[torch.device]:
        if self._devices is None:
            self._devices = _cuda_devices()
        return self._devices

    @property
    def batch_shards(self) -> int:
        return self._batch_shards

    @property
    def model_shards(self) -> int:
        if self._model_shards is None:
            self._model_shards = max(1, len(self.devices())
                                     // self._batch_shards)
        return self._model_shards

    def mesh(self) -> List[List[torch.device]]:
        """The ``[batch_shards][model_shards]`` grid of devices — built
        once, cached (every servable of this placement places onto the
        same grid)."""
        if self._mesh is None:
            devs = self.devices()
            b, m = self.batch_shards, self.model_shards
            if len(devs) < b * m:
                raise ValueError(
                    f"a ({b}, {m}) serving grid needs {b * m} devices, got "
                    f"{len(devs)}")
            self._mesh = [devs[r * m:(r + 1) * m] for r in range(b)]
        return self._mesh

    def describe(self) -> dict:
        shape = (self.batch_shards, self.model_shards)
        return {"kind": self.kind,
                "devices": shape[0] * shape[1],
                "mesh_shape": list(shape),
                "mesh_axes": [BATCH_AXIS, MODEL_AXIS],
                "batch_shards": self.batch_shards,
                "model_shards": self.model_shards}


class Replicated(ModelSharded):
    """Full tables on every device, batches split across all of them — the
    (n, 1) corner of the sharded placement (see module docstring)."""

    kind = "replicated"

    def __init__(self, batch_shards: Optional[int] = None, *,
                 devices: Optional[Sequence] = None,
                 device_byte_budget: Optional[int] = None) -> None:
        super().__init__(model_shards=1, batch_shards=batch_shards or 1,
                         devices=devices,
                         device_byte_budget=device_byte_budget)
        # None: decided from the device count at first use, so a kind
        # string resolves without touching a device
        self._batch_shards = batch_shards

    @property
    def batch_shards(self) -> int:
        if self._batch_shards is None:
            # the largest power of two that fits the device count, capped
            # at the engine's default min_batch_bucket (8): every batch
            # bucket must split evenly over the batch axis
            n = len(self.devices())
            self._batch_shards = min(1 << (max(1, n).bit_length() - 1), 8)
        return self._batch_shards


_BY_NAME = {"single_device": SingleDevice, "replicated": Replicated,
            "model_sharded": ModelSharded, "sharded": ModelSharded}


def resolve_placement(placement: Union[None, str, Placement]) -> Placement:
    """None | kind-string | Placement -> Placement (the make_servable /
    ServingEngine / ModelRegistry.deploy argument surface). A kind string
    names a placement over every CUDA device."""
    if placement is None:
        return SingleDevice()
    if isinstance(placement, str):
        try:
            return _BY_NAME[placement]()
        except KeyError:
            raise ValueError(
                f"unknown placement {placement!r}; one of "
                f"{sorted(_BY_NAME)}") from None
    if isinstance(placement, Placement):
        return placement
    raise TypeError(f"placement must be None, a kind string, or a "
                    f"Placement, got {type(placement).__name__}")
