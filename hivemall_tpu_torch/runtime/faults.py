"""Deterministic fault injection — the chaos harness behind the port's
elastic checkpoints and its continuous pipeline; a port of
`hivemall_tpu/runtime/faults.py`.

Reliability claims need reproducible failures: a seeded ``FaultPlan`` names
exactly which fault fires at which step or checkpoint write, and
``inject(plan)`` arms it through monkeypatchable hooks — the driver's
per-step hook plus the two seams io/checkpoint.py exposes on the write path
(``crash_point`` between write and rename, ``checkpoint_written`` after a
successful publish). The same plan replays bit for bit: the corruption
byte offset comes from the plan's seed, never the wall clock, and
``FaultPlan.generate`` draws the JAX package's plan for the same arguments.

Fault kinds:

- ``device_loss``     — step hook raises WorkerLost(n_lost);
- ``transient_step``  — step hook raises TransientStepError once: a
                        recoverable hiccup; same topology, resume;
- ``crash_mid_write`` — the checkpoint writer dies between the payload
                        write and the atomic rename (CrashMidWrite out of
                        io/checkpoint.crash_point); the previous checkpoint
                        must survive intact;
- ``corrupt``         — after the Nth successful write, flip a byte in the
                        middle of the file (digest / zip-CRC mismatch on
                        load -> loud fallback to ``.prev``);
- ``truncate``        — after the Nth successful write, truncate the file
                        to half (unreadable zip -> loud fallback).

Single-threaded by design: one injector arms per driver loop (``inject``
refuses to nest). An injected fault is a Python exception raised on the
host before a step or around a file write; it never touches the device.

# graftcheck: serving-module
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..io import checkpoint as io_checkpoint
from .tracing import TRACER

FAULT_KINDS = ("device_loss", "transient_step", "crash_mid_write",
               "corrupt", "truncate")


class InjectedFault(Exception):
    """Base of every injected failure (so drivers can catch the family)."""


class WorkerLost(InjectedFault):
    """A worker/device vanished mid-run — under synchronous SPMD the whole
    job fails; carry how many devices the 'fleet' lost so the driver can
    rebuild the mesh over the survivors."""

    def __init__(self, n_lost: int = 1, step: Optional[int] = None):
        super().__init__(f"worker lost at step {step}: {n_lost} device(s)")
        self.n_lost = int(n_lost)
        self.step = step


class TransientStepError(InjectedFault):
    """A recoverable step failure (spurious collective timeout, preempt
    warning): resume on the SAME topology from the last checkpoint."""


class CrashMidWrite(InjectedFault):
    """The process 'died' on the checkpoint write path — between the
    payload write and the atomic rename."""


@dataclass(frozen=True)
class Fault:
    """One planned fault. ``at_step`` indexes the driver's step loop
    (fires BEFORE that step runs); ``at_write`` counts successful-or-
    attempted checkpoint writes (1-based) for the write-path kinds."""

    kind: str
    at_step: Optional[int] = None
    at_write: Optional[int] = None
    n_lost: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        step_kinds = ("device_loss", "transient_step")
        if self.kind in step_kinds and self.at_step is None:
            raise ValueError(f"{self.kind} needs at_step")
        if self.kind not in step_kinds and self.at_write is None:
            raise ValueError(f"{self.kind} needs at_write")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, fully-explicit fault schedule. The seed drives the
    corruption byte offsets (and ``generate``'s placement) so the same
    plan replays the same run, byte for byte."""

    seed: int
    faults: Tuple[Fault, ...]

    @classmethod
    def generate(cls, seed: int, n_steps: int, kinds=("device_loss",),
                 n_faults: int = 1, checkpoint_every: int = 8,
                 max_lost: int = 1) -> "FaultPlan":
        """Seeded random placement: step faults land uniformly in
        [1, n_steps); write faults land on write 2+ (the first write has
        no ``.prev`` to fall back to — corrupting it tests nothing but a
        cold start). Deterministic for a given argument tuple."""
        rng = np.random.RandomState(seed)
        out: List[Fault] = []
        n_writes = max(2, n_steps // max(1, checkpoint_every))
        for _ in range(n_faults):
            kind = kinds[int(rng.randint(len(kinds)))]
            if kind in ("device_loss", "transient_step"):
                out.append(Fault(
                    kind, at_step=int(rng.randint(1, max(2, n_steps))),
                    n_lost=int(rng.randint(1, max_lost + 1))))
            else:
                out.append(Fault(kind,
                                 at_write=int(rng.randint(2, n_writes + 1))))
        return cls(seed=seed, faults=tuple(out))


@dataclass
class Injector:
    """Armed instance of a plan: counts steps and checkpoint writes, fires
    each fault exactly once, and keeps a log of what fired (mirrored as
    ``fault.injected`` tracer instants so restarts are attributable in the
    Perfetto timeline next to the driver's ``recovery.restore`` spans)."""

    plan: FaultPlan
    fired: List[dict] = field(default_factory=list)
    _done: set = field(default_factory=set)
    _writes: int = 0

    def _fire(self, i: int, fault: Fault, **extra) -> None:
        self._done.add(i)
        record = {"kind": fault.kind, "at_step": fault.at_step,
                  "at_write": fault.at_write, **extra}
        self.fired.append(record)
        TRACER.instant("fault.injected", args=record)

    def on_step(self, step_idx: int) -> None:
        """Driver seat: call before each training step."""
        for i, f in enumerate(self.plan.faults):
            if i in self._done or f.at_step != step_idx:
                continue
            if f.kind == "device_loss":
                self._fire(i, f, step=step_idx)
                raise WorkerLost(n_lost=f.n_lost, step=step_idx)
            if f.kind == "transient_step":
                self._fire(i, f, step=step_idx)
                raise TransientStepError(
                    f"injected transient failure at step {step_idx}")

    # -- io/checkpoint.py write-path seams -----------------------------------

    def on_crash_point(self, tag: str, path: str) -> None:
        """Patched over io/checkpoint.crash_point: the write counter ticks
        on the first crash point of each save, and a planned
        crash_mid_write for that write index kills the writer there —
        AFTER the payload write, BEFORE the rename."""
        if tag == "elastic.after_write":
            self._writes += 1
        for i, f in enumerate(self.plan.faults):
            if i in self._done or f.kind != "crash_mid_write":
                continue
            if f.at_write == self._writes:
                self._fire(i, f, tag=tag, path=path)
                raise CrashMidWrite(f"injected crash at {tag} "
                                    f"(write {self._writes}) for {path}")

    def on_checkpoint_written(self, path: str) -> None:
        """Patched over io/checkpoint.checkpoint_written: rot the file the
        plan says to rot. The byte offset is seeded from (plan.seed,
        write index) — deterministic, replayable corruption."""
        for i, f in enumerate(self.plan.faults):
            if i in self._done or f.kind not in ("corrupt", "truncate"):
                continue
            if f.at_write != self._writes:
                continue
            size = os.path.getsize(path)
            if f.kind == "truncate":
                self._fire(i, f, path=path, truncated_to=size // 2)
                with open(path, "r+b") as fh:
                    fh.truncate(size // 2)
            else:
                rng = np.random.RandomState(
                    (self.plan.seed * 1_000_003 + self._writes) % (2**31))
                # land inside the compressed payload (skip the zip header)
                off = int(rng.randint(size // 4, max(size // 4 + 1,
                                                     size - 64)))
                self._fire(i, f, path=path, flipped_offset=off)
                with open(path, "r+b") as fh:
                    fh.seek(off)
                    b = fh.read(1)
                    fh.seek(off)
                    fh.write(bytes([b[0] ^ 0xFF]))


_ACTIVE: Optional[Injector] = None


def active() -> Optional[Injector]:
    """The armed injector, if any — the driver's step hook reads it."""
    return _ACTIVE


def step_hook(step_idx: int) -> None:
    """run_elastic's per-step seat: no-op unless a plan is armed."""
    if _ACTIVE is not None:
        _ACTIVE.on_step(step_idx)


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm a plan: installs the injector and patches the io/checkpoint
    write-path hooks for the extent of the block. Yields the Injector so
    callers can assert on ``injector.fired``. Refuses to nest — one
    driver, one plan."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a fault plan is already armed; inject() does "
                           "not nest")
    injector = Injector(plan)
    saved = (io_checkpoint.crash_point, io_checkpoint.checkpoint_written)
    io_checkpoint.crash_point = injector.on_crash_point
    io_checkpoint.checkpoint_written = injector.on_checkpoint_written
    _ACTIVE = injector
    try:
        yield injector
    finally:
        _ACTIVE = None
        io_checkpoint.crash_point, io_checkpoint.checkpoint_written = saved
