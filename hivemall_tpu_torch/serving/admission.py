"""Admission-control primitives for overload-grade serving.

Host-only Python: a copy of the JAX package's `serving/admission.py`.

One queue and one fixed 503 threshold degrade by collapse: past saturation
every request waits the full queue, then times out, and goodput falls off a
cliff. The production alternative (PAPERS.md ads-infra paper; AdaBatch for
the batching-window argument) is *predictable* degradation, built from four
pieces this module provides to `serving/batcher.py`:

- **priority classes** (`PRIORITY_NAMES`, `priority_class`): requests are
  high / normal / low; queues drain strictly-high-first with a bounded
  starvation escape for the lower classes;
- **admission quotas** (`quota_rows`): each class may fill the queue only
  up to its fraction of ``max_queue_rows`` — low-priority work is refused
  (503, ``reason="quota"``) while the queue still has headroom for high;
- **load shedding** (`ShedLowPriority`): when a higher class needs room,
  the newest lowest-priority queued requests are evicted (503,
  ``reason="shed"``, `Retry-After` from the live drain-rate estimate) —
  degradation drops the least valuable work first instead of everything
  at once;
- **deadline expiry** (`DeadlineExpired`): requests carry a ``deadline_ms``
  budget and expire *in the queue* (504) before wasting a dispatch slot —
  under sustained overload the queue self-cleans instead of serving
  answers nobody is waiting for anymore.

`AIMDController` is the adaptive-batching half: an additive-increase /
multiplicative-decrease controller that widens the batching window
(``max_delay``/``max_batch``) toward its caps while a backlog persists and
decays it back to baseline when the queue goes idle — light-load latency
stays pinned at the base window, overload throughput gets the wide one.
"""

from __future__ import annotations

from typing import Optional

# class 0 drains first; the tuple order IS the drain (and shed-survival)
# order. Three classes cover the production taxonomy (interactive /
# default / batch) without inviting priority inflation.
PRIORITY_NAMES = ("high", "normal", "low")


def priority_class(value) -> int:
    """Normalize a priority (class index or name, e.g. from an
    ``x-priority`` header) to its class index. Raises ValueError on
    anything else — the server maps that to a 400."""
    if isinstance(value, bool):
        raise ValueError(f"invalid priority {value!r}")
    if isinstance(value, int):
        if 0 <= value < len(PRIORITY_NAMES):
            return value
        raise ValueError(
            f"priority class {value} out of range 0..{len(PRIORITY_NAMES) - 1}")
    if isinstance(value, str):
        v = value.strip().lower()
        if v in PRIORITY_NAMES:
            return PRIORITY_NAMES.index(v)
        if v.isdigit() and int(v) < len(PRIORITY_NAMES):
            return int(v)
    raise ValueError(f"invalid priority {value!r} "
                     f"(expected one of {PRIORITY_NAMES} or 0..2)")


def priority_name(cls: int) -> str:
    return PRIORITY_NAMES[cls]


class QueueFull(RuntimeError):
    """Admission control: queue at capacity — caller should shed (503).

    ``reason`` distinguishes the admission-time quota refusal ("quota")
    from an in-queue eviction ("shed", see ShedLowPriority);
    ``retry_after_s`` is the batcher's live drain-time estimate, surfaced
    as the HTTP ``Retry-After`` header so clients back off for a useful
    interval instead of a constant."""

    def __init__(self, msg: str, *, reason: str = "quota",
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


class ShedLowPriority(QueueFull):
    """An accepted request was evicted from the queue to admit
    higher-priority work (503 + Retry-After, ``reason="shed"``)."""

    def __init__(self, msg: str, *,
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(msg, reason="shed", retry_after_s=retry_after_s)


class DeadlineExpired(RuntimeError):
    """The request's ``deadline_ms`` budget elapsed while it was still
    queued; it never reached dispatch (504, shed-counted)."""


class AIMDController:
    """Additive-increase / multiplicative-decrease batching-window control.

    The window starts at the base ``(delay, batch)`` pair. Every dispatch
    that leaves more than one batch of backlog behind widens both
    additively toward their caps (AdaBatch's grow-the-batch-under-load
    argument applied to inference micro-batching); every time the worker
    finds the queue empty both decay multiplicatively back toward base.
    Light load therefore serves at the base window — latency pinned —
    while sustained overload earns the wide window's amortization.

    Thread discipline: mutated ONLY under the owning batcher's condition
    variable (the worker updates it while holding ``_cv``); `state()`
    reads are taken under the same lock via ``DynamicBatcher``'s
    accessors. With equal base and cap (the defaults) the controller is a
    fixed window — exact legacy behavior.
    """

    def __init__(self, *, base_delay_s: float, cap_delay_s: float,
                 base_batch: int, cap_batch: int,
                 add_delay_s: Optional[float] = None,
                 add_batch: Optional[int] = None,
                 decay: float = 0.5) -> None:
        self.base_delay_s = float(base_delay_s)
        self.cap_delay_s = max(float(cap_delay_s), self.base_delay_s)
        self.base_batch = int(base_batch)
        self.cap_batch = max(int(cap_batch), self.base_batch)
        # one base-delay step per overloaded dispatch reaches the cap in a
        # few batches; the batch step is a quarter of base so both knobs
        # arrive at their caps on a similar schedule
        self.add_delay_s = float(add_delay_s) if add_delay_s is not None \
            else max(self.base_delay_s, 1e-4)
        self.add_batch = int(add_batch) if add_batch is not None \
            else max(1, self.base_batch // 4)
        self.decay = float(decay)
        self.delay_s = self.base_delay_s
        self.batch_rows = self.base_batch

    @property
    def adaptive(self) -> bool:
        return (self.cap_delay_s > self.base_delay_s
                or self.cap_batch > self.base_batch)

    def on_take(self, depth_rows_after: int) -> None:
        """One batch was dispatched leaving ``depth_rows_after`` queued;
        a backlog deeper than the current batch is the overload signal."""
        if depth_rows_after >= self.batch_rows:
            self.delay_s = min(self.cap_delay_s,
                               self.delay_s + self.add_delay_s)
            self.batch_rows = min(self.cap_batch,
                                  self.batch_rows + self.add_batch)

    def on_idle(self) -> None:
        """The worker found every queue empty — decay toward base."""
        self.delay_s = max(self.base_delay_s, self.delay_s * self.decay)
        self.batch_rows = max(self.base_batch,
                              int(self.batch_rows * self.decay))

    def state(self) -> dict:
        return {
            "delay_ms": round(self.delay_s * 1e3, 3),
            "batch_rows": self.batch_rows,
            "base_delay_ms": round(self.base_delay_s * 1e3, 3),
            "cap_delay_ms": round(self.cap_delay_s * 1e3, 3),
            "base_batch": self.base_batch,
            "cap_batch": self.cap_batch,
            "adaptive": self.adaptive,
        }
