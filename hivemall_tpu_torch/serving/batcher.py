"""Overload-grade dynamic micro-batching: priorities, quotas, adaptive
windows, deadline-aware shedding — without unbounded queues.

Host-only Python, ported from the JAX package's `serving/batcher.py` and
wired to the port's metrics, tracing and score cache.

One request at a time under-fills the device (a [8, K] gather-dot costs the
same launches as [512, K]); the batcher merges concurrent requests into one
padded batch. Under light load it is a fixed-window batcher; under overload
it degrades *predictably* instead of collapsing (serving/admission.py holds
the primitives):

- **priority classes**: one FIFO queue per class (high/normal/low),
  drained strictly-high-first into SINGLE-CLASS batches — the anchor's
  class fixes the batch, so a high-priority request neither waits out a
  lower class's widened co-ride window nor rides inside its dispatch
  quantum, and a higher-priority arrival closes an in-progress lower
  window immediately; a class skipped ``starvation_limit`` consecutive
  batches while it had queued work anchors the next batch, so
  low-priority latency under sustained high-priority flood is bounded,
  not infinite;
- **admission quotas**: class *c* may fill the queue only to
  ``priority_quota_fracs[c] * max_queue_rows`` — low sheds first (503
  ``reason="quota"``), high keeps headroom to the full cap, and an
  arriving higher-priority request evicts the newest lowest-priority
  queued work (503 ``reason="shed"``) rather than being refused;
- **adaptive batching** (AIMD): the co-ride window (``max_delay``) and
  batch target (``max_batch``) widen additively toward
  ``max_delay_ms_cap``/``max_batch_cap`` while a backlog persists and
  decay multiplicatively when the queue idles — light-load latency stays
  pinned at the base window while overload throughput grows. A
  high-priority rider always caps the window at the BASE delay: the wide
  window is paid by the classes that can afford it;
- **deadline expiry**: requests carry ``deadline_ms``; one that expires
  while queued fails with `DeadlineExpired` (HTTP 504) and never reaches
  dispatch — a slot freed for work someone is still waiting on;
- a batch closes when it holds the controller's current batch-row target
  OR the anchor request's window elapses OR a member's deadline arrives;
- every request gets a `concurrent.futures.Future`; a worker failure
  fails the affected requests, never the process;
- **hot-row cache + coalescing** (optional — ``cache=`` a
  serving/cache.py ScoreCache): consulted BEFORE the admission lock, so
  a request whose rows are all cached (version-exact keys) resolves
  without consuming queue capacity, class quota, or a batch slot, and a
  request fully covered by cache + in-flight leaders shares those
  leaders' computation. Anything else flows unchanged. Note one
  deliberate asymmetry: a CLOSED (draining) batcher still serves cache
  hits — the entry was resolved before the swap, and its answer is
  labeled with the version it was admitted under, exactly like a request
  that beat the swap by a millisecond.

The admission decision is ONE lock acquisition: quota check, shed
selection, queue append and every counter update happen under ``_cv`` with
no check-then-act window (evicted futures fail AFTER release — Future
callbacks must never run under the CV).

Metrics (runtime.metrics.REGISTRY): queue-depth gauges (total and
per-class), batch-occupancy and queue-delay histograms, accepted /
quota_rejected / shed / expired counters per class, live controller state
(``adaptive_delay_ms`` / ``adaptive_batch_rows``) and the drain-rate
estimate (``rows_per_sec``) that prices ``Retry-After``.

Tracing (runtime.tracing.TRACER): the request's span is captured at
submit() and carried ON the queue entry across the thread hop — the worker
parents its spans to it explicitly (contextvars do not cross threads). The
enqueue->dispatch wait is recorded retroactively as a ``queue.wait`` child
span; the merged device call runs under a ``batch.predict`` span parented
to the first traced request of the batch, and every other request in the
batch gets a ``batched`` instant event linking to that trace. A submit with
no ambient span (direct batcher users) opens its own ``serving.request``
root, ended by the future's done-callback. Expired requests get a
``deadline.expired`` instant event instead of device-side spans.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple

from ..runtime.metrics import REGISTRY
from ..runtime.tracing import TRACER
from .admission import (AIMDController, DeadlineExpired, PRIORITY_NAMES,
                        QueueFull, ShedLowPriority, priority_class)

OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
DELAY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 1.0)


class BatcherClosed(RuntimeError):
    """submit() after close()."""


class _Pending:
    # every field publishes immutably in __init__ BEFORE the entry is
    # visible to the worker thread (set post-append would race the take)
    __slots__ = ("instances", "future", "enqueued", "span", "owns_span",
                 "cls", "deadline")

    def __init__(self, instances, span, owns_span: bool, cls: int,
                 deadline_ms: Optional[float]) -> None:
        self.instances = instances
        self.future: Future = Future()
        self.enqueued = time.perf_counter()
        self.span = span  # the request's trace span (maybe NULL_SPAN)
        self.owns_span = owns_span  # True: we opened it, done-cb ends it
        self.cls = cls  # priority class index (0 drains first)
        self.deadline = None if deadline_ms is None \
            else self.enqueued + float(deadline_ms) / 1e3


class DynamicBatcher:
    """Micro-batching front of one ServingEngine (or any ``predict_fn``
    taking a list of instances and returning an indexable of results).

    Defaults reproduce the legacy fixed-window, single-class behavior
    exactly: caps equal bases (no adaptivity) and every class may use the
    whole queue (quota fractions all 1.0). The overload posture is opted
    into with ``max_delay_ms_cap`` / ``max_batch_cap`` /
    ``priority_quota_fracs`` — ModelRegistry passes serving-grade
    defaults.
    """

    def __init__(self, predict_fn: Callable[[List], Sequence], *,
                 max_batch: int = 256, max_delay_ms: float = 2.0,
                 max_queue_rows: int = 4096, name: str = "default",
                 max_batch_cap: Optional[int] = None,
                 max_delay_ms_cap: Optional[float] = None,
                 priority_quota_fracs: Optional[Sequence[float]] = None,
                 starvation_limit: int = 8,
                 express_high: bool = False,
                 cache=None, cache_version: str = "",
                 row_key_fn=None) -> None:
        self.predict_fn = predict_fn
        # the hot-row score cache front (serving/cache.py): consulted in
        # submit() BEFORE the admission lock, so a fully-cached or fully-
        # coalesced request resolves without consuming queue capacity,
        # class quota, or a batch slot. The cache object is shared across
        # this model's versions (ModelRegistry owns it); cache_version is
        # THIS batcher's version — captured at admission into every key,
        # which is the whole hot-swap invalidation story. row_key_fn is
        # the engine's canonical per-row key derivation (None per request
        # = not cacheable, flows unchanged).
        self._cache = cache
        self._cache_version = str(cache_version)
        self._row_key_fn = row_key_fn if cache is not None else None
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_queue_rows = int(max_queue_rows)
        self.name = name
        n_cls = len(PRIORITY_NAMES)
        fracs = tuple(float(f) for f in (priority_quota_fracs
                                         or (1.0,) * n_cls))
        if len(fracs) != n_cls or fracs[0] != 1.0 \
                or any(not 0.0 < f <= 1.0 for f in fracs) \
                or any(a < b for a, b in zip(fracs, fracs[1:])):
            raise ValueError(
                f"priority_quota_fracs must be {n_cls} non-increasing "
                f"fractions in (0, 1] starting at 1.0, got {fracs}")
        self._quota_rows = tuple(int(self.max_queue_rows * f)
                                 for f in fracs)
        self.priority_quota_fracs = fracs
        self.starvation_limit = int(starvation_limit)
        self._ctl = AIMDController(
            base_delay_s=self.max_delay,
            cap_delay_s=(float(max_delay_ms_cap) / 1000.0
                         if max_delay_ms_cap is not None else self.max_delay),
            base_batch=self.max_batch,
            cap_batch=int(max_batch_cap) if max_batch_cap is not None
            else self.max_batch)
        self._cv = threading.Condition()
        self._qs: Tuple[deque, ...] = tuple(deque() for _ in range(n_cls))
        self._class_rows = [0] * n_cls
        self._skips = [0] * n_cls  # consecutive batches a class waited out
        self._depth_rows = 0
        self._closed = False
        self._ewma_rows_per_s = 0.0  # drain-rate estimate (Retry-After)
        self._accepted = REGISTRY.counter("serving", f"{name}.batcher.accepted")
        self._rejected = REGISTRY.counter("serving", f"{name}.batcher.rejected")
        self._accepted_c = tuple(
            REGISTRY.counter("serving", f"{name}.batcher.accepted.{p}")
            for p in PRIORITY_NAMES)
        self._quota_rejected_c = tuple(
            REGISTRY.counter("serving", f"{name}.batcher.quota_rejected.{p}")
            for p in PRIORITY_NAMES)
        self._shed_c = tuple(
            REGISTRY.counter("serving", f"{name}.batcher.shed.{p}")
            for p in PRIORITY_NAMES)
        self._expired_c = tuple(
            REGISTRY.counter("serving", f"{name}.batcher.expired.{p}")
            for p in PRIORITY_NAMES)
        self._occupancy = REGISTRY.histogram(
            f"serving.{name}.batch_occupancy", OCCUPANCY_BUCKETS)
        self._delay = REGISTRY.histogram(
            f"serving.{name}.queue_delay_seconds", DELAY_BUCKETS)
        # gauge keys precomputed once: their setters run under _cv on
        # every admission and take — no f-string work on the hot lock
        self._g_depth = f"serving.{name}.queue_depth_rows"
        self._g_depth_c = tuple(f"serving.{name}.queue_depth_rows.{p}"
                                for p in PRIORITY_NAMES)
        self._g_delay = f"serving.{name}.adaptive_delay_ms"
        self._g_batch = f"serving.{name}.adaptive_batch_rows"
        self._g_rate = f"serving.{name}.rows_per_sec"
        # the express lane: a dedicated worker that drains ONLY class 0,
        # so a high-priority request never waits behind an in-flight
        # lower-class dispatch quantum (the engines' predict is
        # thread-safe: its tables are read-only). The general worker then
        # never touches
        # class 0 and only IT drives the AIMD controller — an idle
        # express lane must not decay the window the loaded general lane
        # earned.
        self.express_high = bool(express_high)
        self._threads = []
        general = tuple(range(1 if self.express_high else 0,
                              len(PRIORITY_NAMES)))
        for tag, classes, drives in (
                [("express", (0,), False)] if self.express_high else []) \
                + [("general", general, True)]:
            t = threading.Thread(
                target=self._loop, args=(classes, drives), daemon=True,
                name=f"hivemall-batcher-{name}-{tag}")
            t.start()
            self._threads.append(t)

    # -- producer side -------------------------------------------------------

    def submit(self, instances: Sequence, *, priority="normal",
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request (a list of instances); the Future resolves
        to the list of predictions for exactly those instances, in order.

        ``priority`` is a class name or index (serving/admission.py);
        ``deadline_ms`` is this request's total queue+dispatch budget —
        expiry in the queue fails the Future with `DeadlineExpired`.
        Over-quota admission raises `QueueFull` (reason "quota"); an
        accepted request later evicted for higher-priority work fails
        with `ShedLowPriority` (reason "shed"). Both carry
        ``retry_after_s`` from the live drain-rate estimate.

        With a cache attached, a fully-covered request resolves without
        queueing; a COALESCED request inherits its leader's fate wholesale
        (queue position, effective deadline, failure mode — see
        serving/cache.py), its own ``priority``/``deadline_ms`` validated
        but not separately enforced."""
        cls = priority_class(priority)
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            if not deadline_ms > 0:
                raise ValueError(f"deadline_ms must be > 0, "
                                 f"got {deadline_ms}")
        if not instances:
            f: Future = Future()
            f.set_result([])
            return f
        # capture the caller's span for the thread hop; with no ambient
        # span open our own request root (ended by the done-callback). A
        # rejected submit abandons an owned span un-ended — it is never
        # committed, which is the point: 503s don't fill the ring.
        cur = TRACER.current()
        if cur is not None:
            span, owns = cur, False
        else:
            span = TRACER.begin("serving.request", parent=None,
                                args={"batcher": self.name,
                                      "rows": len(instances)})
            owns = span.recording
        p = _Pending(list(instances), span, owns, cls, deadline_ms)
        k = len(p.instances)
        # the hot-row cache front, BEFORE the admission lock: a fully
        # cached request resolves right here (no queue capacity, no class
        # quota, no batch slot) and a request fully covered by cache +
        # in-flight leaders attaches to those leaders' Futures
        # (serving/cache.py). Any uncovered row -> the request flows
        # unchanged below, leading its new keys; its Future's outcome
        # settles the cache (populate on success, fail followers with the
        # same reason on shed/expiry/engine error).
        token = None
        if self._cache is not None and self._row_key_fn is not None:
            keys = self._row_key_fn(p.instances)
            if keys is not None:
                plan = self._cache.admit(self._cache_version, keys,
                                         p.future)
                if plan.kind == "hit":
                    if span.recording:
                        span.event("cache.hit", rows=plan.hit_rows,
                                   version=self._cache_version)
                    if owns:
                        p.future.add_done_callback(
                            lambda f, s=span: TRACER.end(s))
                    # outside every lock: set_result runs done-callbacks
                    # synchronously
                    p.future.set_result(plan.values)
                    return p.future
                if plan.kind == "coalesced":
                    if span.recording:
                        span.event("cache.coalesced",
                                   rows=plan.coalesced_rows,
                                   hit_rows=plan.hit_rows,
                                   version=self._cache_version)
                    if owns:
                        p.future.add_done_callback(
                            lambda f, s=span: TRACER.end(s))
                    return p.future  # the cache settles it with the leaders
                if plan.kind == "refused":
                    # a row of this request was quota-refused within the
                    # negative TTL: repeat the refusal synchronously from
                    # the cache front — no admission lock, no shed scan.
                    # The owned span is abandoned un-ended on purpose,
                    # like every rejected submit (503s don't fill the
                    # ring).
                    if span.recording:
                        span.event("cache.negative",
                                   version=self._cache_version)
                    raise plan.error
                token = plan.token
        evicted: List[_Pending] = []
        err: Optional[Exception] = None
        ra = None
        # the whole admission decision is ONE lock acquisition: quota
        # check, shed selection, append and counters — no check-then-act
        # window for a concurrent submit to slip through
        with self._cv:
            if self._closed:
                err = BatcherClosed(f"batcher {self.name!r} is closed")
            else:
                quota = self._quota_rows[cls]
                if self._depth_rows + k > quota:
                    ra = self._retry_after_locked()
                    # make room by dropping the newest strictly-lower-
                    # priority queued work (oldest keep their place in
                    # line) — but only when the lower classes actually
                    # hold enough rows to admit this request: shedding
                    # someone and STILL rejecting would destroy accepted
                    # work for nothing
                    need = self._depth_rows + k - quota
                    if sum(self._class_rows[c]
                           for c in range(cls + 1, len(self._qs))) >= need:
                        self._shed_lower_locked(cls, need, evicted)
                if self._depth_rows + k > quota:
                    self._quota_rejected_c[cls].increment()
                    self._rejected.increment()
                    err = QueueFull(
                        f"batcher {self.name!r}: {PRIORITY_NAMES[cls]}"
                        f"-priority admission quota is {quota} rows, queue "
                        f"holds {self._depth_rows} — shed load",
                        reason="quota", retry_after_s=ra)
                else:
                    self._qs[cls].append(p)
                    self._class_rows[cls] += k
                    self._depth_rows += k
                    self._accepted.increment()
                    self._accepted_c[cls].increment()
                    self._set_depth_gauges_locked()
                    if self.express_high:
                        # two workers wait on one CV; notify() could wake
                        # the lane that cannot serve this class
                        self._cv.notify_all()
                    else:
                        self._cv.notify()
        # outside the lock: set_exception runs done-callbacks synchronously,
        # and arbitrary callback code must never execute while _cv is held
        for ev in evicted:
            if not ev.future.cancelled():
                ev.future.set_exception(ShedLowPriority(
                    f"batcher {self.name!r}: {PRIORITY_NAMES[ev.cls]}-"
                    f"priority request shed for higher-priority work",
                    retry_after_s=ra))
        if err is not None:
            # a refused leader registered nothing (leadership is taken by
            # lead() below, only on success), so no follower can be
            # stranded on an admission error — the refusal stays
            # synchronous, where registry.submit's swap-retry can see it
            if token is not None and isinstance(err, QueueFull):
                # quota refusal of a lead request: its new keys enter the
                # short-TTL negative cache, so the hot row stops
                # re-entering admission until capacity can have recovered
                # (a closed batcher is NOT cached — the registry's
                # swap-retry must see BatcherClosed fresh every time)
                self._cache.note_refusal(token, err)
            raise err
        if token is not None:
            # NOW the request is queued: take leadership of its new keys,
            # then let its outcome settle the cache — success populates
            # and resolves followers; shed / expiry / engine error /
            # drop-on-close fails them with the same reason. settle runs
            # as a done-callback, outside _cv like every other
            # set_result/set_exception site.
            self._cache.lead(token)
            p.future.add_done_callback(
                lambda f, t=token: self._cache.settle(t, f))
        if owns:
            p.future.add_done_callback(lambda f, s=span: TRACER.end(s))
        return p.future

    def _shed_lower_locked(self, cls: int, need_rows: int,
                           out: List[_Pending]) -> None:
        """Evict up to ``need_rows`` rows of strictly-lower-priority queued
        work, lowest class first, newest first within a class. Counters
        update here (same lock acquisition as the admission decision);
        the caller fails the evicted futures after releasing ``_cv``."""
        for c in range(len(self._qs) - 1, cls, -1):
            q = self._qs[c]
            while q and need_rows > 0:
                victim = q.pop()
                k = len(victim.instances)
                self._class_rows[c] -= k
                self._depth_rows -= k
                self._shed_c[c].increment()
                out.append(victim)
                need_rows -= k
            if need_rows <= 0:
                break
        if out:
            self._set_depth_gauges_locked()

    def _retry_after_locked(self) -> float:
        """Seconds until the current backlog drains at the observed
        service rate — the Retry-After a shed client should honor."""
        if self._ewma_rows_per_s <= 0.0:
            return 1.0
        return min(30.0, max(1.0, self._depth_rows / self._ewma_rows_per_s))

    def _set_depth_gauges_locked(self) -> None:
        REGISTRY.set_gauge(self._g_depth, float(self._depth_rows))
        for c, key in enumerate(self._g_depth_c):
            REGISTRY.set_gauge(key, float(self._class_rows[c]))

    def overload_state(self) -> dict:
        """One consistent snapshot of the admission surface — what
        /healthz and /models report (docs/serving.md "Overload
        behavior")."""
        with self._cv:
            ctl = self._ctl.state()
            depth = self._depth_rows
            per_class = {p: self._class_rows[c]
                         for c, p in enumerate(PRIORITY_NAMES)}
            rate = self._ewma_rows_per_s
            shed = {p: self._shed_c[c].value
                    for c, p in enumerate(PRIORITY_NAMES)}
            expired = {p: self._expired_c[c].value
                       for c, p in enumerate(PRIORITY_NAMES)}
            quota_rej = {p: self._quota_rejected_c[c].value
                         for c, p in enumerate(PRIORITY_NAMES)}
        return {
            "depth_rows": depth,
            "max_queue_rows": self.max_queue_rows,
            "depth_fraction": round(depth / self.max_queue_rows, 4)
            if self.max_queue_rows else 0.0,
            "class_rows": per_class,
            "quota_fracs": {p: self.priority_quota_fracs[c]
                            for c, p in enumerate(PRIORITY_NAMES)},
            "starvation_limit": self.starvation_limit,
            "controller": ctl,
            "rows_per_sec": round(rate, 1),
            "shed": shed,
            "expired": expired,
            "quota_rejected": quota_rej,
        }

    def close(self, drain: bool = True) -> None:
        """Stop accepting work. ``drain=True`` (the hot-swap path) lets the
        worker finish everything already queued before the thread exits, so
        an in-flight version swap fails zero requests."""
        dropped: List[_Pending] = []
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if not drain:
                for q in self._qs:
                    while q:
                        dropped.append(q.popleft())
                self._class_rows = [0] * len(self._qs)
                self._depth_rows = 0
            self._cv.notify_all()
        # outside the lock: set_exception runs done-callbacks synchronously,
        # and arbitrary callback code must never execute while _cv is held
        # (a callback that needs the lock would stall every producer)
        for p in dropped:
            p.future.set_exception(
                BatcherClosed(f"batcher {self.name!r} closed"))
        for t in self._threads:
            t.join(timeout=30.0)

    # -- worker side ---------------------------------------------------------

    def _next_live_locked(self, expired: List[_Pending], classes=None):
        """The next request to serve — the first live head scanning
        ``classes`` in order (default: every class, highest priority
        first) — WITHOUT popping it. Expired heads met on the way are
        popped into ``expired`` (they never reach dispatch; the caller
        fails them outside the lock). Returns (cls, pending) or None when
        none of the scanned classes holds live work."""
        order = range(len(self._qs)) if classes is None else classes
        for c in order:
            q = self._qs[c]
            while q:
                p = q[0]
                if p.deadline is not None \
                        and time.perf_counter() >= p.deadline:
                    q.popleft()
                    k = len(p.instances)
                    self._class_rows[c] -= k
                    self._depth_rows -= k
                    self._expired_c[c].increment()
                    expired.append(p)
                    continue
                return c, p
        return None

    def _forced_class_locked(self) -> Optional[int]:
        """The starvation escape: a class skipped ``starvation_limit``
        consecutive batches while it had queued work anchors the next
        batch. The LONGEST-skipped class wins (ties go to the lower
        class), so under a sustained high flood normal and low both make
        bounded progress instead of low monopolizing the escape."""
        best = None
        for c in range(len(self._qs) - 1, 0, -1):
            if self._qs[c] and self._skips[c] >= self.starvation_limit \
                    and (best is None or self._skips[c] > self._skips[best]):
                best = c
        return best

    def _take_batch(self, classes, drive_controller: bool):
        """Assemble one batch from this lane's ``classes``:
        strict-priority pulls up to the controller's current row target,
        waiting out the anchor's co-ride window. Only the general lane
        drives the AIMD controller (``drive_controller``) — the express
        lane always dispatches at the base window. Returns
        (batch, expired): ``expired`` entries passed their deadline in
        the queue and must be failed by the caller OUTSIDE the lock.
        (None, expired) signals shutdown; ([], expired) is an expiry
        flush — deliver their 504s and call again."""
        expired: List[_Pending] = []
        with self._cv:
            while True:
                # wait for live work (expired heads purge as they surface)
                while True:
                    if self._next_live_locked(expired, classes) is not None:
                        break
                    if self._closed:
                        self._set_depth_gauges_locked()
                        return None, expired
                    if expired:
                        # nothing live but expiries in hand: deliver their
                        # 504s NOW — a dead request's answer must not wait
                        # for the next arrival to wake this worker
                        self._set_depth_gauges_locked()
                        return [], expired
                    if drive_controller:
                        self._ctl.on_idle()  # queue idle: decay to base
                        self._export_ctl_gauges_locked()
                    self._cv.wait()
                # single-class batches: the anchor (highest-priority live
                # head, or the starvation-forced class) fixes the batch's
                # class, and only that class co-rides — a high-priority
                # request never waits out a lower class's widened window
                # or rides inside its dispatch quantum
                batch: List[_Pending] = []
                rows = 0
                cap = self._ctl.batch_rows if drive_controller \
                    else self._ctl.base_batch
                close_at = 0.0
                anchor_cls = classes[0]
                forced = self._forced_class_locked() if drive_controller \
                    else None
                order = classes if forced is None else \
                    [forced] + [c for c in classes if c != forced]
                while rows < cap:
                    if not batch:
                        nxt = self._next_live_locked(expired, order)
                        if nxt is None:
                            break  # the lone live head expired: re-wait
                    else:
                        # a strictly-higher-priority arrival in THIS
                        # lane's classes closes the window NOW: its batch
                        # dispatches next instead of waiting out a lower
                        # class's co-ride window
                        higher = [c for c in classes if c < anchor_cls]
                        if higher and self._next_live_locked(
                                expired, higher) is not None:
                            break
                        nxt = self._next_live_locked(expired, (anchor_cls,))
                    if nxt is not None:
                        c, p = nxt
                        if batch and rows + len(p.instances) > cap:
                            break
                        self._qs[c].popleft()
                        k = len(p.instances)
                        self._class_rows[c] -= k
                        self._depth_rows -= k
                        if not batch:
                            anchor_cls = c
                        batch.append(p)
                        rows += k
                        # high-priority batches cap the co-ride window at
                        # the BASE delay — the widened window is paid by
                        # the classes that can afford it; a member's
                        # deadline closes the batch early so it still
                        # dispatches in time
                        w = self._ctl.base_delay_s if c == 0 \
                            else self._ctl.delay_s
                        t_close = p.enqueued + w
                        if p.deadline is not None:
                            t_close = min(t_close, p.deadline)
                        close_at = min(close_at, t_close) if len(batch) > 1 \
                            else t_close
                        continue
                    remaining = close_at - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(timeout=remaining)
                # final sweep: a member whose deadline passed during the
                # co-ride wait never reaches dispatch
                now = time.perf_counter()
                live: List[_Pending] = []
                for p in batch:
                    if p.deadline is not None and now >= p.deadline:
                        self._expired_c[p.cls].increment()
                        expired.append(p)
                    else:
                        live.append(p)
                if drive_controller:
                    served = {p.cls for p in live}
                    for c in range(1, len(self._qs)):
                        if c in served:
                            self._skips[c] = 0
                        elif self._qs[c]:
                            self._skips[c] += 1
                if live or self._closed:
                    if drive_controller:
                        self._ctl.on_take(self._depth_rows)
                        self._export_ctl_gauges_locked()
                    self._set_depth_gauges_locked()
                    return live, expired
                # every member expired mid-wait — assemble again

    def _export_ctl_gauges_locked(self) -> None:
        REGISTRY.set_gauge(self._g_delay, self._ctl.delay_s * 1e3)
        REGISTRY.set_gauge(self._g_batch, float(self._ctl.batch_rows))

    def _fail_expired(self, expired: List[_Pending]) -> None:
        # outside the lock (done-callbacks run synchronously); the
        # trace records the in-queue death as an instant event
        now = time.perf_counter()
        for p in expired:
            if p.span.recording:
                p.span.event("deadline.expired",
                             queued_ms=round((now - p.enqueued) * 1e3, 3),
                             priority=PRIORITY_NAMES[p.cls])
            if not p.future.cancelled():
                p.future.set_exception(DeadlineExpired(
                    f"batcher {self.name!r}: deadline elapsed after "
                    f"{(now - p.enqueued) * 1e3:.1f} ms in queue "
                    f"(never dispatched)"))

    def _loop(self, classes=None, drive_controller: bool = True) -> None:
        if classes is None:
            classes = tuple(range(len(self._qs)))
        while True:
            batch, expired = self._take_batch(classes, drive_controller)
            self._fail_expired(expired)
            if batch is None:
                return  # shutdown
            if not batch:
                continue  # expiry flush only — nothing to dispatch
            now = time.perf_counter()
            now_ns = time.perf_counter_ns()
            rows: List = []
            for p in batch:
                self._delay.observe(now - p.enqueued,
                                    trace_id=TRACER.exemplar_id(p.span))
                # the enqueue->take wait, recorded retroactively into the
                # request's trace (the hop: submit thread -> this thread)
                TRACER.add_span("queue.wait", p.span,
                                int(p.enqueued * 1e9), now_ns,
                                args={"batcher": self.name,
                                      "rows": len(p.instances),
                                      "priority": PRIORITY_NAMES[p.cls]})
                rows.extend(p.instances)
            self._occupancy.observe(len(rows))
            # the merged device call belongs to ONE trace: the first
            # SAMPLED request of the batch (an unsampled first request
            # would take the device-side spans into a trace that gets
            # dropped, leaving every committed trace stage-less); only
            # when nothing is sampled fall back to the first recording
            # span, whose trace can still commit via the slow_ms escape
            rep = next((p.span for p in batch
                        if p.span.recording and p.span.sampled), None) \
                or next((p.span for p in batch if p.span.recording), None)
            for p in batch:
                if p.span.recording and p.span is not rep:
                    p.span.event("batched", in_trace=rep.trace_id,
                                 batch_rows=len(rows))
            t0 = time.perf_counter()
            try:
                with TRACER.span("batch.predict", parent=rep,
                                 args={"rows": len(rows),
                                       "requests": len(batch)}):
                    preds = self.predict_fn(rows)
            except Exception as e:  # fail the batch, not the process
                for p in batch:
                    if not p.future.cancelled():
                        p.future.set_exception(e)
                continue
            dt = time.perf_counter() - t0
            if dt > 0:
                inst_rate = len(rows) / dt
                with self._cv:
                    # single-writer EWMA (this thread), read under the
                    # same lock by _retry_after_locked/overload_state
                    self._ewma_rows_per_s = inst_rate \
                        if self._ewma_rows_per_s <= 0.0 \
                        else 0.7 * self._ewma_rows_per_s + 0.3 * inst_rate
                    REGISTRY.set_gauge(self._g_rate,
                                       self._ewma_rows_per_s)
            off = 0
            for p in batch:
                k = len(p.instances)
                if not p.future.cancelled():
                    p.future.set_result(list(preds[off:off + k]))
                off += k
