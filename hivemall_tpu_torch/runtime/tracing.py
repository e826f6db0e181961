# graftcheck: serving-module
"""End-to-end span tracing: request spans through serving, step timelines
through training, one Perfetto-loadable export for both.

A host-only copy of the JAX package's `runtime/tracing.py`: the same span,
trace and export formats, and the same environment knobs. Only
``sync_ready`` touches the device (a ``torch.cuda.synchronize``).

Aggregate counters and histograms (runtime/metrics.py) say THAT a p99
regressed; this module says WHERE the time went — HTTP parse vs. batcher
queue wait vs. bucket pad vs. device dispatch vs. host sync.

Design constraints, in order:

1. **Never block the serving hot path.** Span start/stop is a
   ``perf_counter_ns`` read plus slot writes; the tracer's single lock
   guards only the committed-trace ring buffer append and the sampling
   RNG — no IO, no device sync, no device work ever runs under it.
2. **Spans cross threads by explicit handoff, not ambient magic.** The
   contextvar tracks the current span per thread; the batcher hop
   (serving/batcher.py) carries the request's span on the queue entry and
   the worker parents its spans to it explicitly.
3. **One trace format.** ``export_chrome()`` emits Chrome ``trace_event``
   JSON that loads in ui.perfetto.dev / chrome://tracing for serving
   requests and training steps alike.

Vocabulary:

- a **trace** is one request (or one training step): a root span plus its
  descendants, identified by ``trace_id``;
- a **span** is one timed stage (``name``, ``span_id``, ``parent_id``,
  start/duration, thread, args);
- an **instant event** is a point-in-time marker inside a span — e.g. an
  ``alloc_segment`` emitted by ``runtime.metrics.alloc_segment_guard``, so
  a new allocator segment shows up INSIDE the request that paid for it.

Sampling: the *decision* is made per root span with a seeded RNG
(deterministic for tests); child spans inherit it. Spans are timed
regardless (they are cheap); the decision gates which traces are
*committed* to the ring buffer — plus ``slow_ms``: a root slower than the
threshold commits even when unsampled, so the tail is never invisible.
``enabled=False`` turns span creation into a no-op entirely.

Usage::

    from hivemall_tpu_torch.runtime.tracing import (TRACER, step_span,
                                                    sync_ready)

    with TRACER.span("engine.pad", args={"rows": n}):
        staged = servable.stage(chunk, b_pad, width_cap)

    with step_span("mix_dp", step=i):  # training timeline: train.step
        state, loss = trainer.step(state, *block)
        sync_ready(loss)               # train.sync

    TRACER.export_chrome("trace.json")   # -> ui.perfetto.dev
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import random
import re
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

_ID_COUNTER = itertools.count(1)  # __next__ is GIL-atomic: no lock needed


def _new_id(prefix: str) -> str:
    return f"{prefix}{next(_ID_COUNTER):x}"


# W3C Trace Context traceparent (https://www.w3.org/TR/trace-context/):
# a version-00 parser reads the first four fields and, for versions ABOVE
# 00, tolerates appended future fields; version 00 itself must have
# exactly four, version 0xff and all-zero trace/span ids are invalid
_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})"
    r"(-[^\s]*)?$")


def _w3c_hex(ident: Optional[str], width: int) -> str:
    """Render an internal id ("t2a"/"s1f") or an adopted 32-hex trace id
    as a W3C fixed-width lowercase hex field (all-zero is invalid per
    spec, so 0 maps to 1)."""
    h = ident or ""
    if h and h[0] in "ts":
        h = h[1:]
    try:
        v = int(h, 16)
    except ValueError:  # graftcheck: disable=G028 (not degraded: non-hex idents hash via bytes, same mapping)
        v = int.from_bytes(h.encode(), "big")
    v %= 16 ** width
    return format(v or 1, f"0{width}x")


class _NullSpan:
    """Returned when the tracer is disabled — every operation is a no-op,
    so call sites never branch on tracer state."""

    __slots__ = ()
    recording = False
    sampled = False
    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    def set(self, **args) -> None:
        pass

    def event(self, name: str, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Trace:
    """Per-trace accumulator: the root's sampling decision plus every
    finished span, committed (or dropped) when the root ends."""

    __slots__ = ("trace_id", "sampled", "spans", "root")

    def __init__(self, trace_id: str, sampled: bool) -> None:
        self.trace_id = trace_id
        self.sampled = sampled
        self.spans: List["Span"] = []  # list.append is GIL-atomic
        self.root: Optional["Span"] = None


class Span:
    """One timed stage of a trace. Created via Tracer.span()/begin();
    mutated by exactly one thread at a time (the thread that opened it)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ns",
                 "end_ns", "tid", "args", "events", "_trace")

    recording = True

    def __init__(self, name: str, trace: _Trace, parent_id: Optional[str],
                 start_ns: int) -> None:
        self.name = name
        self.trace_id = trace.trace_id
        self.span_id = _new_id("s")
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.tid = threading.get_ident()
        self.args: Dict = {}
        self.events: List = []  # (name, ts_ns, args)
        self._trace = trace

    @property
    def sampled(self) -> bool:
        return self._trace.sampled

    def set(self, **args) -> None:
        """Attach key/value annotations (shown in the Perfetto args pane)."""
        self.args.update(args)

    def event(self, name: str, **args) -> None:
        """Attach an instant event at now (e.g. an allocator-segment marker)."""
        self.events.append((name, time.perf_counter_ns(), args))

    def to_dict(self) -> dict:
        dur = (self.end_ns - self.start_ns) if self.end_ns is not None else 0
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_us": self.start_ns / 1e3,
            "dur_us": dur / 1e3,
            "tid": self.tid,
            "args": dict(self.args),
            "events": [{"name": n, "ts_us": ts / 1e3, "args": dict(a)}
                       for n, ts, a in self.events],
        }


# the thread's (task's) innermost open span; crossed threads only by
# explicit handoff (Tracer.add_span / span(parent=...))
_current: contextvars.ContextVar = contextvars.ContextVar(
    "hivemall_tpu_current_span", default=None)

_UNSET = object()


class Tracer:
    """Thread-safe span tracer with a bounded ring of committed traces.

    The hot path (begin/end) takes the lock only to (a) draw one sampling
    decision per root and (b) append one committed trace per root — both
    O(1) pointer work. Exports copy the ring under the lock and serialize
    outside it.
    """

    def __init__(self, capacity: int = 256, sample_rate: float = 1.0,
                 slow_ms: Optional[float] = None, seed: Optional[int] = None,
                 enabled: bool = True,
                 slow_reserve: float = 0.25) -> None:
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self.slow_ms = slow_ms
        self.enabled = bool(enabled)
        self._rng = random.Random(seed)
        # slow-trace retention: with slow_ms set, a fraction of the ring is
        # RESERVED for slow_ms-qualified traces — under sustained overload
        # a flood of fast sampled traces would otherwise FIFO-evict the
        # slow outliers that are the whole point of the slow escape. The
        # two rings share one commit sequence so traces() stays ordered.
        reserved = int(self.capacity * float(slow_reserve)) \
            if slow_ms is not None else 0
        reserved = min(reserved, max(0, self.capacity - 1))
        self.slow_reserved = reserved
        self._ring: deque = deque(maxlen=self.capacity - reserved)
        self._slow_ring: Optional[deque] = \
            deque(maxlen=reserved) if reserved else None
        self._seq = 0  # commit order across both rings (guarded by _lock)
        self._lock = threading.Lock()
        self.dropped = 0  # unsampled-and-fast roots (observability of loss)

    # -- span lifecycle ------------------------------------------------------

    def current(self) -> Optional[Span]:
        """The calling thread's innermost open span (None outside any)."""
        span = _current.get()
        return span if span is not None and span.recording else None

    def exemplar_id(self, span=None) -> Optional[str]:
        """trace_id usable as a histogram exemplar (None when the trace
        cannot land in the ring). Sampled traces always commit; with
        ``slow_ms`` set, an unsampled trace MAY commit via the slow
        escape — exactly the tail an exemplar should link to — so its id
        is returned too (the link can dangle if the root finishes fast;
        a missing link on the slow tail is the worse failure)."""
        if span is None:
            span = self.current()
        if span is None or not span.recording:
            return None
        if span.sampled or self.slow_ms is not None:
            return span.trace_id
        return None

    def _sample(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.sample_rate

    # -- W3C Trace Context (traceparent) -------------------------------------

    @staticmethod
    def parse_traceparent(header: Optional[str]
                          ) -> Optional[Tuple[str, str, bool]]:
        """Parse a W3C ``traceparent`` header into a remote context
        ``(trace_id, parent_span_id, sampled_flag)`` usable as
        ``begin/span(remote=...)``. Returns None on anything malformed —
        version 0xff, wrong field widths, all-zero ids — so the caller
        falls back to a fresh trace (the fail-open contract)."""
        if not header or not isinstance(header, str):
            return None
        m = _TRACEPARENT.match(header.strip().lower())
        if m is None:
            return None
        version, trace_id, span_id, flags, extra = m.groups()
        if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        if extra is not None and version == "00":
            return None  # version 00 has exactly four fields
        return trace_id, span_id, bool(int(flags, 16) & 1)

    def format_traceparent(self, span) -> Optional[str]:
        """The ``traceparent`` to echo back for ``span``: its trace id
        (the adopted client id verbatim for remote-parented roots) and
        ITS span id as the new parent, sampled flag from the trace's
        commit decision. None when the span records nothing."""
        if span is None or not getattr(span, "recording", False):
            return None
        flags = "01" if span.sampled else "00"
        return (f"00-{_w3c_hex(span.trace_id, 32)}-"
                f"{_w3c_hex(span.span_id, 16)}-{flags}")

    def begin(self, name: str, parent=_UNSET,
              start_ns: Optional[int] = None, args: Optional[dict] = None,
              remote: Optional[Tuple[str, str, bool]] = None):
        """Open a span (manual pairing with end(); prefer span()). parent
        defaults to the calling thread's current span; pass an explicit
        Span for cross-thread parenting or None to force a new root.
        ``remote`` (a parse_traceparent result) makes the new root adopt
        the client's trace id and parent the client's span — it applies
        only when no local parent is in effect."""
        if not self.enabled:
            return NULL_SPAN
        if parent is _UNSET:
            parent = self.current()
        if parent is not None and parent.recording:
            trace = parent._trace
            parent_id = parent.span_id
            span = Span(name, trace, parent_id,
                        start_ns if start_ns is not None
                        else time.perf_counter_ns())
        else:
            if remote is not None:
                # adopt the client's trace: their trace id IS ours, their
                # span is our root's parent; their sampled flag is a vote,
                # not a veto — our sampler can still commit the trace
                r_trace, r_span, r_sampled = remote
                trace = _Trace(r_trace, r_sampled or self._sample())
                parent_id = r_span
            else:
                trace = _Trace(_new_id("t"), self._sample())
                parent_id = None
            span = Span(name, trace, parent_id,
                        start_ns if start_ns is not None
                        else time.perf_counter_ns())
            trace.root = span
        if args:
            span.args.update(args)
        return span

    def end(self, span, end_ns: Optional[int] = None) -> None:
        """Close a span; when it is its trace's root, commit (sampled or
        slower than slow_ms) or drop the whole trace."""
        if not span.recording:
            return
        span.end_ns = end_ns if end_ns is not None else time.perf_counter_ns()
        trace = span._trace
        trace.spans.append(span)
        if span is not trace.root:
            return
        dur_ms = (span.end_ns - span.start_ns) / 1e6
        slow = self.slow_ms is not None and dur_ms >= self.slow_ms
        if trace.sampled or slow:
            committed = {
                "trace_id": trace.trace_id,
                "root": span.name,
                "duration_ms": dur_ms,
                "sampled": trace.sampled,
                "spans": [s.to_dict() for s in trace.spans],
            }
            with self._lock:
                committed["seq"] = self._seq
                self._seq += 1
                # slow outliers land in their reserved slots, where a
                # flood of fast sampled traces cannot FIFO-evict them; the
                # reserve is a FLOOR, not a partition — when it is full
                # the oldest slow trace overflows into the general ring
                # and competes there, so an all-slow workload still
                # retains up to the full capacity
                if slow and self._slow_ring is not None:
                    if len(self._slow_ring) == self._slow_ring.maxlen:
                        self._ring.append(self._slow_ring.popleft())
                    self._slow_ring.append(committed)
                else:
                    self._ring.append(committed)
        else:
            with self._lock:  # read-modify-write: racy without the lock
                self.dropped += 1

    @contextlib.contextmanager
    def span(self, name: str, parent=_UNSET,
             args: Optional[dict] = None,
             remote: Optional[Tuple[str, str, bool]] = None
             ) -> Iterator[Span]:
        """Context-managed span, set as the thread's current for its
        extent so nested spans parent automatically. ``remote`` threads a
        parsed client ``traceparent`` through to begin()."""
        span = self.begin(name, parent=parent, args=args, remote=remote)
        if span is NULL_SPAN:
            yield span
            return
        token = _current.set(span)
        try:
            yield span
        finally:
            _current.reset(token)
            self.end(span)

    def add_span(self, name: str, parent, start_ns: int, end_ns: int,
                 args: Optional[dict] = None) -> None:
        """Record an already-elapsed interval as a child span — the
        queue-wait idiom: the batcher worker stamps [enqueued, taken] as a
        span parented to the span the request was submitted under."""
        if not self.enabled or parent is None or not parent.recording:
            return
        span = Span(name, parent._trace, parent.span_id, start_ns)
        if args:
            span.args.update(args)
        span.end_ns = end_ns
        parent._trace.spans.append(span)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """Attach an instant event to the calling thread's current span
        (no-op outside any span) — allocator-segment markers."""
        span = self.current()
        if span is not None:
            span.event(name, **(args or {}))

    # -- inspection / export -------------------------------------------------

    def traces(self, n: Optional[int] = None) -> List[dict]:
        """The last ``n`` committed traces, oldest first (n=None: all;
        n <= 0: none — NOT all: out[-0:] would be the whole list). The
        general and reserved-slow rings merge back into one commit-order
        stream."""
        with self._lock:
            out = list(self._ring)
            if self._slow_ring is not None and self._slow_ring:
                out = sorted(out + list(self._slow_ring),
                             key=lambda t: t["seq"])
        if n is not None:
            n = int(n)
            out = out[-n:] if n > 0 else []
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            if self._slow_ring is not None:
                self._slow_ring.clear()
            self._seq = 0
            self.dropped = 0

    def slowest(self, k: int = 5, n: Optional[int] = None) -> List[dict]:
        """Top-k slowest committed traces with their per-stage totals (the
        flight recorder's "where did the p99 go" section)."""
        ranked = sorted(self.traces(n), key=lambda t: -t["duration_ms"])[:k]
        out = []
        for t in ranked:
            stages: Dict[str, float] = {}
            for s in t["spans"]:
                stages[s["name"]] = stages.get(s["name"], 0.0) \
                    + s["dur_us"] / 1e3
            out.append({"trace_id": t["trace_id"], "root": t["root"],
                        "duration_ms": round(t["duration_ms"], 3),
                        "stages_ms": {k_: round(v, 3)
                                      for k_, v in sorted(stages.items())}})
        return out

    def stage_breakdown(self, n: Optional[int] = None) -> Dict[str, dict]:
        """Aggregate per-stage time across committed traces:
        {stage: {count, total_ms, mean_ms, max_ms}}."""
        agg: Dict[str, List[float]] = {}
        for t in self.traces(n):
            for s in t["spans"]:
                agg.setdefault(s["name"], []).append(s["dur_us"] / 1e3)
        return {
            name: {
                "count": len(ds),
                "total_ms": round(sum(ds), 3),
                "mean_ms": round(sum(ds) / len(ds), 4),
                "max_ms": round(max(ds), 3),
            }
            for name, ds in sorted(agg.items())
        }

    def chrome_trace(self, n: Optional[int] = None) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON (the dict; export_chrome
        writes it). Spans map to complete ("X") events, instant events to
        "i" events, all stamped with trace/span ids in args so Perfetto
        queries can join them back to exemplars."""
        pid = os.getpid()
        events = []
        committed = self.traces(n)  # ONE ring copy: count == events' source
        for t in committed:
            for s in t["spans"]:
                events.append({
                    "name": s["name"],
                    "cat": "hivemall_tpu",
                    "ph": "X",
                    "ts": s["start_us"],
                    "dur": s["dur_us"],
                    "pid": pid,
                    "tid": s["tid"],
                    "args": {**s["args"], "trace_id": s["trace_id"],
                             "span_id": s["span_id"],
                             "parent_id": s["parent_id"]},
                })
                for ev in s["events"]:
                    events.append({
                        "name": ev["name"],
                        "cat": "hivemall_tpu",
                        "ph": "i",
                        "s": "t",
                        "ts": ev["ts_us"],
                        "pid": pid,
                        "tid": s["tid"],
                        "args": {**ev["args"], "trace_id": s["trace_id"]},
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"source": "hivemall_tpu_torch.runtime.tracing",
                              "traces": len(committed)}}

    def export_chrome(self, path: str, n: Optional[int] = None) -> dict:
        """Write the Chrome trace to ``path`` (load it in ui.perfetto.dev
        or chrome://tracing); returns the exported dict. Serialization
        happens OUTSIDE the tracer lock (chrome_trace copies first)."""
        doc = self.chrome_trace(n)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# Process-wide tracer, knobs via environment:
#   HIVEMALL_TPU_TRACE=0             disable entirely
#   HIVEMALL_TPU_TRACE_SAMPLE=0.1    sample 10% of roots
#   HIVEMALL_TPU_TRACE_SLOW_MS=50    always commit roots >= 50 ms
#   HIVEMALL_TPU_TRACE_SLOW_RESERVE=0.25  ring fraction reserved for slow
#                                    traces (only meaningful with SLOW_MS)
#   HIVEMALL_TPU_TRACE_CAPACITY=256  ring size (committed traces)
_slow = os.environ.get("HIVEMALL_TPU_TRACE_SLOW_MS")
TRACER = Tracer(
    capacity=int(_env_float("HIVEMALL_TPU_TRACE_CAPACITY", 256)),
    sample_rate=_env_float("HIVEMALL_TPU_TRACE_SAMPLE", 1.0),
    slow_ms=float(_slow) if _slow else None,
    enabled=os.environ.get("HIVEMALL_TPU_TRACE", "1") != "0",
    slow_reserve=_env_float("HIVEMALL_TPU_TRACE_SLOW_RESERVE", 0.25),
)


@contextlib.contextmanager
def step_span(trainer: str, step: Optional[int] = None,
              tracer: Optional[Tracer] = None) -> Iterator[Span]:
    """Root span for ONE training step — the per-step timeline the sharded
    and mix trainers feed: open it in the driving loop, and the trainer's
    dispatch lands as a ``train.compiled_step`` child, host block building
    under ``train.data_prep``, ``sync_ready`` as ``train.sync``::

        for i, blk in enumerate(blocks):
            with step_span("sharded_1d", step=i):
                state, loss = trainer.step(state, *blk)
                sync_ready(loss)
    """
    t = tracer if tracer is not None else TRACER
    args = {"trainer": trainer}
    if step is not None:
        args["step"] = int(step)
    with t.span("train.step", args=args) as s:
        yield s


def sync_ready(tree, tracer: Optional[Tracer] = None):
    """Wait for the device under a ``train.sync`` span — makes the
    host-sync cost of a step visible as its own stage; returns ``tree``.
    The wait is a ``torch.cuda.synchronize`` on the device of the first
    CUDA tensor found in ``tree`` (nested lists, tuples, dicts and
    dataclass fields); a tree with none waits for nothing."""
    t = tracer if tracer is not None else TRACER
    with t.span("train.sync"):
        dev = _first_cuda_device(tree)
        if dev is not None:
            import torch

            torch.cuda.synchronize(dev)
        return tree


def _first_cuda_device(tree):
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if isinstance(tree, dict):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = (getattr(tree, f.name) for f in dataclasses.fields(tree))
    else:
        return None
    for x in items:
        dev = _first_cuda_device(x)
        if dev is not None:
            return dev
    return None
