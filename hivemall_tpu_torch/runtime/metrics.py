"""Observability: counters, stopwatch, throughput meters, histograms, the
allocator guard and the profiler window.

Mirrors the reference's observability surface (SURVEY.md §5) under the
JAX package's metric names (`hivemall_tpu/runtime/metrics.py`):
- StopWatch elapsed-time logging (ref: utils/datetime/StopWatch.java)
- Hadoop Reporter/Counters for progress + iteration counts
  (ref: UDTFWithOptions.java:59-88)
- the MIX server's ThroughputCounter msgs/sec sampling and metrics
  registry (ref: mixserv/.../metrics/ThroughputCounter.java:34,
  MetricsRegistry.java), with Prometheus-shaped histograms

`trace()` wraps a block in a `torch.profiler` window, so the host ops and
the CUDA kernels it ran land in one Chrome trace (ui.perfetto.dev) — the
port's counterpart of the JAX package's `jax.profiler.trace` window.

`alloc_segment_guard` is the port's counterpart of the JAX package's
`recompile_guard`. Eager torch compiles nothing, so the cold-path cost it
witnesses is different: the segments the CUDA caching allocator has to
request from the driver (`cudaMalloc`) inside the guarded section. A warmed
serving engine must add none in its steady state.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch


class StopWatch:
    def __init__(self, label: str = "") -> None:
        self.label = label
        self._start = time.perf_counter()

    def restart(self) -> None:
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def __str__(self) -> str:
        return f"{self.label} {self.elapsed() * 1000:.1f} ms"


class Counter:
    """A named monotonic counter (Hadoop Counter analog)."""

    def __init__(self, group: str, name: str) -> None:
        self.group = group
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class ThroughputCounter:
    """Events/sec sampled over a sliding window (ThroughputCounter analog)."""

    def __init__(self, window_sec: float = 5.0) -> None:
        self.window = window_sec
        self._events: list = []
        self._lock = threading.Lock()
        self.last_reads_per_sec = 0.0

    def record(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, n))
            cutoff = now - self.window
            while self._events and self._events[0][0] < cutoff:
                self._events.pop(0)
            span = max(1e-9, now - (self._events[0][0] if self._events else now))
            self.last_reads_per_sec = sum(c for _, c in self._events) / max(span, 1e-9)


class Histogram:
    """Fixed-bucket cumulative histogram (the Prometheus histogram shape).

    `buckets` are upper bounds in ascending order; an implicit +Inf bucket
    catches the tail. observe() is lock-guarded and O(len(buckets)).
    """

    # Latency-shaped default: 500us .. 10s, roughly log-spaced (seconds).
    DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5, 10.0)

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS) -> None:
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # [+Inf] is last
        self.sum = 0.0
        self.count = 0
        # bucket index -> (value, trace_id, unix_ts): the last sampled
        # observation that landed there (OpenMetrics exemplar shape) — a
        # bad p99 bucket links straight to a trace in runtime/tracing.py
        self._exemplars: Dict[int, tuple] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        v = float(value)
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        now = time.time() if trace_id is not None else 0.0
        with self._lock:
            self._counts[i] += 1
            self.sum += v
            self.count += 1
            if trace_id is not None:
                self._exemplars[i] = (v, trace_id, now)

    def exemplars(self) -> dict:
        """{bucket_upper_bound: {"value", "trace_id", "unix"}} for buckets
        that have one (the +Inf overflow keys as inf)."""
        with self._lock:
            items = dict(self._exemplars)
        bounds = self.buckets + (float("inf"),)
        return {bounds[i]: {"value": v, "trace_id": tid, "unix": ts}
                for i, (v, tid, ts) in items.items()}

    def snapshot(self) -> dict:
        """{"buckets": [(upper_bound, cumulative_count)...], "sum", "count"}
        with the trailing +Inf bucket included (cumulative == count)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
        cum, out = 0, []
        for ub, c in zip(self.buckets, counts):
            cum += c
            out.append((ub, cum))
        out.append((float("inf"), total))
        return {"buckets": out, "sum": s, "count": total}

    def quantile(self, q: float) -> float:
        """Quantile estimate with linear interpolation inside the holding
        bucket (the Prometheus histogram_quantile formula). Ranks landing in
        the +Inf overflow clamp to the largest finite bound."""
        snap = self.snapshot()
        if not snap["count"] or not self.buckets:
            return 0.0
        rank = q * snap["count"]
        prev_cum, lo = 0, 0.0
        for ub, cum in snap["buckets"]:
            if cum >= rank:
                if ub == float("inf"):
                    return self.buckets[-1]
                in_bucket = cum - prev_cum
                if in_bucket <= 0:
                    return ub
                return lo + (ub - lo) * (rank - prev_cum) / in_bucket
            prev_cum, lo = cum, ub
        return self.buckets[-1]


class MetricsRegistry:
    """Process-wide registry (the JMX MBean registry analog); exportable as a
    plain dict for scraping."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.throughput: Dict[str, ThroughputCounter] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        # registration and snapshot share one lock: the HTTP scrape thread
        # iterates while a serving thread may be registering new keys
        self._lock = threading.Lock()

    def counter(self, group: str, name: str) -> Counter:
        key = f"{group}.{name}"
        with self._lock:
            if key not in self.counters:
                self.counters[key] = Counter(group, name)
            return self.counters[key]

    def meter(self, name: str) -> ThroughputCounter:
        with self._lock:
            if name not in self.throughput:
                self.throughput[name] = ThroughputCounter()
            return self.throughput[name]

    def histogram(self, name: str, buckets=None) -> Histogram:
        with self._lock:
            if name not in self.histograms:
                self.histograms[name] = Histogram(
                    name, buckets if buckets is not None
                    else Histogram.DEFAULT_BUCKETS)
            return self.histograms[name]

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = dict(self.gauges)
            for key, c in self.counters.items():
                out[key] = float(c.value)
            for name, t in self.throughput.items():
                out[f"{name}.per_sec"] = t.last_reads_per_sec
            hists = list(self.histograms.items())
        # histogram locks are taken outside the registry lock (fixed order:
        # registry -> histogram; nothing takes them in reverse)
        for name, h in hists:
            snap = h.snapshot()
            out[f"{name}.count"] = float(snap["count"])
            out[f"{name}.sum"] = float(snap["sum"])
        return out

    def typed_snapshot(self) -> dict:
        """Snapshot keeping metric kinds apart — the Prometheus exposition
        (runtime/metrics_http.py) needs # TYPE per family."""
        with self._lock:
            counters = {k: float(c.value) for k, c in self.counters.items()}
            gauges = dict(self.gauges)
            meters = {f"{n}.per_sec": t.last_reads_per_sec
                      for n, t in self.throughput.items()}
            hists = list(self.histograms.items())
        return {
            "counters": counters,
            "gauges": gauges,
            "meters": meters,
            "histograms": {n: {**h.snapshot(), "exemplars": h.exemplars()}
                           for n, h in hists},
        }


REGISTRY = MetricsRegistry()


def allocator_segments(device) -> int:
    """Segments the CUDA caching allocator has requested from the driver on
    ``device`` since the process started (``segment.all.allocated``); 0 on
    the CPU, which has no such allocator."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    # the nested form skips memory_stats' flatten-and-sort of every stat
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return int(stats.get("segment", {}).get("all", {}).get("allocated", 0))


class alloc_segment_guard:
    """Count the caching-allocator segments a section adds on ``device``.

    The cold path of an eager torch program is memory, not compiles: the
    first request of a new (batch, width) bucket makes the CUDA caching
    allocator ``cudaMalloc`` new segments, which later requests of that
    bucket reuse. Wrap the steady-state section::

        with alloc_segment_guard("serving.ctr", device) as g:
            scores = engine.predict(rows)
        g.segments  # new segments INSIDE the block; 0 after warmup

    Every exit adds ``g.segments`` to the process-wide counter
    ``allocator.new_segments.<name>`` (exported on /metrics as
    ``hivemall_tpu_allocator_new_segments_<name>``) and emits an
    ``alloc_segment`` trace instant when it is not 0, so the request that
    paid for a segment shows it in its trace. ``expect_stable=True`` raises
    on any new segment. The count is per device, not per caller: a
    concurrent deploy's warmup on the same card is counted by whichever
    guard is open at the time.
    """

    def __init__(self, name: str, device, registry: "MetricsRegistry" = None,
                 expect_stable: bool = False) -> None:
        self.name = name
        self.device = torch.device(device)
        self.registry = registry if registry is not None else REGISTRY
        self.expect_stable = expect_stable
        self.segments = 0
        self._start = 0

    def __enter__(self) -> "alloc_segment_guard":
        self._start = allocator_segments(self.device)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.segments = max(0, allocator_segments(self.device) - self._start)
        self.registry.counter("allocator",
                              f"new_segments.{self.name}").increment(
            self.segments)
        if self.segments:
            from .tracing import TRACER

            TRACER.instant("alloc_segment", {"guard": self.name,
                                             "segments": self.segments})
        if exc_type is None and self.expect_stable and self.segments:
            raise RuntimeError(
                f"alloc_segment_guard({self.name!r}): {self.segments} new "
                f"caching-allocator segment(s) on {self.device} in a section "
                f"expected steady — a shape the warmup did not cover")


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None) -> Iterator[None]:
    """Always record the block's wall time as the gauge ``{name}.seconds``;
    with ``log_dir``, run the block under a ``torch.profiler`` window (host
    ops, and the CUDA kernels when a card is present) and write its Chrome
    trace to ``log_dir/{name}.<pid>.<ns>.pt.trace.json``."""
    sw = StopWatch(name)
    if log_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
    else:
        yield
    REGISTRY.set_gauge(f"{name}.seconds", sw.elapsed())
