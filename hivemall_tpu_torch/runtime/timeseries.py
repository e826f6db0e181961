"""In-process metrics time series: a bounded ring of periodic snapshots —
the port of `hivemall_tpu/runtime/timeseries.py`.

The registry (runtime/metrics.py) answers "what is the value NOW"; trend
questions — is the shed rate climbing, what was p99 over the last minute,
did freshness regress since the deploy — need history, kept in-process:

- ``TimeSeriesRing`` samples ``REGISTRY.typed_snapshot()`` (exemplars
  stripped — they are debugging payload, not trend data) on a background
  daemon thread every ``interval_s`` into a ``deque(maxlen=capacity)``:
  memory is bounded by construction.
- Queries are windowed over the trailing ``seconds``: ``delta()`` /
  ``rate()`` for counters, ``hist_delta()`` for the cumulative-bucket
  delta of a histogram (the observations INSIDE the window), and
  ``frac_over()`` / ``quantile()`` computed on that delta with the same
  linear interpolation ``Histogram.quantile`` uses.
- ``add_listener(fn)`` runs ``fn(t, snapshot)`` after every sample,
  outside every lock — the SLO engine (runtime/slo.py) evaluates its
  burn rates on this hook, so alert cadence equals sample cadence.

Locking: the ring lock guards only the deque and the bookkeeping scalars;
the registry snapshot is taken BEFORE the ring lock, and listeners run
after it is released. ``clock`` is injectable (tests pin window
arithmetic with a fake clock); the sampler's wait rides the stop Event,
so ``stop()`` never waits out a full interval. ``overhead()`` reports the
fraction of wall time spent inside ``sample_once`` since ``start()``.
All of it is host Python; nothing here touches the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry

# 10 minutes at the 1 Hz default — comfortably past the SLO engine's slow
# window, ~a few MB at serving-stack registry sizes
DEFAULT_INTERVAL_S = 1.0
DEFAULT_CAPACITY = 600


class TimeSeriesRing:
    """Bounded ring of ``(t, typed_snapshot)`` samples with windowed
    queries. One instance per process is the normal shape (the module
    singleton ``RING``); tests build private rings with a fake clock."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.registry = registry if registry is not None else REGISTRY
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._listeners: List[Callable] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sample_seconds = 0.0
        self._samples = 0
        self._errors = 0
        self._started_perf: Optional[float] = None

    # -- sampling -----------------------------------------------------------

    def sample_once(self) -> float:
        """Take one snapshot now; returns its timestamp. The sampler thread
        calls this every interval; tests drive it directly with a fake
        clock. Snapshot and listeners run OUTSIDE the ring lock."""
        t0 = time.perf_counter()
        snap = self.registry.typed_snapshot()
        for h in snap["histograms"].values():
            # exemplars are debugging payload (trace links), not trend
            # data — dropping them keeps samples value-only and bounded
            h.pop("exemplars", None)
        t = self.clock()
        cost = time.perf_counter() - t0
        with self._lock:
            self._ring.append((t, snap))
            self._sample_seconds += cost
            self._samples += 1
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(t, snap)
            except Exception:  # a listener bug must not kill the sampler;
                # the error counter below is the loud signal
                with self._lock:
                    self._errors += 1
                errs = self.registry.counter("timeseries",
                                             "listener_errors")
                errs.increment()
        ov = self.overhead()
        self.registry.set_gauge("timeseries.samples", float(ov["samples"]))
        self.registry.set_gauge("timeseries.sampler.overhead_fraction",
                                ov["fraction"])
        return t

    def _run(self, stop: threading.Event) -> None:
        # Event.wait is the sleep AND the shutdown latch: stop() returns
        # without waiting out an interval. The event arrives as an
        # argument so the loop never reads the rebindable field.
        while not stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # the sampler thread outlives a transient
                # snapshot error; the error counter is the loud signal
                with self._lock:
                    self._errors += 1
                errs = self.registry.counter("timeseries",
                                             "sampler_errors")
                errs.increment()

    def start(self) -> "TimeSeriesRing":
        """Start the background sampler (idempotent); daemon thread, so it
        never blocks interpreter exit."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            stop = threading.Event()
            self._stop = stop
            if self._started_perf is None:
                self._started_perf = time.perf_counter()
            thread = threading.Thread(target=self._run, args=(stop,),
                                      daemon=True,
                                      name="hivemall-tpu-timeseries")
            self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
            stop = self._stop
        stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    def add_listener(self, fn: Callable[[float, dict], None]) -> None:
        """Register ``fn(t, snapshot)`` to run after every sample (outside
        the ring lock). Errors are counted, never raised."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- windowed queries ---------------------------------------------------

    def window(self, seconds: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, dict]]:
        """Samples inside the trailing ``seconds`` (all when None), oldest
        first. ``now`` overrides the clock (deterministic tests)."""
        with self._lock:
            out = list(self._ring)
        if seconds is None:
            return out
        cutoff = (self.clock() if now is None else now) - float(seconds)
        return [s for s in out if s[0] >= cutoff]

    @staticmethod
    def _value(snap: dict, key: str) -> Optional[float]:
        for kind in ("counters", "gauges", "meters"):
            if key in snap[kind]:
                return float(snap[kind][key])
        # histogram scalar fields address as "<name>.count" / "<name>.sum"
        name, _, field = key.rpartition(".")
        h = snap["histograms"].get(name)
        if h is not None and field in ("count", "sum"):
            return float(h[field])
        return None

    def delta(self, key: str, seconds: Optional[float] = None,
              now: Optional[float] = None) -> float:
        """last - first of ``key`` over the window (0.0 when the window
        holds < 2 samples or the key is absent). Meaningful for counters
        and histogram ``.count``/``.sum`` fields."""
        w = self.window(seconds, now=now)
        if len(w) < 2:
            return 0.0
        a = self._value(w[0][1], key)
        b = self._value(w[-1][1], key)
        if a is None or b is None:
            return 0.0
        return b - a

    def rate(self, key: str, seconds: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """delta / actual-window-span, per second (0.0 when the window
        spans no time)."""
        w = self.window(seconds, now=now)
        if len(w) < 2:
            return 0.0
        span = w[-1][0] - w[0][0]
        if span <= 0:
            return 0.0
        a = self._value(w[0][1], key)
        b = self._value(w[-1][1], key)
        if a is None or b is None:
            return 0.0
        return (b - a) / span

    def hist_delta(self, name: str, seconds: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[dict]:
        """Cumulative-bucket delta of histogram ``name`` over the window:
        the observations that happened INSIDE it, in Histogram.snapshot
        shape plus ``span_s``. None when the window holds < 2 samples or
        the histogram never appeared; a histogram born mid-window deltas
        against an implicit zero baseline."""
        w = self.window(seconds, now=now)
        if len(w) < 2:
            return None
        h1 = w[-1][1]["histograms"].get(name)
        if h1 is None:
            return None
        h0 = w[0][1]["histograms"].get(name)
        span = w[-1][0] - w[0][0]
        if h0 is None:
            return {"buckets": [tuple(b) for b in h1["buckets"]],
                    "count": h1["count"], "sum": h1["sum"], "span_s": span}
        return {"buckets": [(ub, c1 - c0)
                            for (ub, c1), (_ub, c0)
                            in zip(h1["buckets"], h0["buckets"])],
                "count": h1["count"] - h0["count"],
                "sum": h1["sum"] - h0["sum"], "span_s": span}

    def frac_over(self, name: str, threshold: float,
                  seconds: Optional[float] = None,
                  now: Optional[float] = None) -> Optional[float]:
        """Fraction of the window's observations ABOVE ``threshold`` —
        the error fraction of a latency/freshness SLO. The cumulative
        count at the threshold is linearly interpolated inside its bucket
        (the histogram_quantile inverse), so a threshold mid-bucket does
        not round a near-miss to a full bucket of misses. None = no
        observations in the window (no evidence either way)."""
        d = self.hist_delta(name, seconds, now=now)
        if d is None or d["count"] <= 0:
            return None
        t = float(threshold)
        prev_cum, lo = 0.0, 0.0
        cum_at = float(d["count"])  # threshold past every finite bound
        for ub, cum in d["buckets"]:
            if t <= ub:
                if ub == float("inf"):
                    # inside the overflow: everything there is "over"
                    cum_at = prev_cum
                elif ub == lo:
                    cum_at = float(cum)
                else:
                    cum_at = prev_cum + (cum - prev_cum) * (t - lo) / (ub - lo)
                break
            prev_cum, lo = float(cum), float(ub)
        frac = 1.0 - cum_at / float(d["count"])
        return min(1.0, max(0.0, frac))

    def quantile(self, name: str, q: float,
                 seconds: Optional[float] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Windowed quantile of histogram ``name`` over the trailing
        window (linear interpolation inside the holding bucket, +Inf
        clamps to the largest finite bound — Histogram.quantile on the
        window's delta). None = no observations in the window."""
        d = self.hist_delta(name, seconds, now=now)
        if d is None or d["count"] <= 0:
            return None
        bounds = [ub for ub, _ in d["buckets"] if ub != float("inf")]
        if not bounds:
            return None
        rank = q * d["count"]
        prev_cum, lo = 0.0, 0.0
        for ub, cum in d["buckets"]:
            if cum >= rank:
                if ub == float("inf"):
                    return bounds[-1]
                in_bucket = cum - prev_cum
                if in_bucket <= 0:
                    return float(ub)
                return lo + (ub - lo) * (rank - prev_cum) / in_bucket
            prev_cum, lo = float(cum), float(ub)
        return bounds[-1]

    # -- introspection ------------------------------------------------------

    def overhead(self) -> dict:
        """Sampler self-accounting: cumulative seconds spent sampling,
        elapsed wall seconds since start(), and their ratio."""
        with self._lock:
            samples, cost = self._samples, self._sample_seconds
            errors, t0 = self._errors, self._started_perf
        elapsed = (time.perf_counter() - t0) if t0 is not None else 0.0
        return {"samples": samples, "sample_seconds": round(cost, 6),
                "elapsed_s": round(elapsed, 6), "errors": errors,
                "fraction": (cost / elapsed) if elapsed > 0 else 0.0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def history(self, seconds: Optional[float] = None,
                max_samples: Optional[int] = None) -> dict:
        """The ring as a JSON-shaped block (the flight recorder's
        time-series section, runtime/debug_bundle.py). ``max_samples``
        subsamples evenly, keeping the newest — a bundle stays bounded
        even at high sample rates."""
        w = self.window(seconds)
        if max_samples is not None and len(w) > int(max_samples):
            n = int(max_samples)
            stride = len(w) / float(n)
            w = [w[min(len(w) - 1, int((i + 1) * stride) - 1)]
                 for i in range(n)]
        return {"interval_s": self.interval_s, "capacity": self.capacity,
                "overhead": self.overhead(),
                "samples": [{"t": t, **snap} for t, snap in w]}


# the process-wide ring (not started by default — a server or bench opts
# in; tests build private rings)
RING = TimeSeriesRing()
