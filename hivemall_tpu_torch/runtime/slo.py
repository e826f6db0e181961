"""Declarative SLOs evaluated as multi-window burn rates over the ring —
the port of `hivemall_tpu/runtime/slo.py`.

- An ``SLO`` declares what "good" means: a latency (or pipeline
  freshness) histogram whose observations must stay under ``threshold_s``
  for at least ``objective`` of events, or an availability ratio over
  good/bad counter sets. The error BUDGET is ``1 - objective``.
- The **burn rate** is ``observed_error_fraction / budget`` over a
  window. Each SLO is evaluated over TWO windows — a fast one (~1m
  default) that reacts, and a slow one (~10m default) that confirms —
  and an alert condition requires BOTH to burn. Windows ride the
  time-series ring (runtime/timeseries.py).
- Each SLO runs an ok -> warn -> page state machine with hysteresis:
  a transition needs ``raise_after`` (or ``clear_after``) CONSECUTIVE
  evaluations agreeing. Transitions are recorded (bounded) and surfaced
  as gauges::

      slo.<name>.burn_fast   slo.<name>.burn_slow   slo.<name>.state

  (state: 0 ok / 1 warn / 2 page) plus ``GET /slo`` on the metrics /
  serving port (runtime/metrics_http.py) and the SLO block inside
  ``GET /healthz`` (serving/server.py).

A window with ZERO observations is "no evidence", not "no burn": the
evaluation reports ``None`` burns and counts toward CLEARING only.

Locking: the engine lock guards the SLO table and per-SLO state; every
ring query and gauge write happens OUTSIDE it. ``evaluate()`` is normally
driven by the ring's sample listener (``attach()``); tests drive it
directly with a fake clock. Host Python only.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import timeseries
from .metrics import REGISTRY, MetricsRegistry

OK, WARN, PAGE = "ok", "warn", "page"
STATE_LEVELS = {OK: 0, WARN: 1, PAGE: 2}
_LEVEL_NAMES = {v: k for k, v in STATE_LEVELS.items()}

# kinds sharing the histogram-threshold evaluator; "availability" uses
# the counter-ratio evaluator
_HISTOGRAM_KINDS = ("latency", "freshness")
KINDS = _HISTOGRAM_KINDS + ("availability",)


@dataclass(frozen=True)
class SLO:
    """One declarative objective. ``kind``:

    - ``"latency"`` / ``"freshness"``: at least ``objective`` of
      ``histogram``'s observations stay under ``threshold_s`` seconds;
    - ``"availability"``: bad events (sum of ``bad_keys`` counter deltas)
      stay under ``1 - objective`` of all events (good + bad) — e.g.
      good = accepted, bad = shed + expired + quota-rejected.
    """

    name: str
    kind: str = "latency"
    objective: float = 0.99
    histogram: Optional[str] = None
    threshold_s: Optional[float] = None
    good_keys: Tuple[str, ...] = ()
    bad_keys: Tuple[str, ...] = ()
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    # burn thresholds: the condition needs BOTH windows at/above
    warn_burn: float = 1.0
    page_burn: float = 2.0
    # hysteresis: consecutive agreeing evaluations to move up / down
    raise_after: int = 2
    clear_after: int = 2
    # attribution shown on /slo (which model, which pipeline)
    labels: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"SLO {self.name!r}: unknown kind "
                             f"{self.kind!r} (one of {KINDS})")
        if self.kind in _HISTOGRAM_KINDS and (
                not self.histogram or self.threshold_s is None):
            raise ValueError(f"SLO {self.name!r}: kind {self.kind!r} "
                             f"needs histogram= and threshold_s=")
        if self.kind == "availability" and not self.bad_keys:
            raise ValueError(f"SLO {self.name!r}: kind 'availability' "
                             f"needs bad_keys= (and usually good_keys=)")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name!r}: objective must be in "
                             f"(0, 1), got {self.objective}")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


class _SLOState:
    """Mutable per-SLO alert state (engine-lock guarded)."""

    def __init__(self) -> None:
        self.state = OK
        self.up_streak = 0
        self.down_streak = 0
        self.peak = OK  # the highest state since registration
        self.last: Optional[dict] = None
        self.transitions: List[dict] = []
        self.evals = 0


class SLOEngine:
    """Evaluates registered SLOs against a TimeSeriesRing. One per
    process is the normal shape (module singleton ``ENGINE``); tests
    build private engines over private rings."""

    MAX_TRANSITIONS = 64

    def __init__(self, ring: Optional[timeseries.TimeSeriesRing] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.ring = ring if ring is not None else timeseries.RING
        self.registry = registry if registry is not None else REGISTRY
        self.clock = clock
        self._lock = threading.Lock()
        self._slos: Dict[str, Tuple[SLO, _SLOState]] = {}
        self._listener: Optional[Callable] = None
        self._last_eval_t: Optional[float] = None

    # -- registration -------------------------------------------------------

    def register(self, slo: SLO) -> SLO:
        """Add (or replace — state resets) an objective."""
        with self._lock:
            self._slos[slo.name] = (slo, _SLOState())
        return slo

    def remove(self, name: str) -> bool:
        with self._lock:
            return self._slos.pop(name, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._slos = {}

    def attach(self) -> None:
        """Evaluate on every ring sample (idempotent) — the production
        wiring: alert cadence equals sampler cadence."""
        with self._lock:
            if self._listener is not None:
                return
            listener = self._listener = lambda t, snap: self.evaluate(now=t)
        self.ring.add_listener(listener)

    def detach(self) -> None:
        with self._lock:
            listener, self._listener = self._listener, None
        if listener is not None:
            self.ring.remove_listener(listener)

    # -- evaluation ---------------------------------------------------------

    def _burn(self, slo: SLO, window_s: float,
              now: Optional[float]) -> Optional[float]:
        """Burn rate of one window; None = no events in it."""
        if slo.kind in _HISTOGRAM_KINDS:
            frac = self.ring.frac_over(slo.histogram, slo.threshold_s,
                                       window_s, now=now)
            if frac is None:
                return None
            return frac / slo.budget
        good = sum(self.ring.delta(k, window_s, now=now)
                   for k in slo.good_keys)
        bad = sum(self.ring.delta(k, window_s, now=now)
                  for k in slo.bad_keys)
        total = good + bad
        if total <= 0:
            return None
        return (bad / total) / slo.budget

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Evaluate every SLO once: compute both burns, advance the state
        machines, set the gauges. Returns {name: evaluation}. Ring reads
        and gauge writes happen outside the engine lock."""
        t = self.clock() if now is None else now
        with self._lock:
            table = [(slo, st) for slo, st in self._slos.values()]
        results: Dict[str, dict] = {}
        gauge_writes = []
        for slo, st in table:
            fast = self._burn(slo, slo.fast_window_s, now)
            slow = self._burn(slo, slo.slow_window_s, now)

            def _cond(threshold):
                return (fast is not None and slow is not None
                        and fast >= threshold and slow >= threshold)

            target = PAGE if _cond(slo.page_burn) \
                else WARN if _cond(slo.warn_burn) else OK
            with self._lock:
                # the registration may have been swapped mid-evaluation;
                # only advance the state object still in the table
                cur = self._slos.get(slo.name)
                if cur is None or cur[1] is not st:
                    continue
                st.evals += 1
                lvl, cur_lvl = STATE_LEVELS[target], STATE_LEVELS[st.state]
                if lvl > cur_lvl:
                    st.up_streak += 1
                    st.down_streak = 0
                    if st.up_streak >= slo.raise_after:
                        st.transitions.append(
                            {"t": t, "from": st.state, "to": target,
                             "burn_fast": fast, "burn_slow": slow})
                        del st.transitions[:-self.MAX_TRANSITIONS]
                        st.state = target
                        st.up_streak = st.down_streak = 0
                elif lvl < cur_lvl:
                    st.down_streak += 1
                    st.up_streak = 0
                    if st.down_streak >= slo.clear_after:
                        st.transitions.append(
                            {"t": t, "from": st.state, "to": target,
                             "burn_fast": fast, "burn_slow": slow})
                        del st.transitions[:-self.MAX_TRANSITIONS]
                        st.state = target
                        st.up_streak = st.down_streak = 0
                else:
                    st.up_streak = st.down_streak = 0
                if STATE_LEVELS[st.state] > STATE_LEVELS[st.peak]:
                    st.peak = st.state
                st.last = {
                    "t": t, "burn_fast": fast, "burn_slow": slow,
                    "condition": target, "state": st.state,
                }
                results[slo.name] = dict(st.last)
                state_now = st.state
            gauge_writes.append((slo.name, fast, slow, state_now))
        for name, fast, slow, state_now in gauge_writes:
            self.registry.set_gauge(f"slo.{name}.burn_fast",
                                    fast if fast is not None else 0.0)
            self.registry.set_gauge(f"slo.{name}.burn_slow",
                                    slow if slow is not None else 0.0)
            self.registry.set_gauge(f"slo.{name}.state",
                                    float(STATE_LEVELS[state_now]))
        with self._lock:
            self._last_eval_t = t
        return results

    # -- reporting ----------------------------------------------------------

    def status(self) -> dict:
        """The ``GET /slo`` document: every objective's declaration, live
        burns, state, peak and recent transitions. Reads the LAST
        evaluation — scrapes never advance the hysteresis clocks."""
        with self._lock:
            table = [(slo, st) for slo, st in self._slos.values()]
            last_t = self._last_eval_t
        slos = {}
        worst = OK
        for slo, st in table:
            with self._lock:
                last = dict(st.last) if st.last else None
                transitions = [dict(x) for x in st.transitions[-16:]]
                state, peak, evals = st.state, st.peak, st.evals
            if STATE_LEVELS[state] > STATE_LEVELS[worst]:
                worst = state
            slos[slo.name] = {
                "kind": slo.kind,
                "objective": slo.objective,
                "budget": slo.budget,
                **({"histogram": slo.histogram,
                    "threshold_s": slo.threshold_s}
                   if slo.kind in _HISTOGRAM_KINDS else
                   {"good_keys": list(slo.good_keys),
                    "bad_keys": list(slo.bad_keys)}),
                "windows_s": {"fast": slo.fast_window_s,
                              "slow": slo.slow_window_s},
                "burn_thresholds": {"warn": slo.warn_burn,
                                    "page": slo.page_burn},
                "hysteresis": {"raise_after": slo.raise_after,
                               "clear_after": slo.clear_after},
                "labels": dict(slo.labels),
                "state": state,
                "peak_state": peak,
                "evaluations": evals,
                "last": last,
                "transitions": transitions,
            }
        return {"worst_state": worst, "last_eval_t": last_t,
                "slos": slos}

    def health_block(self) -> dict:
        """Compact block for /healthz: worst state + which SLOs are
        paging/warning. ``evaluated`` False = no evaluation has run yet
        (sampler not started) — health routing must not trust it."""
        with self._lock:
            states = {name: st.state for name, (_s, st) in self._slos.items()}
            evaluated = self._last_eval_t is not None
        worst = OK
        for s in states.values():
            if STATE_LEVELS[s] > STATE_LEVELS[worst]:
                worst = s
        return {"worst_state": worst,
                "paging": sorted(n for n, s in states.items() if s == PAGE),
                "warning": sorted(n for n, s in states.items() if s == WARN),
                "evaluated": evaluated}


# the process-wide engine over the process-wide ring; serving and the
# daemon register objectives here, GET /slo and /healthz read it
ENGINE = SLOEngine()
