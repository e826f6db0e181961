"""The device's idle time spent inside the program's own host spans.

The port's tracer (`hivemall_tpu_torch/runtime/tracing.py`) mirrors its
spans and per-block phases onto torch.profiler's host timeline as events of
the same name (`fit.stage`, `fit.pack`, ...), so they arrive in
`Trace.host` beside the torch ops. `idle_share` reads, for a set of those
names, the part of the traced window in which the device ran nothing while
the host was inside one of them.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[int, int]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The sorted, disjoint union of `intervals`."""
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """Nanoseconds in both of two sorted, disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(trace, names) -> Optional[float]:
    """Seconds of `trace`'s window in which the device was idle and the
    host inside an event named in `names` (their union, clipped to the
    window, so a nested or repeated span counts once); None when the trace
    holds no such event."""
    hits = [(s, e) for n, s, e in trace.host if n in names]
    if not hits:
        return None
    lo, hi = trace.window
    inside = union((max(s, lo), min(e, hi)) for s, e in hits
                   if e > lo and s < hi)
    return overlap_ns(inside, trace.idle()) / 1e9


def idle_share(view, names) -> Optional[float]:
    """`idle_inside` as a share of the window, in %."""
    seconds = idle_inside(view.trace, frozenset(names))
    if seconds is None or not view.window_s:
        return None
    return 100.0 * seconds / view.window_s
