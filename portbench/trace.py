"""The traced window, reduced: the device's operations and the host's
activity from torch.profiler, in the profiler's own clock.

- `collect(prof)`: the device events (kernels, copies, fills) and the
  host's events (torch ops, CUDA runtime calls, the harness's
  `record_function` spans), read from the profiler's raw kineto events.
- `Trace.busy_s`: seconds in which some operation ran on the device (the
  union of the device events' intervals).
- `Trace.breakdown()`: the device operations that took most time, and the
  device's idle time inside the window summed by what the host was doing:
  the innermost host event running at each idle gap's midpoint, or
  "host: no torch op" (after the harness span it falls in) where the host
  was in Python or numpy alone.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Tuple

Interval = Tuple[int, int]  # ns, [start, end)

HARNESS_SPAN = "portbench."
WINDOW_SPAN = "portbench.window"
NO_OP = "host: no torch op"
_ANONYMOUS = "(anonymous namespace)::"
_HEAD = re.compile(r"^(?:void\s+)?([^<(]*)")


def short_name(name: str) -> str:
    """A device operation's name without `void`, anonymous namespaces,
    template arguments and parameters: `linear_scan_kernel` for
    `void (anonymous namespace)::linear_scan_kernel<5, false, true>(...)`,
    `at::native::vectorized_elementwise_kernel` for its templated name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = _HEAD.match(name.strip().replace(_ANONYMOUS, "")).group(1).strip()
    return head or name


def base_name(name: str) -> str:
    """`short_name` without its namespaces: the function's own name."""
    return short_name(name).rsplit("::", 1)[-1]


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


@dataclass
class Trace:
    device: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]  # sorted by start
    window: Interval

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Interval]:
        merged: List[List[int]] = []
        for _, start, end in sorted(self.device, key=lambda e: e[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel_seconds(self, name: str) -> Tuple[float, int]:
        """(seconds, count) of the device events whose base name is
        `name`."""
        hits = [e - s for n, s, e in self.device if base_name(n) == name]
        return sum(hits) / 1e9, len(hits)

    def idle(self) -> List[Interval]:
        lo, hi = self.window
        gaps, cursor = [], lo
        for start, end in self.busy():
            if start > cursor:
                gaps.append((cursor, min(start, hi)))
            cursor = max(cursor, end)
        if cursor < hi:
            gaps.append((cursor, hi))
        return [(s, e) for s, e in gaps if e > s]

    def _host_labels(self, points: List[int]) -> List[str]:
        """The innermost host event running at each of the sorted
        `points`."""
        labels, stack, i = [], [], 0
        host = self.host
        for p in points:
            while i < len(host) and host[i][1] <= p:
                start = host[i][1]
                while stack and stack[-1][2] <= start:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] <= p:
                stack.pop()
            label = stack[-1][0] if stack else NO_OP
            if label.startswith(HARNESS_SPAN):
                label = f"{label}: {NO_OP}"
            labels.append(label)
        return labels

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(int)
        for name, start, end in self.device:
            by_op[short_name(name)[:120]] += end - start
        gaps = self.idle()
        mids = [(s + e) // 2 for s, e in gaps]
        by_host = defaultdict(int)
        for (s, e), label in zip(gaps, self._host_labels(mids)):
            by_host[label[:120]] += e - s
        return {
            "device_ops": [[n, ns / 1e9] for n, ns in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, ns / 1e9] for n, ns in sorted(
                by_host.items(), key=lambda kv: -kv[1])[:top]],
        }


def collect(prof) -> Trace:
    """The device events and the host events of a finished
    `torch.profiler.profile`; the window is the `portbench.window` span.
    The profiler's mirror of a harness span on the device's timeline is no
    device work and is left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for event in prof.profiler.kineto_results.events():
        start = _ns(event, "start")
        end = start + _ns(event, "duration")
        name = event.name()
        if event.device_type() == cuda:
            if not name.startswith(HARNESS_SPAN):
                device.append((name, start, end))
        elif name == WINDOW_SPAN:
            window = (start, end)
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    device = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in device
              if e > window[0] and s < window[1]]
    host.sort(key=lambda e: (e[1], -e[2]))
    return Trace(device, host, window)
