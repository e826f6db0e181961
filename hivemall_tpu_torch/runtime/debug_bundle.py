"""Flight recorder: one self-contained JSON snapshot of the whole process —
the port of `hivemall_tpu/runtime/debug_bundle.py`, with the same
``SECTIONS``:

- ``versions`` + ``device_set``: what code ran on what hardware (torch and
  its CUDA devices, the card's power limit where ``nvidia-smi`` answers);
- ``models``: the serving registry's full ``describe()`` per model —
  placement, admission state, lineage, retrieval;
- ``metrics``: the registry's typed snapshot (exemplars included — in a
  postmortem the trace links ARE the payload);
- ``timeseries``: the recent history ring (runtime/timeseries.py);
- ``slo``: every objective's burn rates, state and transition history;
- ``traces``: the last-N committed traces including the slow reserve, the
  top-5 slowest, and the per-stage breakdown (runtime/tracing.py);
- ``recompiles``: the key is the JAX package's, where it holds the jit
  retrace counters. Eager torch compiles nothing; the port's cold path is
  the CUDA caching allocator requesting new segments
  (runtime/metrics.alloc_segment_guard), so the section holds the
  ``allocator.new_segments.<guard>`` counters.

Two consumers: ``GET /debug/bundle`` (runtime/metrics_http.py) and
``write_crash_bundle`` at the pipeline's supervisor give-up
(pipeline/loop.py). The crash writer NEVER raises: masking the original
exception with a telemetry error would be worse than losing the bundle.

Strict JSON: ``float('inf')`` histogram bounds and NaN gauges become
strings / None (``json.dumps`` would emit ``Infinity``, which strict
decoders reject).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

from .metrics import REGISTRY
from .tracing import TRACER

BUNDLE_VERSION = 1

# every top-level section a complete bundle carries
SECTIONS = ("bundle_version", "generated_unix", "reason", "versions",
            "device_set", "models", "health", "metrics", "timeseries",
            "slo", "traces", "recompiles")

_SEGMENTS_PREFIX = "allocator.new_segments."


def _sanitize(obj):
    """Strict-JSON walker: inf/-inf/NaN floats become "+Inf"/"-Inf"/None,
    tuples become lists, dict keys become strings (histogram bucket maps
    key on float bounds), unknown objects fall back to repr."""
    if isinstance(obj, float):
        if math.isinf(obj):
            return "+Inf" if obj > 0 else "-Inf"
        if math.isnan(obj):
            return None
        return obj
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {_key(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_sanitize(v) for v in obj]
    item = getattr(obj, "item", None)
    if callable(item):  # numpy scalars and 0-d tensors
        try:
            return _sanitize(item())
        except Exception:  # best effort: repr below is the fallback
            pass
    return repr(obj)


def _key(k) -> str:
    if isinstance(k, str):
        return k
    if isinstance(k, float) and math.isinf(k):
        return "+Inf" if k > 0 else "-Inf"
    return str(k)


def _versions() -> dict:
    from ..constants import VERSION

    out = {"hivemall_tpu_torch": VERSION,
           "python": sys.version.split()[0]}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = __import__(mod).__version__
        except Exception:  # an absent dependency is recorded as absent
            out[mod] = None
    try:
        import torch

        out["cuda"] = torch.version.cuda
    except Exception:
        out["cuda"] = None
    return out


def _power_limits() -> Optional[list]:
    """``nvidia-smi``'s name and power limit per card, None where it does
    not answer (no driver, no card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout
    except Exception:  # no nvidia-smi here: the field records None
        return None
    return [line.strip() for line in out.splitlines() if line.strip()]


def _device_set() -> dict:
    """The process's devices from torch: platform, CUDA device count and
    names, its place in a torch.distributed group, and the power limits."""
    try:
        import torch
        import torch.distributed as dist

        cuda = torch.cuda.is_available()
        group = dist.is_available() and dist.is_initialized()
        n = torch.cuda.device_count() if cuda else 0
        return {"platform": "gpu" if cuda else "cpu",
                "device_count": n,
                "local_device_count": n,
                "process_count": dist.get_world_size() if group else 1,
                "process_index": dist.get_rank() if group else 0,
                "device_kinds": sorted({torch.cuda.get_device_name(i)
                                        for i in range(n)}),
                "power_limits": _power_limits() if cuda else None}
    except Exception:  # a bundle written mid-teardown records the absence
        return {"platform": None}


def build_bundle(registry=None, reason: str = "on-demand",
                 n_traces: int = 50,
                 history_s: Optional[float] = None,
                 max_history_samples: int = 240) -> dict:
    """The bundle as a strictly-JSON-safe dict. ``registry`` is a serving
    ``ModelRegistry`` when one exists (the /debug/bundle handler passes
    the server's); None leaves ``models`` empty and ``health`` None."""
    from . import timeseries
    from .slo import ENGINE

    models, health = [], None
    if registry is not None:
        try:
            models = registry.list_models()
            health = registry.health()
        except Exception as e:  # a registry mid-shutdown: the error IS
            health = {"error": repr(e)}  # the section's content
    snap = REGISTRY.snapshot()
    bundle = {
        "bundle_version": BUNDLE_VERSION,
        "generated_unix": time.time(),
        "reason": reason,
        "versions": _versions(),
        "device_set": _device_set(),
        "models": models,
        "health": health,
        "metrics": REGISTRY.typed_snapshot(),
        "timeseries": timeseries.RING.history(
            seconds=history_s, max_samples=max_history_samples),
        "slo": ENGINE.status(),
        "traces": {
            "last": TRACER.traces(n_traces),
            "slowest": TRACER.slowest(5),
            "stage_breakdown_ms": TRACER.stage_breakdown(),
            "dropped": TRACER.dropped,
        },
        "recompiles": {
            "counters": {k[len(_SEGMENTS_PREFIX):]: v
                         for k, v in snap.items()
                         if k.startswith(_SEGMENTS_PREFIX)},
            "source": "allocator.new_segments",
        },
    }
    return _sanitize(bundle)


def write_bundle(path: str, registry=None, reason: str = "on-demand",
                 **kwargs) -> str:
    """Build and write a bundle to ``path`` atomically (tmp + replace — a
    crash mid-write leaves no half-bundle). Raises on IO errors; the crash
    path wants ``write_crash_bundle`` instead."""
    doc = build_bundle(registry=registry, reason=reason, **kwargs)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return path


def write_crash_bundle(path: str, reason: str,
                       registry=None) -> Optional[str]:
    """``write_bundle`` that NEVER raises — the pipeline's give-up path
    calls it right before re-raising the fatal exception, and a telemetry
    failure must not mask that. Returns the path, or None when the write
    failed."""
    try:
        return write_bundle(path, registry=registry, reason=reason)
    except Exception:  # the caller's exception is already the signal
        return None
