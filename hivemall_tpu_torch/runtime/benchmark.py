"""Honest device-timing helpers for every throughput benchmark — the port
of `hivemall_tpu/runtime/benchmark.py`.

An asynchronous runtime can acknowledge work before it has run: on the
card, a CUDA launch returns as soon as the kernel is queued, so the
classic "launch N times, wait once at the end" loop can time the enqueue
rate instead of the execution rate. The one sync a runtime cannot fake is
a value round trip: fetching a scalar **computed from the carried state**
(``.item()`` of a tensor the step wrote) waits for the real result.

`honest_timed_loop` therefore times auto-ranged chunks of work, ending
every chunk with such a probe (and verifying a monotone step counter when
the caller provides one), and includes those syncs in the measured wall —
so the reported rate can never exceed what the device sustained.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

_PERMS: dict = {}


def make_workload_ids(rng, shape, dims: int):
    """Benchmark feature ids: log-uniform (heavy-tailed) FREQUENCY with
    hash-UNIFORM placement — the id law of the repo's CTR benchmarks (the
    same distribution as the e2e generator's hashed CTR traffic), byte for
    byte the JAX package's for the same `numpy.random.RandomState`.

    - Frequency: log-uniform over [1, dims) gives a realistic count of
      distinct features an epoch (zipf(1.3) touched so few that a host
      anchor's whole working set stayed cache-resident).
    - Placement: raw samples would put the hot ids in the table's first
      cache lines, a contiguity real murmur-hashed features never have. A
      fixed permutation of the space (seed 12345, cached per `dims`)
      spreads them uniformly and keeps the duplicate multiset."""
    import numpy as np

    if dims not in _PERMS:
        _PERMS[dims] = np.random.RandomState(12345).permutation(
            dims).astype(np.int32)
    u = rng.random_sample(shape)
    ids = np.exp(u * np.log(float(dims))).astype(np.int64) % dims
    return _PERMS[dims][ids]


def honest_timed_loop(
    run_once: Callable[[Any], Any],
    state: Any,
    probe: Callable[[Any], float],
    budget_s: float = 6.0,
    max_chunk: int = 512,
    grow_below_s: float = 0.25,
    expect_probe_delta: Optional[float] = None,
) -> Tuple[int, float, Any]:
    """Run `state = run_once(state)` repeatedly for ~`budget_s` seconds of
    *verified* wall time; return (iterations, elapsed_s, state).

    - `probe(state)` must fetch a scalar derived from the carried state;
      on the card that is ``.item()`` (or a copy to the host) of a tensor
      the step wrote, e.g. ``lambda s: s.weights.sum().item()`` or the
      engine's step counter. A bare ``torch.cuda.synchronize()`` is not a
      probe: it proves nothing about the state the loop carries. The probe
      runs after every chunk and its cost is INCLUDED in elapsed, so
      asynchronous launches cannot inflate the rate. Chunks double (up to
      `max_chunk`) while a chunk completes in under `grow_below_s`
      seconds, keeping the sync overhead under ~1% for fast backends while
      a slow backend stays at chunk = 1.
    - With `expect_probe_delta`, the probe value must advance by
      `expect_probe_delta * chunk` each chunk (e.g. the step counter:
      blocks_per_epoch * batch); a mismatch raises — catching a runtime
      that silently skipped executions. Counters may be int32, so the loop
      also returns early before the cumulative count could reach 2^31 and
      wrap (a fast backend can get there inside the budget).
    """
    chunk = 1
    iters = 0
    last = probe(state)  # also forces any warmup stragglers to finish
    counter_cap = (float(2 ** 31 - 1) - last) \
        if (expect_probe_delta is not None and expect_probe_delta > 0) else None
    t0 = time.perf_counter()
    while True:
        if counter_cap is not None and \
                (iters + chunk) * expect_probe_delta >= counter_cap:
            if iters == 0:
                raise RuntimeError(
                    f"probe counter {last} already within one chunk of int32 "
                    "wrap — reset the state before timing")
            return iters, time.perf_counter() - t0, state
        c0 = time.perf_counter()
        for _ in range(chunk):
            state = run_once(state)
        val = probe(state)
        c1 = time.perf_counter()
        if expect_probe_delta is not None:
            want = last + expect_probe_delta * chunk
            if abs(val - want) > 0.5:
                raise RuntimeError(
                    f"probe counter mismatch: expected {want}, got {val} "
                    f"after {chunk} iteration(s) — executions were dropped?")
        last = val
        iters += chunk
        if c1 - t0 >= budget_s:
            return iters, c1 - t0, state
        if (c1 - c0) < grow_below_s and chunk < max_chunk:
            chunk *= 2


def measure_reference_rowloops(idx, val, lab, dims: int, k: int = 5,
                               budget_s: float = 2.0) -> dict:
    """Time the C transliterations of the reference's per-row hot loops
    (native hm_arow_reference_rowloop / hm_fm_reference_rowloop) on the
    given host arrays — the measured anchor denominators of the repo's
    benchmarks. Parse and boxing costs are excluded (which flatters the
    reference). Returns {"arow_rows_per_sec": ..., "fm_rows_per_sec": ...}.

    The JAX package returns {} when its prebuilt library is missing; the
    port builds its library at first use and raises RuntimeError when it
    cannot (native/__init__.py), so no anchor is ever quietly absent."""
    from .. import native

    out: dict = {}
    n = len(lab)
    # ONE closure per family, used for both the warm-up call and the timed
    # loop, so the warm-up can never exercise another path than the timed
    for name, rowloop in (
        ("arow", lambda i, v, l, s: native.arow_reference_rowloop(
            i, v, l, dims, state=s)),
        ("fm", lambda i, v, l, s: native.fm_reference_rowloop(
            i, v, l, dims, k=k, state=s)),
    ):
        st: dict = {}
        # warms the model tables' allocation so it never lands inside the
        # timed window
        rowloop(idx[:2048], val[:2048], lab[:2048], st)
        t0 = time.perf_counter()
        done = 0
        while time.perf_counter() - t0 < budget_s:
            rowloop(idx, val, lab, st)
            done += n
        out[f"{name}_rows_per_sec"] = round(
            done / (time.perf_counter() - t0), 1)
    return out
