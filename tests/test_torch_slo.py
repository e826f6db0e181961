"""The port's time-series ring, SLO burn-rate engine and flight-recorder
bundle (hivemall_tpu_torch/runtime/{timeseries,slo,debug_bundle}.py)
against the JAX package's, on the CPU.

A port counterpart of each test of tests/test_slo.py (private rings and
engines over private registries with a fake clock — no background threads
except the sampler's own test, no wall time), then:

- parity: the same histogram and counter feeds through the JAX package's
  engine and the port's give the same burn rates, states and transitions;
- the bundle carries JAX's ``SECTIONS`` and is strict JSON; ``GET /slo``
  and ``GET /debug/bundle`` answer on the port's metrics server and on its
  serving server, where the bundle describes the registry.

None of the JAX functions used here is red on this tree (tests/test_slo.py
passes on it).
"""

import json
import threading

import pytest

from hivemall_tpu_torch.runtime.metrics import MetricsRegistry
from hivemall_tpu_torch.runtime.slo import SLO, SLOEngine
from hivemall_tpu_torch.runtime.timeseries import TimeSeriesRing


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


def _ring(capacity=600, t0=100.0):
    reg = MetricsRegistry()
    clock = FakeClock(t0)
    return TimeSeriesRing(registry=reg, capacity=capacity,
                          clock=clock), reg, clock


# --- the ring ------------------------------------------------------------


def test_ring_memory_is_bounded_by_construction():
    ring, reg, clock = _ring(capacity=5)
    c = reg.counter("t", "n")
    for i in range(23):
        c.increment()
        ring.sample_once()
        clock.tick()
    assert len(ring) == 5
    window = ring.window()
    assert len(window) == 5
    # oldest fell off the far end: the surviving samples are the last 5
    assert [t for t, _snap in window] == [118.0, 119.0, 120.0, 121.0,
                                          122.0]
    # history subsampling keeps the NEWEST sample and never exceeds the
    # requested count
    hist = ring.history(max_samples=3)
    assert len(hist["samples"]) == 3
    assert hist["samples"][-1]["t"] == 122.0


def test_windowed_counter_delta_and_rate():
    ring, reg, clock = _ring()
    c = reg.counter("serving", "rows")
    for add in (0, 10, 10, 40):
        c.increment(add)
        ring.sample_once()
        clock.tick()
    now = clock.t  # 104; samples at 100(0) 101(10) 102(20) 103(60)
    assert ring.delta("serving.rows", 2.5, now=now) == 40.0
    # rate divides by the ACTUAL sample span inside the window (1 s
    # between the two surviving samples), not the requested width
    assert ring.rate("serving.rows", 2.5, now=now) == pytest.approx(40.0)
    assert ring.delta("serving.rows", 3.5, now=now) == 50.0
    assert ring.rate("serving.rows", 3.5, now=now) == pytest.approx(25.0)
    # a window holding < 2 samples has no slope to report
    assert ring.delta("serving.rows", 0.5, now=now) == 0.0
    assert ring.rate("missing.key", 10.0, now=now) == 0.0


def test_windowed_histogram_frac_over_and_quantile():
    ring, reg, clock = _ring()
    h = reg.histogram("lat", buckets=(0.01, 0.1, 1.0))
    ring.sample_once()
    clock.tick()
    for v in (0.005, 0.05, 0.05, 0.5):  # 1 under 0.01, 2 in (0.01,0.1], 1 over
        h.observe(v)
    ring.sample_once()
    now = clock.tick()
    # threshold at a bucket bound: exactly 1 of 4 observations is over 0.1
    assert ring.frac_over("lat", 0.1, 5.0, now=now) == pytest.approx(0.25)
    # threshold mid-bucket interpolates linearly inside (0.01, 0.1]
    mid = ring.frac_over("lat", 0.055, 5.0, now=now)
    assert 0.25 < mid < 0.75
    # windowed quantile: p50 inside the middle bucket, p100 clamps to the
    # largest finite bound (never +Inf)
    q50 = ring.quantile("lat", 0.5, 5.0, now=now)
    assert 0.01 < q50 <= 0.1
    assert ring.quantile("lat", 1.0, 5.0, now=now) == 1.0
    # no observations in the window -> None (no evidence, not zero)
    ring.sample_once()
    later = clock.tick()
    assert ring.frac_over("lat", 0.1, 0.9, now=later) is None


def test_sampler_listener_errors_are_counted_not_raised():
    ring, reg, clock = _ring()
    seen = []
    ring.add_listener(lambda t, snap: seen.append(t))
    ring.add_listener(lambda t, snap: 1 / 0)
    ring.sample_once()
    assert seen == [100.0]
    assert ring.overhead()["errors"] == 1
    assert reg.snapshot()["timeseries.listener_errors"] == 1


def test_sampler_thread_starts_and_stops():
    """The real background thread (no fake clock): starts, samples at
    least once, stops promptly, and start() is idempotent."""
    reg = MetricsRegistry()
    ring = TimeSeriesRing(registry=reg, interval_s=0.01, capacity=16)
    ring.start()
    ring.start()  # idempotent: no second thread
    deadline = threading.Event()
    for _ in range(200):
        if len(ring) >= 2:
            break
        deadline.wait(0.01)
    ring.stop()
    assert len(ring) >= 2
    n = len(ring)
    deadline.wait(0.05)
    assert len(ring) == n, "sampler must stop sampling after stop()"


# --- the SLO engine ------------------------------------------------------


def _latency_world(objective=0.9, threshold=0.1, fast=3.0, slow=9.0,
                   **slo_kw):
    """A deterministic world: private ring/registry/engine sharing one
    fake clock, a latency histogram, and a drive(seconds, value) helper
    feeding 10 observations per 1 s tick."""
    reg = MetricsRegistry()
    clock = FakeClock(1000.0)
    ring = TimeSeriesRing(registry=reg, clock=clock)
    engine = SLOEngine(ring=ring, registry=reg, clock=clock)
    h = reg.histogram("lat", buckets=(0.01, 0.1, 1.0))
    engine.register(SLO(name="svc", kind="latency", histogram="lat",
                        threshold_s=threshold, objective=objective,
                        fast_window_s=fast, slow_window_s=slow,
                        warn_burn=1.0, page_burn=2.0, **slo_kw))

    def drive(value):
        """One tick: 10 observations at `value` seconds, sample, eval."""
        for _ in range(10):
            h.observe(value)
        ring.sample_once()
        out = engine.evaluate(now=clock.t)
        clock.tick()
        return out["svc"]

    return reg, ring, engine, drive


def test_burn_alert_fires_after_raise_after_and_clears():
    reg, ring, engine, drive = _latency_world()
    # good traffic: burn 0 in both windows, state pinned ok
    for _ in range(10):
        ev = drive(0.01)
        assert ev["state"] == "ok" and ev["burn_fast"] in (None, 0.0)
    # every observation breaches: frac_over 1.0 / budget 0.1 = burn 10
    states = [drive(0.5)["state"] for _ in range(6)]
    # eval 1 breaching: still ok (streak 1 < raise_after 2); eval 2: page
    assert states[0] == "ok"
    assert states[1] == "page"
    assert set(states[2:]) == {"page"}
    st = engine.status()["slos"]["svc"]
    assert st["peak_state"] == "page"
    assert st["transitions"][-1]["from"] == "ok"
    assert st["transitions"][-1]["to"] == "page"
    # the fast window still holds a healthy tick at transition time, so
    # the recorded burn is diluted below the all-bad 10.0 — but it must
    # sit at/above the page threshold it fired on
    assert st["transitions"][-1]["burn_fast"] >= 2.0
    # gauges surfaced for /metrics scrapes
    snap = reg.snapshot()
    assert snap["slo.svc.state"] == 2.0
    assert snap["slo.svc.burn_fast"] == pytest.approx(10.0)
    # recovery: good traffic must age the breach out of BOTH windows,
    # then clear_after consecutive clean evaluations drop the state
    states = [drive(0.01)["state"] for _ in range(14)]
    assert states[-1] == "ok"
    assert reg.snapshot()["slo.svc.state"] == 0.0
    # the full lifecycle is exactly two transitions: up once, down once
    trans = engine.status()["slos"]["svc"]["transitions"]
    assert [(x["from"], x["to"]) for x in trans] == [("ok", "page"),
                                                     ("page", "ok")]


def test_hysteresis_never_flaps_on_alternating_evals():
    """A condition that alternates breach/clean every evaluation can
    never move the state machine: every streak dies at 1 < raise_after."""
    reg, ring, engine, drive = _latency_world(fast=1.5, slow=1.5)
    # short windows: each tick's evaluation sees mostly the last second
    states = []
    for i in range(16):
        states.append(drive(0.5 if i % 2 else 0.01)["state"])
    assert set(states) == {"ok"}, states
    assert engine.status()["slos"]["svc"]["transitions"] == []
    assert engine.status()["slos"]["svc"]["peak_state"] == "ok"


def test_slow_window_blocks_brief_spike_from_paging():
    """Multi-window discipline: a spike shorter than the slow window's
    memory breaches the fast window but not the slow one — no page."""
    reg, ring, engine, drive = _latency_world(fast=2.0, slow=30.0)
    for _ in range(20):
        drive(0.01)  # a long healthy history dilutes the slow window
    states = [drive(0.5)["state"] for _ in range(3)]
    ev = engine.status()["slos"]["svc"]["last"]
    assert ev["burn_fast"] >= 2.0, "fast window must see the spike"
    assert ev["burn_slow"] < 2.0, "slow window must dilute it"
    assert set(states) == {"ok"}, states


def test_no_data_is_clearing_evidence_not_burn():
    reg, ring, engine, drive = _latency_world()
    # an idle process: evaluations with an EMPTY ring window never page
    clock = ring.clock
    for _ in range(5):
        ring.sample_once()
        ev = engine.evaluate(now=clock.t)["svc"]
        clock.tick()
        assert ev["burn_fast"] is None and ev["state"] == "ok"
    # page it, then stop traffic entirely: None-burn evaluations count
    # toward clearing, so the alert drains instead of paging forever
    for _ in range(3):
        drive(0.5)
    assert engine.status()["slos"]["svc"]["state"] == "page"
    for _ in range(14):
        ring.sample_once()
        last = engine.evaluate(now=clock.t)["svc"]
        clock.tick()
    assert last["burn_fast"] is None
    assert last["state"] == "ok"


def test_availability_slo_counter_ratio():
    reg = MetricsRegistry()
    clock = FakeClock(1000.0)
    ring = TimeSeriesRing(registry=reg, clock=clock)
    engine = SLOEngine(ring=ring, registry=reg, clock=clock)
    good = reg.counter("b", "accepted")
    bad = reg.counter("b", "shed")
    engine.register(SLO(name="avail", kind="availability", objective=0.9,
                        good_keys=("b.accepted",), bad_keys=("b.shed",),
                        fast_window_s=3.0, slow_window_s=3.0,
                        raise_after=1, clear_after=1))
    ring.sample_once()
    clock.tick()
    good.increment(90)
    bad.increment(10)  # bad fraction 0.1 = budget -> burn exactly 1.0
    ring.sample_once()
    ev = engine.evaluate(now=clock.t)["avail"]
    assert ev["burn_fast"] == pytest.approx(1.0)
    assert ev["state"] == "warn"  # warn_burn 1.0, raise_after 1
    clock.tick()
    good.increment(50)
    bad.increment(50)  # 0.5 bad / 0.1 budget = burn 5 -> page
    ring.sample_once()
    assert engine.evaluate(now=clock.t)["avail"]["state"] == "page"


def test_slo_declaration_validation():
    with pytest.raises(ValueError, match="unknown kind"):
        SLO(name="x", kind="vibes")
    with pytest.raises(ValueError, match="histogram="):
        SLO(name="x", kind="latency")  # no histogram/threshold
    with pytest.raises(ValueError, match="bad_keys="):
        SLO(name="x", kind="availability")
    with pytest.raises(ValueError, match="objective"):
        SLO(name="x", kind="latency", histogram="h", threshold_s=0.1,
            objective=1.0)


def test_register_replace_resets_state_and_health_block():
    reg, ring, engine, drive = _latency_world()
    for _ in range(3):
        drive(0.5)
    assert engine.health_block() == {
        "worst_state": "page", "paging": ["svc"], "warning": [],
        "evaluated": True}
    # re-registering the same name is a fresh objective: state resets
    slo = engine.status()["slos"]["svc"]
    engine.register(SLO(name="svc", kind="latency", histogram="lat",
                        threshold_s=0.1, objective=0.9))
    assert engine.status()["slos"]["svc"]["state"] == "ok"
    assert slo["state"] == "page"  # the old document was a snapshot


# --- the bundle + endpoints ----------------------------------------------


def _strict_loads(text):
    """json.loads that REJECTS Infinity/-Infinity/NaN — the strictness
    the bundle promises to any non-Python consumer."""
    return json.loads(text, parse_constant=lambda s: pytest.fail(
        f"bundle emitted non-strict JSON constant {s}"))


def test_bundle_complete_and_strict_json():
    from hivemall_tpu_torch.runtime.debug_bundle import SECTIONS, build_bundle
    from hivemall_tpu_torch.runtime.metrics import REGISTRY

    # guarantee the process registry holds the classic strictness traps:
    # a histogram (+Inf bucket bound) and a NaN gauge
    REGISTRY.histogram("slo_test.lat").observe(0.05)
    REGISTRY.set_gauge("slo_test.nan", float("nan"))
    bundle = build_bundle(reason="unit-test")
    assert all(s in bundle for s in SECTIONS)
    assert bundle["reason"] == "unit-test"
    assert bundle["bundle_version"] == 1
    doc = json.dumps(bundle)
    assert "Infinity" not in doc and "NaN" not in doc
    rt = _strict_loads(doc)
    # the +Inf bucket bound survives as the string marker
    buckets = rt["metrics"]["histograms"]["slo_test.lat"]["buckets"]
    assert buckets[-1][0] == "+Inf"
    assert rt["metrics"]["gauges"]["slo_test.nan"] is None


def test_slo_and_bundle_http_endpoints():
    from hivemall_tpu_torch.runtime.debug_bundle import SECTIONS
    from hivemall_tpu_torch.runtime.metrics_http import serve_metrics
    from hivemall_tpu_torch.runtime.slo import ENGINE

    import urllib.request

    server = serve_metrics(port=0)
    port = server.server_address[1]
    try:
        ENGINE.register(SLO(name="unit.ep", kind="latency",
                            histogram="slo_test.lat", threshold_s=0.1,
                            objective=0.9, labels={"suite": "unit"}))
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/slo", timeout=10) as r:
                doc = _strict_loads(r.read().decode())
            assert "unit.ep" in doc["slos"]
            assert doc["slos"]["unit.ep"]["labels"] == {"suite": "unit"}
            assert doc["slos"]["unit.ep"]["state"] == "ok"
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/bundle?n=5",
                    timeout=10) as r:
                bundle = _strict_loads(r.read().decode())
            assert all(s in bundle for s in SECTIONS)
            # the bare metrics endpoint has no serving registry: the
            # models section is present but empty
            assert bundle["models"] == []
            assert "unit.ep" in bundle["slo"]["slos"]
        finally:
            ENGINE.remove("unit.ep")
    finally:
        server.shutdown()


# --- parity with the JAX package's engine ----------------------------------


def _world(pkg, kind):
    """A private ring / registry / engine of one package over one fake
    clock, with a latency histogram and an availability pair."""
    if pkg == "jax":
        from hivemall_tpu.runtime.metrics import MetricsRegistry as R
        from hivemall_tpu.runtime.slo import SLO as S
        from hivemall_tpu.runtime.slo import SLOEngine as E
        from hivemall_tpu.runtime.timeseries import TimeSeriesRing as T
    else:
        R, S, E, T = MetricsRegistry, SLO, SLOEngine, TimeSeriesRing
    reg = R()
    clock = FakeClock(1000.0)
    ring = T(registry=reg, clock=clock)
    engine = E(ring=ring, registry=reg, clock=clock)
    engine.register(S(name="lat", kind=kind, histogram="h",
                      threshold_s=0.1, objective=0.9, fast_window_s=3.0,
                      slow_window_s=9.0)
                    if kind != "availability" else
                    S(name="lat", kind=kind, objective=0.9,
                      good_keys=("b.ok",), bad_keys=("b.shed",),
                      fast_window_s=3.0, slow_window_s=9.0,
                      raise_after=2, clear_after=3))
    return reg, ring, engine, clock


@pytest.mark.parametrize("kind", ["latency", "freshness", "availability"])
def test_burn_rates_states_and_transitions_equal_jax(kind):
    """One seeded feed of observations (or good / bad counts) per tick
    through both packages: every evaluation, the status document and the
    gauges agree."""
    rng = __import__("numpy").random.RandomState(5)
    worlds = {p: _world(p, kind) for p in ("jax", "port")}
    evals = {p: [] for p in worlds}
    for tick in range(40):
        phase = (tick // 8) % 3  # healthy, bad, mixed
        vals = rng.exponential((0.02, 0.6, 0.12)[phase], 10).tolist()
        ok, shed = int(rng.randint(50, 100)), int(
            rng.randint(0, (2, 40, 12)[phase]))
        for p, (reg, ring, engine, clock) in worlds.items():
            if kind == "availability":
                reg.counter("b", "ok").increment(ok)
                reg.counter("b", "shed").increment(shed)
            else:
                h = reg.histogram("h", buckets=(0.01, 0.05, 0.1, 0.5, 1.0))
                for v in vals:
                    h.observe(v)
            ring.sample_once()
            evals[p].append(engine.evaluate(now=clock.t)["lat"])
            clock.tick()
    assert evals["port"] == evals["jax"]
    assert {e["state"] for e in evals["port"]} >= {"ok", "page"}
    st = {p: w[2].status() for p, w in worlds.items()}
    assert st["port"] == st["jax"]
    assert st["port"]["slos"]["lat"]["transitions"]
    snaps = {p: w[0].snapshot() for p, w in worlds.items()}
    for k in ("slo.lat.burn_fast", "slo.lat.burn_slow", "slo.lat.state"):
        assert snaps["port"][k] == snaps["jax"][k]


def test_bundle_sections_equal_jax():
    from hivemall_tpu.runtime.debug_bundle import SECTIONS as JSECTIONS
    from hivemall_tpu_torch.runtime.debug_bundle import SECTIONS

    assert SECTIONS == JSECTIONS


def test_bundle_over_the_serving_server_describes_the_registry(tmp_path):
    """On the serving port the bundle's models section is the registry's
    describe() (lineage included) and /healthz carries the SLO block."""
    import urllib.request

    import numpy as np

    from hivemall_tpu_torch.runtime.debug_bundle import SECTIONS
    from hivemall_tpu_torch.models.classifier import train_arow
    from hivemall_tpu_torch.serving.server import ModelRegistry, serve

    rng = np.random.RandomState(0)
    rows = ([rng.randint(0, 64, 4) for _ in range(32)],
            [rng.rand(4).astype(np.float32) for _ in range(32)])
    model = train_arow(rows, np.where(rng.rand(32) > 0.5, 1, -1),
                       "-dims 64", device="cpu")
    reg = ModelRegistry(max_batch=16, device="cpu")
    lineage = [{"version": "1", "published": True,
                "reason": "first_publish"}]
    reg.deploy("ctr", model, version="1", lineage=lineage)
    server = serve(reg)
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/bundle?n=3",
                timeout=10) as r:
            bundle = _strict_loads(r.read().decode())
        assert all(s in bundle for s in SECTIONS)
        assert [m["name"] for m in bundle["models"]] == ["ctr"]
        assert bundle["models"][0]["lineage"] == lineage
        assert sum(bundle["health"]["models"]["ctr"]["shed"].values()) == 0
        assert bundle["device_set"]["platform"] in ("cpu", "gpu")
        assert bundle["versions"]["torch"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/models", timeout=10) as r:
            models = _strict_loads(r.read().decode())["models"]
        assert models[0]["lineage"] == lineage
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            health = _strict_loads(r.read().decode())
        assert set(health["slo"]) == {"worst_state", "paging", "warning",
                                      "evaluated"}
    finally:
        server.shutdown()
        server.server_close()
        reg.shutdown()
