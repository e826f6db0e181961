"""The port's throughput meters and profiler window
(hivemall_tpu_torch/runtime/metrics.py ``ThroughputCounter``,
``MetricsRegistry.meter``, ``trace``) against the JAX package's, on the
CPU: the same snapshot keys and kinds, the same windowed rate on one
scripted clock, and the readers of meters (the time-series ring and the
Prometheus exposition)."""

import json
import os

import pytest
import torch

import hivemall_tpu.runtime.metrics as JM
import hivemall_tpu.runtime.timeseries as JTS
import hivemall_tpu_torch.runtime as TR
import hivemall_tpu_torch.runtime.metrics as TM
import hivemall_tpu_torch.runtime.metrics_http as THTTP
import hivemall_tpu_torch.runtime.timeseries as TTS


def _populate(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serving", "m.rows").increment(3)
    reg.set_gauge("m.depth", 2.0)
    reg.histogram("m.latency").observe(0.004)
    for name in ("m.rows_in", "m.events"):
        reg.meter(name).record(7)
    assert reg.meter("m.events") is reg.meter("m.events")
    return reg


def test_meter_snapshot_keys_equal_jax():
    t, j = _populate(TM), _populate(JM)
    assert sorted(t.snapshot()) == sorted(j.snapshot())
    assert "m.events.per_sec" in t.snapshot()
    ts, js = t.typed_snapshot(), j.typed_snapshot()
    assert sorted(ts) == sorted(js) == ["counters", "gauges", "histograms",
                                        "meters"]
    for kind in ts:
        assert sorted(ts[kind]) == sorted(js[kind]), kind
    assert sorted(ts["meters"]) == ["m.events.per_sec", "m.rows_in.per_sec"]


def test_throughput_counter_window_equals_jax(monkeypatch):
    """One scripted clock through both counters: the same sliding-window
    rate after every record, old events falling out of the window."""
    script = [(0.0, 4), (0.5, 2), (1.0, 6), (3.0, 1), (6.5, 10), (6.75, 3),
              (20.0, 5)]
    rates = {}
    for name, mod in (("jax", JM), ("torch", TM)):
        now = [0.0]
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
        c = mod.ThroughputCounter(window_sec=5.0)
        out = []
        for t, n in script:
            now[0] = 100.0 + t
            c.record(n)
            out.append(c.last_reads_per_sec)
        rates[name] = out
        monkeypatch.undo()
    assert rates["torch"] == rates["jax"]
    assert rates["torch"][2] == pytest.approx(12 / 1.0)
    assert TR.ThroughputCounter is TM.ThroughputCounter


def test_meters_reach_the_ring_and_the_exposition():
    for mod, ts in ((TM, TTS), (JM, JTS)):
        reg = mod.MetricsRegistry()
        clock = iter([10.0, 11.0]).__next__
        ring = ts.TimeSeriesRing(registry=reg, clock=clock)
        meter = reg.meter("ring.in")
        meter.record(2)
        ring.sample_once()
        meter.record(2)
        ring.sample_once()
        assert ring._value(ring.window()[-1][1], "ring.in.per_sec") == \
            meter.last_reads_per_sec
    TM.REGISTRY.meter("expo.meter").record(4)
    text = THTTP.render_prometheus()
    assert "# TYPE hivemall_tpu_expo_meter_per_sec gauge" in text
    assert "\nhivemall_tpu_expo_meter_per_sec " in text


def test_trace_gauge_and_profiler_window(tmp_path):
    with TM.trace("tmeter.plain"):
        torch.ones(4).sum()
    assert TM.REGISTRY.gauges["tmeter.plain.seconds"] >= 0.0
    assert not any(tmp_path.iterdir())
    log_dir = tmp_path / "prof"
    with TM.trace("tmeter.window", log_dir=str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert TM.REGISTRY.gauges["tmeter.window.seconds"] > 0.0
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].startswith("tmeter.window.")
    assert files[0].endswith(".pt.trace.json")
    doc = json.loads((log_dir / files[0]).read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    with pytest.raises(KeyError):
        with TM.trace("tmeter.raises"):
            raise KeyError("inside")
    assert "tmeter.raises.seconds" not in TM.REGISTRY.gauges
