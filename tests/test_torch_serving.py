"""The port's serving path (hivemall_tpu_torch/serving/engine.py,
batcher.py, server.py, runtime/metrics.py, runtime/tracing.py) on the CPU:
the JAX engine's pins (tests/test_serving_engine.py,
tests/test_serving_artifact.py linear cases, tests/test_serving_batcher.py)
mirrored over the port, its scores held against the JAX engine's on the
same model, and one HTTP round trip with a hot swap.

The port's warmup witness counts CUDA caching-allocator segments instead of
jit compiles; on the CPU it reads 0, so the steady-state pins here check
the bucket sweep and the counter plumbing, and the card's count is checked
by chip_smoke.py's serve phase. Every join, result and urlopen has a
timeout; every batcher and server is closed in a finally or a fixture."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hivemall_tpu.models.classifier import train_arow as jax_train_arow
from hivemall_tpu.runtime.tracing import Tracer as JTracer
from hivemall_tpu.serving import ServingEngine as JEngine
from hivemall_tpu_torch.models.base import _stage_rows
from hivemall_tpu_torch.models.classifier import train_arow, train_perceptron
from hivemall_tpu_torch.runtime.metrics import (REGISTRY, Histogram,
                                                alloc_segment_guard)
from hivemall_tpu_torch.runtime.tracing import TRACER, Tracer
from hivemall_tpu_torch.serving import (BatcherClosed, DynamicBatcher,
                                        ModelRegistry, QueueFull,
                                        ScoreCache, ServingEngine, freeze,
                                        load, serve)

from torch_cases import ATOL, RTOL

ROWS = [[f"{i % 13}:1.0", f"{(i * 7) % 13}:0.5"] for i in range(64)]
LABELS = [1 if i % 2 else -1 for i in range(64)]
TIMEOUT = 10


@pytest.fixture(scope="module")
def model():
    return train_arow(ROWS, LABELS, "-dims 256", device="cpu")


def engine(source, name, **kw):
    kw.setdefault("device", "cpu")
    return ServingEngine(source, name=name, **kw)


def test_bucket_lists(model):
    eng = engine(model, "t_buckets", max_batch=64, max_width=32)
    assert eng.batch_buckets() == [8, 16, 32, 64]
    assert eng.width_buckets() == [8, 16, 32]
    assert eng.bucket_batch(1) == 8
    assert eng.bucket_batch(9) == 16
    assert eng.bucket_batch(1000) == 64  # capped; engine chunks instead
    big = engine(model, "t_buckets_big", max_batch=512, max_width=256)
    assert len(big.batch_buckets()) * len(big.width_buckets()) == 7 * 6


def test_warmup_covers_every_bucket_then_steady(model):
    eng = engine(model, "t_warm", max_batch=32, max_width=16)
    assert eng.warmup() == 0  # the CPU has no caching allocator
    assert eng.warmed_buckets == [(b, w) for w in (8, 16)
                                  for b in (8, 16, 32)]
    assert eng.warmup() == 0  # a second warmup adds nothing
    assert len(eng.warmed_buckets) == 6
    counter = REGISTRY.counter("allocator", "new_segments.serving.t_warm")
    before = counter.value
    with alloc_segment_guard("t_warm_sweep", eng.device,
                             expect_stable=True) as g:
        for n in (1, 7, 8, 9, 16, 30, 32):
            for width in (1, 5, 8, 13, 16):
                batch = [[f"{k % 13}:1.0" for k in range(width)]
                         for _ in range(n)]
                assert len(eng.predict(batch)) == n
    assert g.segments == 0
    assert counter.value == before
    assert REGISTRY.snapshot()["serving.t_warm.warmup_segments"] == 0.0


def test_requests_larger_than_max_batch_chunk(model):
    eng = engine(model, "t_chunk", max_batch=16, max_width=16)
    out = eng.predict(ROWS)  # 64 rows through a 16-row engine
    np.testing.assert_array_equal(out, model.predict(ROWS))


def test_overwide_rows_truncate_and_count(model):
    eng = engine(model, "t_trunc", max_batch=16, max_width=8)
    batch = [[f"{k % 13}:1.0" for k in range(20)], ROWS[0], ROWS[1]]
    before = REGISTRY.counter("serving", "t_trunc.truncated_rows").value
    assert len(eng.predict(batch)) == 3
    assert REGISTRY.counter("serving",
                            "t_trunc.truncated_rows").value == before + 1


def test_empty_request(model):
    assert engine(model, "t_empty", max_batch=16, max_width=8).predict([]) \
        == []


def test_latency_histogram_and_gauges(model):
    eng = engine(model, "t_hist", max_batch=16, max_width=16)
    eng.predict(ROWS[:4])
    assert REGISTRY.histogram("serving.t_hist.predict_seconds") \
        .snapshot()["count"] >= 1
    snap = REGISTRY.snapshot()
    assert snap["serving.t_hist.table_bytes"] == 256 * 4
    assert snap["serving.t_hist.weights_bits"] == 32.0
    assert snap["serving.t_hist.engine_rows_per_sec"] > 0
    assert snap["serving.t_hist.rows"] == 4.0


def test_padding_rows_do_not_leak_into_results(model):
    eng = engine(model, "t_pad", max_batch=32, max_width=16)
    one = eng.predict(ROWS[:1])
    many = eng.predict(ROWS[:32])
    assert one[0] == many[0]


def test_preparsed_requests_match_string_requests(model):
    eng = engine(model, "t_pre", max_batch=16, max_width=8)
    rows = [["1:1.0", "260:0.5"], [], [f"{k}:0.25" for k in range(12)],
            ["7:2.0"]]
    ref = eng.predict(rows)
    pre = _stage_rows(rows, eng.servable.dims)
    np.testing.assert_array_equal(eng.predict(pre), ref)
    lens = np.array([len(r) for r in pre[0]], np.int64)
    flat = (np.concatenate(pre[0]), np.concatenate(pre[1]), lens)
    np.testing.assert_array_equal(eng.predict(flat), ref)
    many = rows * 13  # 52 rows > max_batch: chunked in all three forms
    ref_many = eng.predict(many)
    pre_many = _stage_rows(many, eng.servable.dims)
    np.testing.assert_array_equal(eng.predict(pre_many), ref_many)
    lens_many = np.array([len(r) for r in pre_many[0]], np.int64)
    np.testing.assert_array_equal(
        eng.predict((np.concatenate(pre_many[0]),
                     np.concatenate(pre_many[1]), lens_many)), ref_many)


@pytest.mark.parametrize("form", ["strings", "rows", "flat", "overwide"])
def test_row_keys_equal_jax(model, form):
    """The hot-row cache keys (blake2b over the canonical pre-parsed row)
    are the JAX engine's, byte for byte, in every request form."""
    jm = jax_train_arow(ROWS, LABELS, "-dims 256")
    eng = engine(model, "t_keys", max_batch=16, max_width=8)
    jeng = JEngine(jm, name="t_keys_j", max_batch=16, max_width=8)
    rows = [["1:1.0", "260:0.5"], [], ["7:2.0", "3:0.25"]]
    if form == "overwide":
        rows = rows + [[f"{k}:1.0" for k in range(9)]]
    req = rows
    if form in ("rows", "flat"):
        req = _stage_rows(rows, 256)
        if form == "flat":
            req = (np.concatenate(req[0]), np.concatenate(req[1]),
                   np.array([len(r) for r in req[0]], np.int64))
    got, want = eng.row_keys(req), jeng.row_keys(req)
    assert got == want
    assert (got is None) == (form == "overwide")


@pytest.mark.parametrize("source", ["live", "artifact"])
def test_served_equals_model_predict_exactly(model, tmp_path, source):
    """f32 serving runs make_predict, the live model's own scorer: the
    served scores equal model.predict bit for bit on the CPU."""
    src = model
    if source == "artifact":
        freeze(model, str(tmp_path / "a"))
        src = load(str(tmp_path / "a"))
    eng = engine(src, f"t_exact_{source}", max_batch=16, max_width=16)
    np.testing.assert_array_equal(eng.predict(ROWS), model.predict(ROWS))


@pytest.mark.parametrize("quantize", [None, "bf16", "int8"])
def test_port_engine_matches_jax_engine_on_trained_models(tmp_path,
                                                          quantize):
    """The same rows trained in both packages, frozen by each, served by
    each: scores within rtol 1e-5 / atol 1e-6."""
    mt = train_arow(ROWS, LABELS, "-dims 256", device="cpu")
    mj = jax_train_arow(ROWS, LABELS, "-dims 256")
    from hivemall_tpu.serving import freeze as jax_freeze
    from hivemall_tpu.serving import load as jax_load

    freeze(mt, str(tmp_path / "p"), quantize=quantize)
    jax_freeze(mj, str(tmp_path / "j"), quantize=quantize)
    got = engine(load(str(tmp_path / "p")), f"t_vs_{quantize}",
                 max_batch=16, max_width=16).predict(ROWS)
    want = JEngine(jax_load(str(tmp_path / "j")), name=f"t_vs_j_{quantize}",
                   max_batch=16, max_width=16).predict(ROWS)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_engine_spans_cover_the_stages(model):
    eng = engine(model, "t_spans", max_batch=8, max_width=16)
    TRACER.clear()
    with TRACER.span("test.request"):
        eng.predict(ROWS[:20])  # three chunks
    names = [s["name"] for s in TRACER.traces(1)[0]["spans"]]
    for stage in ("engine.predict", "engine.bucket", "engine.pad",
                  "engine.dispatch", "engine.block"):
        assert stage in names, stage
    assert names.count("engine.block") == 3
    stages = TRACER.stage_breakdown(1)
    assert stages["engine.dispatch"]["count"] == 3
    doc = TRACER.chrome_trace(1)
    assert {e["name"] for e in doc["traceEvents"]} >= {"engine.predict"}


@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01-extra",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "garbage", None])
def test_traceparent_parse_and_format_match_jax(header):
    got = Tracer.parse_traceparent(header)
    assert got == JTracer.parse_traceparent(header)
    if got is not None:
        t, j = Tracer(seed=1), JTracer(seed=1)
        with t.span("r", remote=got) as s1, j.span("r", remote=got) as s2:
            a, b = t.format_traceparent(s1), j.format_traceparent(s2)
        assert a.split("-")[:2] == b.split("-")[:2]
        assert a.endswith(b[-3:])


def test_histogram_quantiles_and_exemplars_match_jax():
    from hivemall_tpu.runtime.metrics import Histogram as JHistogram

    rng = np.random.RandomState(0)
    values = rng.exponential(0.004, size=500)
    h, hj = Histogram("x"), JHistogram("x")
    for i, v in enumerate(values):
        h.observe(v, trace_id=f"t{i}" if i % 50 == 0 else None)
        hj.observe(v, trace_id=f"t{i}" if i % 50 == 0 else None)
    assert h.snapshot() == hj.snapshot()
    for q in (0.5, 0.9, 0.99):
        assert h.quantile(q) == hj.quantile(q)
    assert {k: v["trace_id"] for k, v in h.exemplars().items()} == \
        {k: v["trace_id"] for k, v in hj.exemplars().items()}


def test_engine_needs_cuda_unless_cpu_is_asked(tmp_path, model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry()
    freeze(model, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(str(tmp_path / "a"), name="t_nocuda")


# --- the batcher (mirrors tests/test_serving_batcher.py) -----------------

def _echo_batcher(name, **kw):
    calls = []

    def predict(instances):
        calls.append(len(instances))
        return [x * 2 for x in instances]

    return DynamicBatcher(predict, name=name, **kw), calls


def test_batcher_results_route_back_in_order():
    b, _ = _echo_batcher("tb_order", max_batch=8, max_delay_ms=1.0)
    try:
        futs = [b.submit([i, i + 100]) for i in range(5)]
        for i, f in enumerate(futs):
            assert f.result(timeout=TIMEOUT) == [2 * i, 2 * (i + 100)]
    finally:
        b.close()


def test_batcher_merges_concurrent_submits():
    b, calls = _echo_batcher("tb_merge", max_batch=64, max_delay_ms=25.0)
    try:
        futs = []
        barrier = threading.Barrier(8)

        def go(i):
            barrier.wait(timeout=TIMEOUT)
            futs.append((i, b.submit([i])))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        for i, f in list(futs):
            assert f.result(timeout=TIMEOUT) == [2 * i]
        assert sum(calls) == 8 and len(calls) < 8
        occ = REGISTRY.histogram("serving.tb_merge.batch_occupancy")
        assert occ.snapshot()["count"] == len(calls)
    finally:
        b.close()


def test_batcher_backpressure_and_failure_isolation():
    release = threading.Event()
    started = threading.Event()

    def slow(instances):
        started.set()
        release.wait(timeout=TIMEOUT)
        if instances[0] == "boom":
            raise ValueError("scoring bug")
        return instances

    b = DynamicBatcher(slow, name="tb_bp", max_batch=1, max_delay_ms=0.1,
                       max_queue_rows=2)
    try:
        first = b.submit(["boom"])
        assert started.wait(timeout=TIMEOUT)
        queued = [b.submit([i]) for i in range(2)]
        with pytest.raises(QueueFull):
            b.submit([9])
        release.set()
        with pytest.raises(ValueError, match="scoring bug"):
            first.result(timeout=TIMEOUT)
        assert [f.result(timeout=TIMEOUT) for f in queued] == [[0], [1]]
    finally:
        release.set()
        b.close()
    with pytest.raises(BatcherClosed):
        b.submit([1])


def test_batcher_engine_round_trip_and_cache_refused(model):
    eng = engine(model, "tb_engine", max_batch=32, max_width=16)
    b = DynamicBatcher(eng.predict, name="tb_engine", max_batch=32,
                       max_delay_ms=2.0)
    try:
        futs = [b.submit(ROWS[i:i + 4]) for i in range(0, 32, 4)]
        got = np.concatenate([f.result(timeout=TIMEOUT) for f in futs])
        np.testing.assert_array_equal(got, model.predict(ROWS[:32]))
    finally:
        b.close()
    # the score cache in front: the repeat is served from the cache, bit
    # for bit; a zero byte budget is refused
    cache = ScoreCache(1 << 20, name="tb_cache")
    b = DynamicBatcher(eng.predict, name="tb_cache", max_batch=32,
                       max_delay_ms=2.0, cache=cache, cache_version="1",
                       row_key_fn=eng.row_keys)
    try:
        first = b.submit(ROWS[:4]).result(timeout=TIMEOUT)
        again = b.submit(ROWS[:4]).result(timeout=TIMEOUT)
        assert [float(x) for x in again] == [float(x) for x in first]
        np.testing.assert_array_equal(np.asarray(first, np.float32),
                                      model.predict(ROWS[:4]))
        st = cache.stats()
        assert (st["hit_rows"], st["miss_rows"]) == (4, 4)
    finally:
        b.close()
    with pytest.raises(ValueError, match="max_bytes"):
        ScoreCache(0, name="tb_cache_zero")


# --- the HTTP server (mirrors tests/test_serving_server.py) --------------

def _post(port, payload, path="/predict"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return r.read()


@pytest.fixture()
def stack():
    registry = ModelRegistry(max_batch=32, max_delay_ms=1.0,
                             engine_kwargs={"max_batch": 32, "max_width": 16},
                             device="cpu")
    server = serve(registry)
    try:
        yield registry, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()


def test_http_round_trip_with_hot_swap(stack, model, tmp_path):
    """4 clients post while v1 is swapped for an int8 v2: zero failed
    requests, every answer a whole version's scores, /models and /metrics
    report v2."""
    registry, port = stack
    freeze(model, str(tmp_path / "v1"), version="1")
    freeze(model, str(tmp_path / "v2"), version="2", quantize="int8")
    registry.deploy("ctr", str(tmp_path / "v1"))
    want = {"1": engine(load(str(tmp_path / "v1")), "h_v1", max_batch=32,
                        max_width=16).predict(ROWS[:8]),
            "2": engine(load(str(tmp_path / "v2")), "h_v2", max_batch=32,
                        max_width=16).predict(ROWS[:8])}
    errors, answers = [], []
    swapped = threading.Event()

    def client():
        for i in range(12):
            try:
                out = _post(port, {"model": "ctr", "instances": ROWS[:8]})
                answers.append(out)
            except Exception as e:  # collected, asserted below
                errors.append(repr(e))
            if i == 3:
                swapped.wait(timeout=TIMEOUT)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    registry.deploy("ctr", str(tmp_path / "v2"))
    swapped.set()
    for t in threads:
        t.join(timeout=4 * TIMEOUT)
        assert not t.is_alive()
    assert errors == []
    assert len(answers) == 48
    for out in answers:
        np.testing.assert_allclose(out["predictions"], want[out["version"]],
                                   rtol=RTOL, atol=ATOL)
    assert any(out["version"] == "2" for out in answers)
    models = json.loads(_get(port, "/models"))["models"]
    assert [(m["name"], m["version"], m["weights_dtype"])
            for m in models] == [("ctr", "2", "int8")]
    metrics = _get(port, "/metrics").decode()
    assert "hivemall_tpu_serving_ctr_rows" in metrics
    assert "hivemall_tpu_serving_ctr_table_bytes" in metrics
    assert REGISTRY.counter("serving", "registry.swaps").value >= 1


def test_http_error_codes_and_later_slice_routes(stack, model):
    registry, port = stack
    registry.deploy("ctr", model, version="1")
    out = _post(port, {"instances": ROWS[:2]})  # single model: name optional
    assert out["model"] == "ctr" and len(out["predictions"]) == 2
    for payload, code in (({"model": "nope", "instances": ROWS[:1]}, 404),
                          ({"model": "ctr"}, 400),
                          ({"instances": ROWS[:1], "priority": "vip"}, 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, payload)
        assert e.value.code == code
    # /topk landed with retrieval: a model deployed without it is a 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, {"queries": [[1]]}, path="/topk")
    assert e.value.code == 400
    assert "retrieval" in json.loads(e.value.read())["error"]
    # the routes of the SLO engine and the flight recorder have landed
    slo = json.loads(_get(port, "/slo"))
    assert set(slo) >= {"worst_state", "slos"}
    bundle = json.loads(_get(port, "/debug/bundle?n=2"))
    assert [m["name"] for m in bundle["models"]] == ["ctr"]
    assert bundle["models"][0]["lineage"] == []
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nowhere")
    assert e.value.code == 404
    health = json.loads(_get(port, "/healthz"))
    assert health["status"] == "ok" and "ctr" in health["models"]
    assert health["slo"]["paging"] == []
    assert health["local_devices"] == torch.cuda.device_count()
    trace = json.loads(_get(port, "/trace?n=5"))
    assert "traceEvents" in trace


def test_keep_alive_responses_do_not_wait_for_delayed_acks(stack, model,
                                                           monkeypatch):
    """On one persistent connection the headers and the body of each
    response leave in two writes; with Nagle's algorithm on, the body
    waits for the client's delayed ACK (~40 ms on Linux) every time. The
    handler turns it off on every accepted socket, and the median round
    trip stays below that stall."""
    import http.client
    import socket

    from hivemall_tpu_torch.serving import server as srv

    nodelay = []
    setup = srv._ServingHandler.setup

    def recording_setup(self):
        setup(self)
        nodelay.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                                  socket.TCP_NODELAY))

    monkeypatch.setattr(srv._ServingHandler, "setup", recording_setup)
    registry, port = stack
    registry.deploy("ctr", model, version="1")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    secs = []
    try:
        for _ in range(32):
            body = json.dumps({"model": "ctr", "instances": ROWS[:1]})
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body,
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            assert r.status == 200 and json.loads(r.read())["predictions"]
            secs.append(time.perf_counter() - t0)
    finally:
        conn.close()
    assert nodelay and all(nodelay), nodelay
    assert float(np.median(secs)) < 0.035, secs
