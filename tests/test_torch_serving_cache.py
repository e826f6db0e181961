"""The port's hot-row score cache (hivemall_tpu_torch/serving/cache.py and
its fronts in batcher.py / server.py) against the JAX package's, on the CPU.

Every case of tests/test_serving_cache.py but the static-analysis one is
here. Each scenario runs its pins once per package (``impl`` "jax" or
"torch"); the deterministic ones return what they observed — counters and
values — and the test requires the two packages to have observed the same.
The registry cases hold the port's scores against the JAX engine's on the
same training rows (RTOL / ATOL of torch_cases) and the row keys byte for
byte. Every ``Future.result`` and join has a timeout."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import hivemall_tpu.runtime.metrics as JM
import hivemall_tpu.runtime.tracing as JT
import hivemall_tpu.serving as JS
import hivemall_tpu.serving.cache as JC
import hivemall_tpu_torch.runtime.metrics as TM
import hivemall_tpu_torch.runtime.tracing as TT
import hivemall_tpu_torch.serving as TS
import hivemall_tpu_torch.serving.cache as TC
from hivemall_tpu.models.classifier import train_arow as jax_train_arow
from hivemall_tpu_torch.models.classifier import train_arow as port_train_arow

from torch_cases import ATOL, RTOL

TIMEOUT = 5


def _pkg(serving, cache, metrics, tracing, train, registry_kw):
    return SimpleNamespace(
        ScoreCache=serving.ScoreCache, DynamicBatcher=serving.DynamicBatcher,
        ModelRegistry=serving.ModelRegistry,
        ServingEngine=serving.ServingEngine, QueueFull=serving.QueueFull,
        ShedLowPriority=serving.ShedLowPriority,
        DeadlineExpired=serving.DeadlineExpired, LeadToken=cache.LeadToken,
        entry_cost=cache._entry_cost, REGISTRY=metrics.REGISTRY,
        TRACER=tracing.TRACER, train_arow=train, registry_kw=registry_kw)


PKG = {
    "jax": _pkg(JS, JC, JM, JT, jax_train_arow, {}),
    "torch": _pkg(TS, TC, TM, TT,
                  lambda *a: port_train_arow(*a, device="cpu"),
                  {"device": "cpu"}),
}
IMPLS = sorted(PKG)


def _keyfn(instances):
    """A toy canonical key fn: each instance keys on its repr (the engine
    supplies blake2b digests over the pre-parsed form in production)."""
    return [repr(r).encode() for r in instances]


def _echo(rows):
    return [float(r) for r in rows]


def _cached_batcher(pk, name, predict, *, bytes_=1 << 20, version="1",
                    **kw):
    cache = pk.ScoreCache(bytes_, name=name)
    b = pk.DynamicBatcher(predict, name=name, cache=cache,
                          cache_version=version, row_key_fn=_keyfn, **kw)
    return b, cache


COUNTS = ("hit_rows", "miss_rows", "coalesced_rows", "evicted_entries",
          "negative_stored", "negative_hits", "entries", "inflight_keys",
          "negative_keys")


def _counts(cache):
    st = cache.stats()
    return {k: st[k] for k in COUNTS}


def _both(scenario, name):
    """Run ``scenario(pk, name)`` under each package (each asserts its own
    pins) and require the same observations from both."""
    obs = {impl: scenario(PKG[impl], f"{name}_{impl}") for impl in IMPLS}
    assert obs["torch"] == obs["jax"]
    return obs["torch"]


# -- ScoreCache unit behavior -------------------------------------------------

def _byte_budget(pk, name):
    cache = pk.ScoreCache(3 * pk.entry_cost(("1", b"x" * 16), 1.0),
                          name=name)
    b = pk.DynamicBatcher(_echo, name=name, cache=cache, cache_version="1",
                          row_key_fn=_keyfn, max_delay_ms=0.5)
    values = []
    try:
        for r in (10, 11, 12, 13):  # 4 distinct rows through a 3-entry budget
            values.append(b.submit([r]).result(TIMEOUT))
        st = cache.stats()
        assert st["entries"] == 3
        assert st["evicted_entries"] == 1
        assert st["resident_bytes"] <= cache.max_bytes
        # the evicted entry is the OLDEST (row 10): re-requesting it is a
        # miss, re-requesting row 13 is a hit
        h0 = st["hit_rows"]
        values.append(b.submit([13]).result(TIMEOUT))
        assert cache.stats()["hit_rows"] == h0 + 1
        values.append(b.submit([10]).result(TIMEOUT))
        assert cache.stats()["hit_rows"] == h0 + 1  # 10 was recomputed
    finally:
        b.close()
    return _counts(cache), cache.stats()["resident_bytes"], values


def test_byte_budget_evicts_oldest_first():
    _both(_byte_budget, "tsc_bb")


def _version_key(pk, name):
    calls = []

    def predict(rows):
        calls.append(list(rows))
        return _echo(rows)

    cache = pk.ScoreCache(1 << 20, name=name)
    b1 = pk.DynamicBatcher(predict, name=name, cache=cache,
                           cache_version="1", row_key_fn=_keyfn)
    assert b1.submit([7]).result(TIMEOUT) == [7.0]
    assert b1.submit([7]).result(TIMEOUT) == [7.0]
    assert len(calls) == 1  # second was a hit
    b1.close()
    b2 = pk.DynamicBatcher(predict, name=name, cache=cache,
                           cache_version="2", row_key_fn=_keyfn)
    assert b2.submit([7]).result(TIMEOUT) == [7.0]
    assert len(calls) == 2  # new version: recomputed
    b2.close()
    st = cache.stats()
    assert st["hit_rows"] == 1 and st["miss_rows"] == 2
    return _counts(cache), calls


def test_version_is_in_the_key():
    """The same row under a different version is a MISS — the whole
    hot-swap invalidation story (no flush anywhere)."""
    _both(_version_key, "tsc_ver")


@pytest.mark.parametrize("impl", IMPLS)
def test_zero_budget_cache_refused(impl):
    with pytest.raises(ValueError):
        PKG[impl].ScoreCache(0, name=f"tsc_zero_{impl}")


# -- the admission bypass -----------------------------------------------------

def _bypass(pk, name):
    gate = threading.Event()
    first = threading.Event()

    def predict(rows):
        first.set()
        gate.wait(10)
        return _echo(rows)

    b, cache = _cached_batcher(pk, name, predict, max_batch=1,
                               max_delay_ms=0.5, max_queue_rows=2,
                               express_high=False)
    try:
        warm = b.submit([1])  # will wedge in predict
        assert first.wait(TIMEOUT)
        fills = [b.submit([100 + i]) for i in range(2)]  # queue now full
        with pytest.raises(pk.QueueFull):
            b.submit([999])
        gate.set()
        warm.result(TIMEOUT)  # row 1 now cached
        for f in fills:
            f.result(TIMEOUT)
        gate.clear()
        first.clear()
        blocker = b.submit([200])  # wedge the worker again
        assert first.wait(TIMEOUT)  # worker holds it — queue empty again
        refill = [b.submit([300 + i]) for i in range(2)]
        with pytest.raises(pk.QueueFull):
            b.submit([999])
        # the cached row sails through the full queue, instantly
        hit = b.submit([1])
        assert hit.done() and hit.result(TIMEOUT) == [1.0]
        gate.set()
        blocker.result(TIMEOUT)
        for f in refill:
            f.result(TIMEOUT)
    finally:
        gate.set()
        b.close()
    return _counts(cache)


def test_hit_bypasses_queue_capacity_and_quota():
    """A fully-cached request resolves while the queue is FULL and the
    worker is wedged — it consumed no queue rows, no class quota, no
    batch slot."""
    _both(_bypass, "tsc_bypass")


def _coalesce(pk, name):
    calls = []
    gate = threading.Event()
    entered = threading.Event()

    def predict(rows):
        calls.append(list(rows))
        entered.set()
        gate.wait(10)
        return _echo(rows)

    b, cache = _cached_batcher(pk, name, predict, max_delay_ms=0.5)
    try:
        leader = b.submit([5, 6])
        assert entered.wait(TIMEOUT)  # leader is mid-dispatch (in flight)
        followers = [b.submit([5, 6]) for _ in range(3)]
        assert all(not f.done() for f in followers)
        gate.set()
        values = [leader.result(TIMEOUT)]
        assert values[0] == [5.0, 6.0]
        for f in followers:
            values.append(f.result(TIMEOUT))
            assert values[-1] == [5.0, 6.0]
        assert len(calls) == 1  # ONE computation for 4 requests
        st = cache.stats()
        assert st["coalesced_rows"] == 6 and st["miss_rows"] == 2
    finally:
        gate.set()
        b.close()
    return _counts(cache), values, calls


def test_coalescing_shares_one_computation():
    _both(_coalesce, "tsc_coal")


def _partial(pk, name):
    calls = []

    def predict(rows):
        calls.append(list(rows))
        return _echo(rows)

    b, cache = _cached_batcher(pk, name, predict, max_delay_ms=0.5)
    try:
        b.submit([1, 2]).result(TIMEOUT)
        assert b.submit([2, 3]).result(TIMEOUT) == [2.0, 3.0]  # 3 is new
        assert [2, 3] in calls  # both rows recomputed — flows unchanged
        assert b.submit([3]).result(TIMEOUT) == [3.0]
        assert cache.stats()["miss_rows"] == 4  # 1,2 then 2,3
        assert cache.stats()["hit_rows"] == 1  # the final [3]
    finally:
        b.close()
    return _counts(cache), calls


def test_partial_coverage_flows_unchanged():
    """A request with any uncovered row computes EVERYTHING itself (no
    request splitting) and its fresh rows join the cache."""
    _both(_partial, "tsc_part")


# -- coalescing correctness under failure ------------------------------------

def _engine_error(pk, name):
    boom = [True]
    gate = threading.Event()
    entered = threading.Event()
    calls = []

    def predict(rows):
        calls.append(list(rows))
        entered.set()
        gate.wait(10)
        if boom[0]:
            raise RuntimeError("injected scorer fault")
        return _echo(rows)

    b, cache = _cached_batcher(pk, name, predict, max_delay_ms=0.5)
    try:
        leader = b.submit([9])
        assert entered.wait(TIMEOUT)
        follower = b.submit([9])
        gate.set()
        with pytest.raises(RuntimeError, match="injected scorer fault"):
            leader.result(TIMEOUT)
        with pytest.raises(RuntimeError, match="injected scorer fault"):
            follower.result(TIMEOUT)
        assert cache.stats()["entries"] == 0  # failure populated NOTHING
        boom[0] = False
        assert b.submit([9]).result(TIMEOUT) == [9.0]  # recomputed, cached
        assert len(calls) == 2
        assert cache.stats()["entries"] == 1
    finally:
        gate.set()
        b.close()
    return _counts(cache), calls


def test_leader_engine_error_fails_followers_same_reason_no_populate():
    """The leader's engine error propagates to every follower verbatim and
    the cache stays unpopulated — the next request recomputes."""
    _both(_engine_error, "tsc_fault")


def _shed(pk, name):
    gate = threading.Event()
    entered = threading.Event()

    def predict(rows):
        entered.set()
        gate.wait(10)
        return _echo(rows)

    b, cache = _cached_batcher(pk, name, predict, max_batch=1,
                               max_delay_ms=0.5, max_queue_rows=2,
                               priority_quota_fracs=(1.0, 0.85, 0.6),
                               express_high=False)
    try:
        wedge = b.submit([1])  # occupies the worker
        assert entered.wait(TIMEOUT)
        leader = b.submit([50], priority="low")  # queued, leads key 50
        follower = b.submit([50], priority="low")  # coalesces onto it
        # two high arrivals: quota math sheds the newest low-priority
        # queued work — the leader
        high = [b.submit([60 + i], priority="high") for i in range(2)]
        with pytest.raises(pk.ShedLowPriority):
            leader.result(TIMEOUT)
        with pytest.raises(pk.ShedLowPriority):
            follower.result(TIMEOUT)
        gate.set()
        wedge.result(TIMEOUT)
        for f in high:
            f.result(TIMEOUT)
        assert cache.stats()["entries"] == 3  # 1, 60, 61 — never 50
    finally:
        gate.set()
        b.close()
    return _counts(cache)


def test_leader_shed_fails_followers_with_shed_reason():
    """A low-priority leader evicted for higher-priority work takes its
    followers down with the SAME ShedLowPriority."""
    _both(_shed, "tsc_shed")


def _deadline(pk, name):
    gate = threading.Event()
    entered = threading.Event()

    def predict(rows):
        entered.set()
        gate.wait(10)
        return _echo(rows)

    b, cache = _cached_batcher(pk, name, predict, max_batch=1,
                               max_delay_ms=0.5, express_high=False)
    try:
        wedge = b.submit([1])
        assert entered.wait(TIMEOUT)
        leader = b.submit([70], deadline_ms=30)
        follower = b.submit([70])
        time.sleep(0.08)  # the deadline passes while queued behind the wedge
        gate.set()  # wedge returns; the worker purges the expired head
        with pytest.raises(pk.DeadlineExpired):
            leader.result(TIMEOUT)  # expired IN the queue — never dispatched
        with pytest.raises(pk.DeadlineExpired):
            follower.result(TIMEOUT)
        wedge.result(TIMEOUT)
        assert b.submit([70]).result(TIMEOUT) == [70.0]  # never cached stale
    finally:
        gate.set()
        b.close()
    return _counts(cache)


def test_leader_deadline_expiry_fails_followers_as_deadline():
    _both(_deadline, "tsc_dead")


def _refused_leader(pk, name):
    gate = threading.Event()
    entered = threading.Event()

    def predict(rows):
        entered.set()
        gate.wait(10)
        return _echo(rows)

    b, cache = _cached_batcher(pk, name, predict, max_batch=1,
                               max_delay_ms=0.5, max_queue_rows=1,
                               express_high=False)
    try:
        wedge = b.submit([1])
        assert entered.wait(TIMEOUT)
        filler = b.submit([2])  # queue full now
        with pytest.raises(pk.QueueFull):
            b.submit([80])  # would-be leader refused
        # key 80's leadership was never taken; keys 1 and 2 stay in flight
        assert cache.stats()["inflight_keys"] == 2
        gate.set()
        wedge.result(TIMEOUT)
        filler.result(TIMEOUT)
        assert cache.stats()["inflight_keys"] == 0
        # the refusal left a short-TTL negative entry for key 80: wait it
        # out (this case is about leadership, not the negative cache)
        time.sleep(cache.negative_ttl_s + 0.01)
        assert b.submit([80]).result(TIMEOUT) == [80.0]  # fresh leader
    finally:
        gate.set()
        b.close()
    return _counts(cache)


def test_quota_refused_leader_registers_nothing():
    """A leader refused at admission (QueueFull) never took leadership, so
    no follower can be stranded on an admission error."""
    _both(_refused_leader, "tsc_abort")


# -- swap-time invalidation and the registry ---------------------------------

def _rows(dims=256, seed=7):
    rng = np.random.RandomState(seed)
    rows = [[f"{rng.randint(dims)}:{rng.rand():.3f}" for _ in range(5)]
            for _ in range(120)]
    return rows, rng.choice([-1, 1], 120)


def _train_tiny(pk, dims=256, seed=7, opts=""):
    rows, labels = _rows(dims, seed)
    return pk.train_arow(rows, labels,
                         f"-dims {dims} {opts}".strip()), rows


def _registry(pk, **kw):
    return pk.ModelRegistry(score_cache_bytes=1 << 20,
                            engine_kwargs={"max_batch": 64, "max_width": 32},
                            **pk.registry_kw, **kw)


def test_swap_never_serves_stale_score_under_new_version():
    """Requests racing a hot-swap either hit the old version's entries
    (labeled with the old version) or compute fresh on the new one —
    never a v1 score labeled v2; each version's scores are the JAX
    engine's within tolerance."""
    pk = PKG["torch"]
    model1, rows = _train_tiny(pk)
    model2, _ = _train_tiny(pk, opts="-r 0.7")
    reg = _registry(pk)
    reg.deploy("tswap", model1, version="1")
    probe = rows[:2]
    expected = {
        "1": [float(x) for x in reg.get("tswap").engine.predict(probe)],
    }
    e, f = reg.submit("tswap", probe)  # cached under v1
    assert [float(x) for x in f.result(TIMEOUT)] == expected["1"]

    observed, failures = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                entry, fut = reg.submit("tswap", probe)
                observed.append((entry.version,
                                 [float(x) for x in fut.result(TIMEOUT)]))
            except Exception as exc:  # a swap must fail zero requests
                failures.append(repr(exc))

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.1)
        reg.deploy("tswap", model2, version="2")
        expected["2"] = [float(x)
                         for x in reg.get("tswap").engine.predict(probe)]
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(TIMEOUT)
        reg.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert failures == []
    assert expected["1"] != expected["2"]  # the models genuinely differ
    versions = {v for v, _ in observed}
    assert versions <= {"1", "2"} and "2" in versions
    for version, scores in observed:
        assert scores == expected[version], \
            f"score labeled v{version} is not v{version}'s own score"
    jpk = PKG["jax"]
    for version, opts in (("1", ""), ("2", "-r 0.7")):
        jm, _ = _train_tiny(jpk, opts=opts)
        jeng = jpk.ServingEngine(jm, name=f"tswap_j{version}", max_batch=64,
                                 max_width=32)
        np.testing.assert_allclose(expected[version],
                                   np.asarray(jeng.predict(probe), float),
                                   rtol=RTOL, atol=ATOL)


def _through_registry(pk, name):
    model, rows = _train_tiny(pk)
    reg = _registry(pk)
    try:
        reg.deploy(name, model, version="1")
        probe = rows[:8]
        computed = [float(x) for x in
                    reg.submit(name, probe)[1].result(TIMEOUT)]
        cached = [float(x) for x in
                  reg.submit(name, probe)[1].result(TIMEOUT)]
        direct = [float(x) for x in reg.get(name).engine.predict(probe)]
        counts = _counts(reg.get(name).cache)
    finally:
        reg.shutdown()
    assert cached == computed == direct  # bit-identical, not approx
    return counts, computed


def test_cached_equals_computed_through_registry():
    obs = {impl: _through_registry(PKG[impl], f"tpar_{impl}")
           for impl in IMPLS}
    assert obs["torch"][0] == obs["jax"][0]
    np.testing.assert_allclose(obs["torch"][1], obs["jax"][1], rtol=RTOL,
                               atol=ATOL)


# -- keys, observability, wiring ---------------------------------------------

def test_engine_row_keys_canonical_across_request_forms():
    """A string row and its pre-parsed twins (per-row arrays, flat pack)
    share one key, the JAX engine's byte for byte; over-wide rows are
    None."""
    engines = {}
    for impl in IMPLS:
        pk = PKG[impl]
        model, _ = _train_tiny(pk, dims=128)
        engines[impl] = pk.ServingEngine(model, name=f"trk_{impl}",
                                         max_batch=16, max_width=8,
                                         **pk.registry_kw)
    eng = engines["torch"]
    row_s = ["3:0.5", "7:1.0"]
    idx = np.asarray([3, 7], np.int64)
    val = np.asarray([0.5, 1.0], np.float32)
    k_str = eng.row_keys([row_s])
    k_pair = eng.row_keys(([idx], [val]))
    k_flat = eng.row_keys((idx, val, np.asarray([2], np.int64)))
    assert k_str == k_pair == k_flat
    assert len(k_str) == 1 and len(k_str[0]) == 16
    # hashed ids canonicalize mod dims: 3 and 3+128 are the same row
    assert eng.row_keys(([idx + 128], [val])) == k_str
    wide = [[f"{i}:1.0" for i in range(9)]]
    assert eng.row_keys(wide) is None
    # different values / different order are different keys
    assert eng.row_keys([["7:1.0", "3:0.5"]]) != k_str
    for req in ([row_s], ([idx], [val]), wide, [["7:1.0", "3:0.5"]]):
        assert eng.row_keys(req) == engines["jax"].row_keys(req)


# malformed requests: each raises inside the servable's key derivation
MALFORMED = {
    "overflowing_value": [[("x", 10 ** 400)]],
    "preparsed_text_values": ([np.array([1, 2])], [np.array(["a", "b"])]),
    "flat_text_lengths": (np.array([1, 2]), np.array([1.0, 2.0]),
                          np.array(["q"])),
}


@pytest.mark.parametrize("form", sorted(MALFORMED))
def test_row_keys_malformed_request_is_uncacheable(form):
    """A malformed request is None ("uncacheable") in both packages,
    whatever the exception its parse raises; the error then surfaces on
    the predict path."""
    keys = {}
    for impl in IMPLS:
        pk = PKG[impl]
        model, _ = _train_tiny(pk, dims=64)
        eng = pk.ServingEngine(model, name=f"trk_bad_{impl}", max_batch=16,
                               max_width=8, **pk.registry_kw)
        keys[impl] = eng.row_keys(MALFORMED[form])
        with pytest.raises(Exception):
            eng.predict(MALFORMED[form])
    assert keys == {"jax": None, "torch": None}


def test_row_keys_trees_hash_binned_row():
    """Tree keys hash the BINNED row (the JAX engine's keys byte for
    byte); ragged input is uncacheable; with a cache the second identical
    request is all hits."""
    from hivemall_tpu.models.trees import \
        train_randomforest_classifier as jax_rf
    from hivemall_tpu_torch.models.trees import \
        train_randomforest_classifier as port_rf

    rng = np.random.RandomState(3)
    X = rng.rand(40, 4)
    y = (X[:, 0] > 0.5).astype(int)
    model = port_rf(X, y, "-trees 2 -seed 1", device="cpu")
    eng = TS.ServingEngine(model, name="trk_tree", max_batch=16,
                           device="cpu")
    jeng = JS.ServingEngine(jax_rf(X, y, "-trees 2 -seed 1"),
                            name="trk_tree_j", max_batch=16)
    keys = eng.row_keys([list(X[0]), list(X[1])])
    assert keys is not None and len(keys) == 2 and keys[0] != keys[1]
    assert keys == jeng.row_keys([list(X[0]), list(X[1])])
    assert eng.row_keys([[0.1, 0.2]]) is None
    reg = TS.ModelRegistry(score_cache_bytes=1 << 20,
                           engine_kwargs={"max_batch": 16}, device="cpu")
    try:
        reg.deploy("trk_tree_e2e", model, version="1")
        rows = [list(x) for x in X[:4]]
        a = reg.submit("trk_tree_e2e", rows)[1].result(TIMEOUT)
        b = reg.submit("trk_tree_e2e", rows)[1].result(TIMEOUT)
        st = reg.get("trk_tree_e2e").describe()["cache"]
    finally:
        reg.shutdown()
    assert st["hit_rows"] == 4 and st["miss_rows"] == 4
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_row_keys_ffm_normalized_triples():
    """FFM keys hash the normalized (field, id, value) triples — the JAX
    engine's keys byte for byte, None for overwide and unparseable rows —
    and an FFM model's repeat request is served from the cache."""
    from hivemall_tpu.models.ffm import train_ffm as jax_ffm
    from hivemall_tpu_torch.models.ffm import train_ffm as port_ffm

    rows = [[f"{i % 3}:{i % 7}:1.0", f"{(i + 1) % 3}:{(i * 5) % 7}:0.5"]
            for i in range(30)]
    labels = [1 if i % 2 else -1 for i in range(30)]
    opts = "-factor 2 -iters 2 -feature_hashing 5 -num_fields 3"
    model = port_ffm(rows, labels, opts, device="cpu")
    eng = TS.ServingEngine(model, name="trk_ffm", max_batch=16, max_width=8,
                           device="cpu")
    jeng = JS.ServingEngine(jax_ffm(rows, labels, opts), name="trk_ffm_j",
                            max_batch=16, max_width=8)
    keys = eng.row_keys(rows[:2])
    assert keys is not None and len(keys) == 2 and keys[0] != keys[1]
    assert eng.row_keys(rows[:2]) == keys  # deterministic
    nf = model.hyper.num_features
    wrapped = [[f"1:{3 + nf}:1.0"]]
    assert eng.row_keys(wrapped) == eng.row_keys([["1:3:1.0"]])
    wide = [[f"1:{k}:1.0" for k in range(9)]]
    assert eng.row_keys(wide) is None
    assert eng.row_keys([["not-a-feature::"]]) is None
    for req in (rows, wrapped, [["-1:4:2.5", "7:1:0.25"]], wide,
                [["not-a-feature::"]], [["a:b:c"]]):
        assert eng.row_keys(req) == jeng.row_keys(req), req
    reg = TS.ModelRegistry(score_cache_bytes=1 << 20,
                           engine_kwargs={"max_batch": 16, "max_width": 8},
                           device="cpu")
    try:
        reg.deploy("trk_ffm_e2e", model, version="1")
        a = reg.submit("trk_ffm_e2e", rows[:4])[1].result(TIMEOUT)
        b = reg.submit("trk_ffm_e2e", rows[:4])[1].result(TIMEOUT)
        st = reg.get("trk_ffm_e2e").describe()["cache"]
    finally:
        reg.shutdown()
    assert st["hit_rows"] == 4 and st["miss_rows"] == 4
    assert [float(x) for x in a] == [float(x) for x in b]


def _surface(pk, name):
    model, rows = _train_tiny(pk)
    reg = _registry(pk)
    reg2 = pk.ModelRegistry(engine_kwargs={"max_batch": 64, "max_width": 32},
                            **pk.registry_kw)
    try:
        reg.deploy(name, model, version="1")
        reg.submit(name, rows[:2])[1].result(TIMEOUT)
        reg.submit(name, rows[:2])[1].result(TIMEOUT)
        st = reg.get(name).describe()["cache"]
        assert st["enabled"] and st["hit_rows"] == 2 and st["miss_rows"] == 2
        assert st["hit_ratio"] == 0.5
        assert st["resident_bytes"] > 0 and st["budget_bytes"] == 1 << 20
        snap = pk.REGISTRY.snapshot()
        assert snap[f"serving.{name}.cache.resident_bytes"] == \
            st["resident_bytes"]
        assert snap[f"serving.{name}.cache.hit"] == 2
        # cache off by default: a second registry reports enabled False
        reg2.deploy(f"{name}_off", model, version="1")
        assert reg2.get(f"{name}_off").describe()["cache"] == \
            {"enabled": False}
    finally:
        reg.shutdown()
        reg2.shutdown()
    return st


def test_metrics_and_models_surface():
    _both(_surface, "tobs")


def test_registry_cache_budget_per_deploy():
    """One cache per model name, shared across versions: a redeploy keeps
    the object (and its entries), an explicit 0 turns it off, undeploy
    drops it — as the JAX registry does."""
    seen = {}
    for impl in IMPLS:
        pk = PKG[impl]
        model, rows = _train_tiny(pk)
        reg = pk.ModelRegistry(engine_kwargs={"max_batch": 64,
                                              "max_width": 32},
                               **pk.registry_kw)
        try:
            assert reg.deploy("tbud", model, version="1").cache is None
            c1 = reg.deploy("tbud", model, version="2",
                            score_cache_bytes=1 << 16).cache
            reg.submit("tbud", rows[:3])[1].result(TIMEOUT)
            c2 = reg.deploy("tbud", model, version="3").cache
            assert c2 is c1 and c2.stats()["entries"] == 3
            reg.submit("tbud", rows[:3])[1].result(TIMEOUT)  # v3: misses
            got = _counts(c2)
            assert reg.deploy("tbud", model, version="4",
                              score_cache_bytes=0).cache is None
            assert reg.get("tbud").describe()["cache"] == {"enabled": False}
            reg.deploy("tbud", model, version="5", score_cache_bytes=1 << 16)
            assert reg.undeploy("tbud")
            assert reg.deploy("tbud", model, version="6").cache is None
        finally:
            reg.shutdown()
        seen[impl] = got
    assert seen["torch"] == seen["jax"]


def test_trace_instants_inside_request_span():
    pk = PKG["torch"]
    b, cache = _cached_batcher(pk, "tsc_trace", _echo, max_delay_ms=0.5)
    try:
        pk.TRACER.clear()
        with pk.TRACER.span("server.predict"):
            b.submit([1]).result(TIMEOUT)  # miss
        with pk.TRACER.span("server.predict"):
            b.submit([1]).result(TIMEOUT)  # hit
        time.sleep(0.05)
        events = [e["name"] for t in pk.TRACER.traces()
                  for s in t["spans"] for e in s.get("events", ())]
        assert "cache.hit" in events
    finally:
        b.close()


# -- negative caching: quota-refused hot rows ---------------------------------

def _wedged_full_batcher(pk, name, *, negative_ttl_s=0.05):
    """A batcher wedged mid-dispatch with a full 1-row queue: every new
    submit is quota-refused. Returns (batcher, cache, release_fn)."""
    gate = threading.Event()
    entered = threading.Event()

    def predict(rows):
        entered.set()
        gate.wait(10)
        return _echo(rows)

    cache = pk.ScoreCache(1 << 20, name=name, negative_ttl_s=negative_ttl_s)
    b = pk.DynamicBatcher(predict, name=name, cache=cache, cache_version="1",
                          row_key_fn=_keyfn, max_batch=1, max_delay_ms=0.5,
                          max_queue_rows=1, express_high=False)
    wedged = [b.submit([1])]
    assert entered.wait(TIMEOUT)
    wedged.append(b.submit([2]))  # queue is now at quota
    return b, cache, gate.set, wedged


def _negative_short_circuit(pk, name):
    b, cache, release, _wedged = _wedged_full_batcher(pk, name)
    try:
        with pytest.raises(pk.QueueFull):
            b.submit([80])  # refused at admission: stores a negative entry
        st = cache.stats()
        assert st["negative_stored"] == 1 and st["negative_keys"] == 1
        rejected = f"serving.{name}.batcher.rejected"
        before = pk.REGISTRY.snapshot().get(rejected, 0)
        with pytest.raises(pk.QueueFull):
            b.submit([80])  # within TTL: refused by the negative cache
        assert cache.stats()["negative_hits"] == 1
        # admission never saw the repeat
        assert pk.REGISTRY.snapshot().get(rejected, 0) == before
        counts = _counts(cache)
    finally:
        release()
        b.close()
    return counts


def test_negative_cache_short_circuits_repeat_refusals():
    """A quota-refused leader key answers the SAME refusal from the cache
    front within the TTL, without re-entering admission."""
    _both(_negative_short_circuit, "tsc_neg")


def _negative_expiry(pk, name):
    b, cache, release, wedged = _wedged_full_batcher(pk, name,
                                                     negative_ttl_s=0.03)
    try:
        with pytest.raises(pk.QueueFull):
            b.submit([80])
        release()
        for f in wedged:  # drain the queue so admission has capacity
            f.result(TIMEOUT)
        time.sleep(0.04)  # TTL elapsed: admission is consulted again
        assert b.submit([80]).result(TIMEOUT) == [80.0]
        st = cache.stats()
        assert st["negative_keys"] == 0  # success purged the entry
        assert st["negative_hits"] == 0  # expired entry never served
    finally:
        release()
        b.close()
    return _counts(cache)


def test_negative_entry_expires_and_clears_on_success():
    _both(_negative_expiry, "tsc_neg_ttl")


@pytest.mark.parametrize("impl", IMPLS)
def test_negative_cache_is_version_keyed(impl):
    """A hot-swap clears a row's negative verdict atomically — the version
    is in the key, exactly like positive entries."""
    pk = PKG[impl]
    cache = pk.ScoreCache(1 << 20, name=f"tsc_neg_ver_{impl}",
                          negative_ttl_s=30.0)
    refusal = pk.QueueFull("full", reason="quota")
    cache.note_refusal(pk.LeadToken("1", [b"k"], [b"k"]), refusal)
    plan = cache.admit("1", [b"k"], None)
    assert plan.kind == "refused" and plan.error is refusal
    assert cache.admit("2", [b"k"], None).kind == "lead"


def test_resident_bytes_bounded_under_concurrent_traffic():
    """Threads hammering a small budget with a seeded skewed key stream:
    resident bytes never exceed the budget, every answer is its row's
    score, and the counters account for every row."""
    import sys

    budget = 40 * TC._entry_cost(("1", b"x" * 16), 1.0)
    cache = TC.ScoreCache(budget, name="tsc_stress")
    b = TS.DynamicBatcher(_echo, name="tsc_stress", cache=cache,
                          cache_version="1", row_key_fn=_keyfn,
                          max_delay_ms=0.2)
    rng = np.random.RandomState(11)
    draws = (rng.zipf(1.3, size=(8, 300)) % 200).tolist()
    errors, peak = [], [0]

    def client(keys):
        try:
            for k in keys:
                assert b.submit([k]).result(TIMEOUT) == [float(k)]
                peak[0] = max(peak[0], cache.stats()["resident_bytes"])
        except Exception as exc:  # collected, asserted below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=client, args=(d,)) for d in draws]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    st = cache.stats()
    assert 0 < peak[0] <= budget and st["resident_bytes"] <= budget
    assert st["hit_rows"] + st["miss_rows"] + st["coalesced_rows"] == 8 * 300
    assert st["evicted_entries"] > 0 and st["inflight_keys"] == 0
