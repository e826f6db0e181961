"""The port's top-K retrieval (hivemall_tpu_torch/serving/retrieval.py) on
the CPU (`device="cpu"`), mirroring the single-device pins of
tests/test_serving_retrieval.py and holding the port against the JAX
package's RetrievalEngine on one carried state.

Contracts under test: the blocked streamed merge equals a stable descending
argsort of the materialized scores, ids AND f32 score bits (on planted ties
too: the port sorts stably where JAX relies on lax.top_k's lowest-position
rule); port vs JAX top-K ids exact and scores at rtol 1e-5 / atol 1e-6;
bf16 / int8 catalogs self-consistent and close to f32; the LSH index built
into an artifact byte-equal to the JAX package's, artifacts cross-loaded
both ways; the /topk endpoint end to end with the reference's error codes.

The reference's four sharded top-K tests
(`test_{mf,fm}_sharded_matches_single[1x2|2x2]`) are red on this tree
(ROADMAP Queue 3); nothing here is held against them — the port's
sharded placement is a later slice and is only checked to refuse."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hivemall_tpu.serving import RetrievalEngine as JRetrieval
from hivemall_tpu.serving import build_srp_index as jax_build_srp_index
from hivemall_tpu.serving import freeze as jax_freeze
from hivemall_tpu.serving import load as jax_load
from hivemall_tpu.serving.retrieval import _SingleCatalog as JCatalog
from hivemall_tpu_torch.models import mf as TM
from hivemall_tpu_torch.models.classifier import train_perceptron
from hivemall_tpu_torch.serving import (ModelRegistry, RetrievalEngine,
                                        SRPIndex, build_srp_index, freeze,
                                        load, serve)
from hivemall_tpu_torch.serving.retrieval import _SingleCatalog, _stable_topk

from torch_cases import (ATOL, RTOL, carried_fm_models, carried_mf_models,
                         jax_mf_state, warm_mf_numpy)

N_USERS, N_ITEMS = 30, 90  # 90 % 32 != 0: the last block is partial
FM_ROWS = [[f"{i % 17}:1.0", f"{(i * 3) % 17}:0.5"] for i in range(40)]


@pytest.fixture(scope="module")
def mf_models():
    return carried_mf_models(N_USERS, N_ITEMS, k=4, seed=0)


@pytest.fixture(scope="module")
def fm_models():
    return carried_fm_models(dims=N_ITEMS, factors=5, seed=4)


def engine(source, name, **kw):
    return RetrievalEngine(source, name=name, device="cpu", **kw)


def _assert_argsort_parity(eng, queries, k):
    """Blocked merge == stable descending argsort, bit for bit."""
    res = eng.topk(queries, probe=False)
    scores = eng.score_catalog(queries)
    for row, out in zip(scores, res):
        order = np.argsort(-row, kind="stable")[:k]
        assert np.array_equal(np.asarray(out["items"], np.int64), order)
        assert np.array_equal(np.asarray(out["scores"], np.float32),
                              row[order])


def _segments(name):
    from hivemall_tpu_torch.runtime.metrics import REGISTRY

    return REGISTRY.counter("allocator",
                            f"new_segments.serving.{name}.topk").value


def _assert_same_topk(got, want):
    for a, b in zip(got, want):
        assert a["items"] == b["items"]
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=RTOL,
                                   atol=ATOL)


def test_mf_exact_parity_and_steady_state(mf_models):
    _, tm = mf_models
    eng = engine(tm, "t_mf", k=10, block_items=32, max_batch=4)
    assert eng.warmup() == 0  # no caching allocator on the CPU
    c0 = _segments("t_mf")
    # 7 queries: a full chunk + a padded partial chunk
    _assert_argsort_parity(eng, [0, 5, 11, 2, 29, 7, 13], k=10)
    for b in (1, 2, 3, 4):  # every batch bucket after warmup
        eng.topk(list(range(b)))
    assert _segments("t_mf") == c0
    # per-row k clamps to the engine k and trims the slice
    out = eng.topk([3], k=4)[0]
    assert len(out["items"]) == 4
    assert len(eng.topk([3], k=99)[0]["items"]) == 10
    with pytest.raises(ValueError, match="k must be"):
        eng.topk([3], k=0)


def test_fm_exact_parity_vs_argsort(fm_models):
    _, tm = fm_models
    eng = engine(tm, "t_fm", k=8, block_items=24, max_batch=4, max_width=8)
    eng.warmup()
    _assert_argsort_parity(eng, FM_ROWS[:6], k=8)


def test_mf_topk_matches_jax(mf_models):
    jm, tm = mf_models
    kw = dict(k=10, block_items=32, max_batch=4)
    ref = JRetrieval(jm, name="j_mf", **kw)
    eng = engine(tm, "t_mf_vs", **kw)
    qs = [0, 3, 17, 29, 8, 11]
    _assert_same_topk(eng.topk(qs), ref.topk(qs))
    np.testing.assert_allclose(eng.score_catalog(qs), ref.score_catalog(qs),
                               rtol=RTOL, atol=ATOL)
    assert eng.describe()["table_bytes"] == ref.describe()["table_bytes"]


def test_fm_topk_matches_jax(fm_models):
    jm, tm = fm_models
    kw = dict(k=8, block_items=24, max_batch=4, max_width=8)
    ref = JRetrieval(jm, name="j_fm", **kw)
    eng = engine(tm, "t_fm_vs", **kw)
    _assert_same_topk(eng.topk(FM_ROWS[:7]), ref.topk(FM_ROWS[:7]))
    np.testing.assert_allclose(eng.score_catalog(FM_ROWS[:7]),
                               ref.score_catalog(FM_ROWS[:7]),
                               rtol=RTOL, atol=ATOL)
    # an item sub-range of the feature space
    kw["item_range"] = (10, 70)
    _assert_same_topk(engine(tm, "t_fm_rng", **kw).topk(FM_ROWS[:3]),
                      JRetrieval(jm, name="j_fm_rng", **kw)
                      .topk(FM_ROWS[:3]))


@pytest.mark.parametrize("precision,tol", [("bf16", 0.05), ("int8", 0.2)])
def test_quantized_catalog_parity(tmp_path, mf_models, precision, tol):
    """Quantized catalogs: self-consistent bit for bit (the merge and the
    materialized baseline share the dequant expression), close to the f32
    scores within the precision's tolerance, and equal to the JAX engine
    on the same artifact."""
    jm, tm = mf_models
    d32, dq = str(tmp_path / "f32"), str(tmp_path / precision)
    freeze(tm, d32)
    freeze(tm, dq, quantize=precision, quant_block_rows=16)
    kw = dict(k=8, block_items=16, max_batch=4)
    ref = engine(load(d32), "t_q32", **kw)
    eng = engine(load(dq), f"t_q{precision}", **kw)
    ref.warmup()
    eng.warmup()
    qs = [0, 7, 19]
    _assert_argsort_parity(eng, qs, k=8)
    f32 = ref.score_catalog(qs)
    qsc = eng.score_catalog(qs)
    assert float(np.max(np.abs(f32 - qsc))) <= tol
    jeng = JRetrieval(jax_load(dq), name=f"j_q{precision}", **kw)
    _assert_same_topk(eng.topk(qs), jeng.topk(qs))
    assert eng.weights_dtype == {"bf16": "bfloat16", "int8": "int8"}[
        precision]
    assert eng.table_bytes() == jeng.table_bytes()


def test_fm_int8_catalog_parity(tmp_path, fm_models):
    jm, tm = fm_models
    path = str(tmp_path / "fm8")
    freeze(tm, path, quantize="int8", quant_block_rows=8)
    kw = dict(k=8, block_items=24, max_batch=4, max_width=8)
    eng = engine(load(path), "t_fm8", **kw)
    eng.warmup()
    _assert_argsort_parity(eng, FM_ROWS[:5], k=8)
    _assert_same_topk(eng.topk(FM_ROWS[:5]),
                      JRetrieval(jax_load(path), name="j_fm8", **kw)
                      .topk(FM_ROWS[:5]))
    with pytest.raises(ValueError, match="aligned"):
        engine(load(path), "t_fm8_bad", k=8, block_items=20)


def tie_models(seed=3):
    """(jax, port) MF models whose 90 items repeat 10 distinct (Q, Bi)
    rows, with every value a multiple of 1/8 so each score is exact in f32
    whatever the summation order: every score occurs 9 times, across
    blocks and inside them."""
    d = warm_mf_numpy(N_USERS, N_ITEMS, 4, seed=seed)
    rng = np.random.RandomState(seed)
    d["P"] = (rng.randint(-8, 9, d["P"].shape) / 8).astype(np.float32)
    base = (rng.randint(-8, 9, (10, 4)) / 8).astype(np.float32)
    d["Q"] = base[np.arange(N_ITEMS) % 10]
    d["Bi"] = (rng.randint(-4, 5, 10) / 8).astype(np.float32)[
        np.arange(N_ITEMS) % 10]
    d["Bu"] = np.zeros(N_USERS, np.float32)
    d["mu"] = np.float32(0.5)
    from hivemall_tpu.models.mf import TrainedMFModel as JModel

    return (JModel(state=jax_mf_state(d), use_bias=True),
            TM.TrainedMFModel(state=TM.mf_state_from_numpy(d, "cpu"),
                              use_bias=True))


def test_planted_ties_resolve_to_the_lowest_id(tmp_path):
    jm, tm = tie_models()
    kw = dict(k=16, block_items=32, max_batch=4)
    eng = engine(tm, "t_ties", **kw)
    qs = [0, 1, 2, 3, 4]
    scores = eng.score_catalog(qs)
    assert all(len(np.unique(row)) <= 10 for row in scores)  # ties planted
    _assert_argsort_parity(eng, qs, k=16)
    _assert_same_topk(eng.topk(qs), JRetrieval(jm, name="j_ties", **kw)
                      .topk(qs))
    # int8: many equal scores again (identical rows quantize identically)
    path = str(tmp_path / "ties8")
    freeze(tm, path, quantize="int8", quant_block_rows=16)
    eng8 = engine(load(path), "t_ties8", **kw)
    _assert_argsort_parity(eng8, qs, k=16)
    _assert_same_topk(eng8.topk(qs), JRetrieval(jax_load(path),
                                                name="j_ties8", **kw)
                      .topk(qs))


def test_stable_topk_order():
    """The merge's sort: descending, equal values (and -0.0 / +0.0) in
    position order — a stable descending argsort's order."""
    vals = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, 3.0, float("-inf"),
                          2.0]])
    ids = torch.arange(8)[None, :] + 100
    tv, ti = _stable_topk(vals, ids, 6)
    want = np.argsort(-vals.numpy()[0], kind="stable")[:6]
    assert ti[0].tolist() == (want + 100).tolist()
    assert tv[0].numpy().tobytes() == vals.numpy()[0][want].tobytes()


def test_candidate_ids_past_the_catalog_read_zero_rows():
    """The candidate scorer against the JAX package's: ids past the padded
    catalog read a zero row (JAX's fill-mode gather), so a masked-in
    candidate there scores its base; masked-out lanes never win."""
    rng = np.random.RandomState(0)
    n, bk, f = 40, 16, 4  # padded to 48
    vec = rng.randn(n, f).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    tcat = _SingleCatalog(vec, bias, None, None, n, bk, 16, None, False,
                          torch.device("cpu"))
    jcat = JCatalog(vec, bias, None, None, n, bk, 16, None, False)
    qvec = rng.randn(2, f).astype(np.float32)
    base = np.array([5.0, -1.0], np.float32)
    ids = np.array([[0, 3, 45, 60, 200, 7, 1, 2, 9, 11, 12, 13, 14, 15, 16,
                     17],
                    [39, 48, 100, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
                   np.int64)
    mask = np.zeros(ids.shape, bool)
    mask[0, :] = True
    mask[1, :5] = True
    tv, ti = tcat.run_cand(qvec, base, ids, mask)
    jv, ji = jcat.run_cand(qvec, base, ids.astype(np.int32), mask)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    assert ti.numpy().tolist() == np.asarray(ji).tolist()
    # a past-the-catalog candidate scores exactly its base
    got = dict(zip(ti[0].tolist(), tv[0].tolist()))
    assert got[200] == 5.0 and got[60] == 5.0
    assert float(tv[1, -1]) == float("-inf")  # only 5 live lanes in row 1


def test_lsh_index_freeze_load_roundtrip(tmp_path, mf_models):
    jm, tm = mf_models
    opts = {"planes": 4, "seed": 7}
    freeze(tm, str(tmp_path / "a"), retrieval_index=opts)
    freeze(tm, str(tmp_path / "b"), retrieval_index=opts)
    jax_freeze(jm, str(tmp_path / "j"), retrieval_index=opts)
    a1, a2, aj = (load(str(tmp_path / x)) for x in "abj")
    # deterministic seeding, and the JAX package's bytes
    for key in ("index__planes", "index__item_ids", "index__offsets"):
        assert a1.arrays[key].tobytes() == a2.arrays[key].tobytes()
        assert a1.arrays[key].tobytes() == aj.arrays[key].tobytes()
        assert a1.arrays[key].dtype == aj.arrays[key].dtype
    assert a1.meta["index"] == aj.meta["index"] == {
        "scheme": "srp_lsh", "planes": 4, "seed": 7, "item_lo": 0,
        "item_hi": N_ITEMS}
    idx = SRPIndex.from_artifact(a1)
    assert idx is not None and idx.n_planes == 4 and idx.seed == 7
    q = TM.mf_state_to_numpy(tm.state)["Q"]
    got, want = build_srp_index(q, 4, 7), jax_build_srp_index(q, 4, 7)
    for x, y, z in zip(got, want, (idx.planes, idx.item_ids, idx.offsets)):
        assert x.tobytes() == y.tobytes() == z.tobytes()
    freeze(tm, str(tmp_path / "c"))
    assert SRPIndex.from_artifact(load(str(tmp_path / "c"))) is None
    probe = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    from hivemall_tpu.serving.retrieval import SRPIndex as JIndex

    for x, y in zip(idx.probe(probe), JIndex.from_artifact(aj).probe(probe)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("quantize", [None, "bf16", "int8"])
def test_artifacts_cross_load_with_index(tmp_path, mf_models, quantize):
    """MF artifacts with an LSH index: the port's loads in the JAX package
    and the JAX package's in the port, and both engines rank the same."""
    jm, tm = mf_models
    kw = dict(k=8, block_items=16, max_batch=4)
    opts = {"planes": 4, "seed": 3}
    qb = 16 if quantize else None
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    freeze(tm, port_dir, quantize=quantize, quant_block_rows=qb,
           retrieval_index=opts)
    jax_freeze(jm, jax_dir, quantize=quantize, quant_block_rows=qb,
               retrieval_index=opts)
    qs = [1, 4, 9, 22]
    for path in (port_dir, jax_dir):
        tag = f"{quantize}_{path[-3:]}"
        t = engine(load(path), f"t_x_{tag}", **kw)
        j = JRetrieval(jax_load(path), name=f"j_x_{tag}", **kw)
        for probe in (False, True):
            _assert_same_topk(t.topk(qs, probe=probe),
                              j.topk(qs, probe=probe))


def test_lsh_probe_scores_match_exact(tmp_path, mf_models):
    from hivemall_tpu_torch.runtime.metrics import REGISTRY

    _, tm = mf_models
    d = str(tmp_path / "art")
    freeze(tm, d, retrieval_index={"planes": 4, "seed": 7})
    eng = engine(load(d), "t_probe", k=8, block_items=32, max_batch=4)
    eng.warmup()
    c0 = _segments("t_probe")
    qs = [0, 5, 12, 21]
    probed = eng.topk(qs, probe=True)
    scores = eng.score_catalog(qs)
    for row, out in zip(scores, probed):
        # every probed (item, score) pair carries the catalog score for
        # that item; the candidate gather reduces in its own order
        for item, val in zip(out["items"], out["scores"]):
            assert np.isclose(val, row[item], rtol=RTOL, atol=ATOL)
        assert all(a >= b for a, b in zip(out["scores"],
                                          out["scores"][1:]))
    assert _segments("t_probe") == c0
    assert REGISTRY.counter("retrieval", "t_probe.probed").value >= 1
    # a candidate cap below the bucket unions forces the exact fallback
    eng_fb = engine(load(d), "t_probe_fb", k=8, block_items=32,
                    max_batch=4, candidate_cap=16)
    f0 = REGISTRY.counter("retrieval", "t_probe_fb.fallback").value
    fb = eng_fb.topk(qs, probe=True)
    exact = eng_fb.topk(qs, probe=False)
    assert REGISTRY.counter("retrieval", "t_probe_fb.fallback").value > f0
    assert [o["items"] for o in fb] == [o["items"] for o in exact]
    # probing without an index falls back too, counted
    plain = engine(tm, "t_probe_none", k=8, block_items=32)
    p0 = REGISTRY.counter("retrieval", "t_probe_none.fallback").value
    assert plain.topk([3], probe=True) == plain.topk([3])
    assert REGISTRY.counter("retrieval",
                            "t_probe_none.fallback").value == p0 + 1


def test_bad_families_and_sharded_placement_refused(tmp_path, mf_models):
    rows = [[f"{i % 7}:1.0"] for i in range(30)]
    labels = [1 if i % 2 else -1 for i in range(30)]
    linear = train_perceptron(rows, labels, "-dims 64", device="cpu")
    with pytest.raises(ValueError, match="family"):
        engine(linear, "t_bad")
    with pytest.raises(ValueError, match="has no retrieval path"):
        freeze(linear, str(tmp_path / "lin"), retrieval_index={})
    _, tm = mf_models
    for placement in ("model_sharded", "replicated"):
        with pytest.raises(ValueError, match="later slice"):
            engine(tm, "t_sharded", placement=placement)
    with pytest.raises(ValueError, match="out of range"):
        engine(tm, "t_k", k=N_ITEMS + 1)
    with pytest.raises(ValueError, match="outside"):
        engine(tm, "t_rng", item_range=(0, N_ITEMS + 5))
    with pytest.raises(ValueError, match="unknown keys"):
        freeze(tm, str(tmp_path / "k"), retrieval_index={"bands": 2})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RetrievalEngine(tm, name="t_nocuda")


# --- /topk through the registry ----------------------------------------------


def _post(port, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/topk",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_topk_endpoint_end_to_end(mf_models):
    _, tm = mf_models
    registry = ModelRegistry(max_batch=16, max_delay_ms=1.0, device="cpu")
    server = serve(registry)
    port = server.server_address[1]
    try:
        rows = [[f"{i % 7}:1.0"] for i in range(30)]
        labels = [1 if i % 2 else -1 for i in range(30)]
        registry.deploy("ctr", train_perceptron(rows, labels, "-dims 64",
                                                device="cpu"), version="1")
        entry = registry.deploy(
            "rec", tm, version="1",
            retrieval={"k": 8, "block_items": 32, "max_batch": 4})
        assert entry.retrieval_engine is not None
        assert entry.retrieval_engine.device == torch.device("cpu")
        assert entry.describe()["retrieval"]["enabled"] is True

        # wire format + parity with a direct engine call
        code, out = _post(port, {"model": "rec", "queries": [0, 1, 2],
                                 "k": 5})
        assert code == 200 and out["model"] == "rec" and out["k"] == 5
        want = entry.retrieval_engine.topk([0, 1, 2], k=5)
        for got, ref in zip(out["results"], want):
            assert got["items"] == ref["items"]
            assert got["scores"] == ref["scores"]

        # k omitted -> the engine default
        code, out = _post(port, {"model": "rec", "queries": [4]})
        assert code == 200 and out["k"] == 8
        assert len(out["results"][0]["items"]) == 8

        # priority + deadline ride the same headers as /predict
        code, out = _post(port, {"model": "rec", "queries": [1], "k": 2},
                          headers={"x-priority": "high",
                                   "x-deadline-ms": "5000"})
        assert code == 200

        # MF /predict takes [user, item] pairs, beside /topk
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=json.dumps({"model": "rec",
                             "instances": [[0, 1], [2, 3]]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            preds = json.loads(r.read())["predictions"]
        np.testing.assert_array_equal(np.asarray(preds, np.float32),
                                      tm.predict([0, 2], [1, 3]))

        # 404 unknown model; 400 deployed-without-retrieval; 400 payloads
        assert _post(port, {"model": "nope", "queries": [0]})[0] == 404
        code, out = _post(port, {"model": "ctr", "queries": [0]})
        assert code == 400 and "retrieval" in out["error"]
        assert _post(port, {"model": "rec"})[0] == 400
        assert _post(port, {"model": "rec", "queries": "x"})[0] == 400
        assert _post(port, {"model": "rec", "queries": [0],
                            "k": 0})[0] == 400
        assert _post(port, {"model": "rec", "queries": [0],
                            "deadline_ms": -1})[0] == 400
        # engine errors surface as 500, not hangs
        assert _post(port, {"model": "rec",
                            "queries": [10 ** 6]})[0] == 500

        # /models carries the retrieval block for both models
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/models", timeout=10) as r:
            models = {m["name"]: m for m in json.loads(r.read())["models"]}
        assert models["rec"]["retrieval"]["enabled"] is True
        assert models["rec"]["retrieval"]["catalog_items"] == N_ITEMS
        assert models["ctr"]["retrieval"] == {"enabled": False}

        # hot swap: the old retrieval batcher drains, the new one serves
        old = entry.retrieval_batcher
        registry.deploy("rec", tm, version="2",
                        retrieval={"k": 8, "block_items": 32,
                                   "max_batch": 4})
        code, out = _post(port, {"model": "rec", "queries": [0], "k": 3})
        assert code == 200 and out["version"] == "2"
        with pytest.raises(Exception):
            old.submit([(0, None, None)]).result(5)

        # undeploy closes the retrieval batcher and 404s the route
        new = registry.get("rec").retrieval_batcher
        assert registry.undeploy("rec") is True
        assert _post(port, {"model": "rec", "queries": [0]})[0] == 404
        with pytest.raises(Exception):
            new.submit([(0, None, None)]).result(5)
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
