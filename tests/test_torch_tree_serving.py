"""Forest and GBT serving across the two packages (hivemall_tpu_torch/
serving/artifact.py, engine.py and adapters/model_rows.py against the JAX
package's), on the CPU.

One model grown by each package from the same `-seed` (equal node for
node, tests/test_torch_trees.py) is frozen by each: the artifacts hold
equal arrays, array for array, and equal manifests but for
``created_unix`` and ``sha256`` (and the ``columns``' rows, which come
from each package's own model). Each package loads and serves the other's
artifact with equal labels. Then the port's own contracts: served labels
== ``predict``, the f32 staging and its f64 fallback when two bin edges
collapse under f32, ``quantize=`` refused, model rows, and an HTTP round
trip beside a linear model."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from hivemall_tpu.adapters.model_rows import iter_model_rows as jax_iter
from hivemall_tpu.models.trees import forest as JF
from hivemall_tpu.serving import ServingEngine as JEngine
from hivemall_tpu.serving import freeze as jax_freeze
from hivemall_tpu.serving import load as jax_load
from hivemall_tpu_torch.adapters.model_rows import iter_model_rows
from hivemall_tpu_torch.models.classifier import train_arow
from hivemall_tpu_torch.models.trees import forest as TF
from hivemall_tpu_torch.models.trees.binning import BinInfo
from hivemall_tpu_torch.serving import (ModelRegistry, ServingEngine, freeze,
                                        load, make_servable, serve)
from hivemall_tpu_torch.serving.artifact import (MANIFEST_FILE, family_of,
                                                 rebuild_model)
from hivemall_tpu_torch.serving.engine import _TreeServable

CPU = "cpu"
TIMEOUT = 10


def _data(n=300, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4)
    X[:, 3] = rng.randint(0, 3, n)
    y = ((X[:, 0] + X[:, 1] > 1) | (X[:, 3] == 2)).astype(int)
    return X, y


def _models(family):
    """(JAX model, port model) grown from one seed; equal node for node."""
    X, y = _data()
    if family == "forest":
        opts = "-trees 4 -depth 6 -seed 1 -attrs Q,Q,Q,C"
        return (JF.train_randomforest_classifier(X, y, opts),
                TF.train_randomforest_classifier(X, y, opts, device=CPU))
    if family == "forest_regr":
        yr = (2 * X[:, 0] + X[:, 3]).astype(np.float32)
        opts = "-trees 3 -depth 5 -seed 2"
        return (JF.train_randomforest_regr(X, yr, opts),
                TF.train_randomforest_regr(X, yr, opts, device=CPU))
    labels = np.array(["lo", "mid", "hi"])[(X[:, 0] * 3).astype(int)] \
        if family == "gbt_multi" else y
    opts = "-trees 5 -depth 3 -seed 3"
    return (JF.train_gradient_tree_boosting_classifier(X, labels, opts),
            TF.train_gradient_tree_boosting_classifier(X, labels, opts,
                                                       device=CPU))


FAMILIES = ["forest", "forest_regr", "gbt", "gbt_multi"]


def _strip(man):
    meta = {k: v for k, v in man["meta"].items() if k != "columns"}
    out = {k: v for k, v in man.items()
           if k not in ("created_unix", "sha256", "meta")}
    return out, meta


@pytest.mark.parametrize("family", FAMILIES)
def test_tree_artifacts_of_one_seed_are_equal(tmp_path, family):
    jm, tm = _models(family)
    p_port, p_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    m_port = freeze(tm, p_port, name="t", version="3")
    m_jax = jax_freeze(jm, p_jax, name="t", version="3")
    assert m_port["family"] == family_of(tm) == family.split("_")[0]
    assert _strip(m_port) == _strip(m_jax)
    assert m_port["meta"]["columns"] == m_jax["meta"]["columns"]
    with open(os.path.join(p_port, MANIFEST_FILE)) as f:
        assert json.load(f) == m_port
    a, b = load(p_port).arrays, jax_load(p_jax).arrays
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert all(a[k].dtype == np.float64 for k in a if k.endswith("__edges"))
    if family.startswith("gbt"):
        assert a["intercept"].dtype == np.float64


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("family", FAMILIES)
def test_tree_artifacts_serve_across_packages(tmp_path, family, direction):
    jm, tm = _models(family)
    path = str(tmp_path / "a")
    (jax_freeze(jm, path) if direction == "jax_to_port" else freeze(tm, path))
    X, _ = _data(n=40, seed=5)
    rows = X.tolist()
    eng = ServingEngine(load(path), name=f"tp_{family}_{direction}",
                        max_batch=16, device=CPU)
    jeng = JEngine(jax_load(path), name=f"tj_{family}_{direction}",
                   max_batch=16)
    got, want = eng.predict(rows), np.asarray(jeng.predict(rows))
    if family == "forest_regr":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tm.predict(X))
    assert eng.family == family.split("_")[0]


@pytest.mark.parametrize("family", FAMILIES)
def test_served_labels_equal_predict(family):
    _, tm = _models(family)
    X, _ = _data(n=70, seed=6)
    eng = ServingEngine(tm, name=f"tl_{family}", max_batch=32,
                        min_batch_bucket=8)
    assert eng.device == torch.device(CPU)  # where the model lives
    assert eng.warmup() == 0  # no allocator segment on the CPU
    assert eng.width_buckets() == [None]
    for n in (1, 7, 32, 70):  # 70 chunks at max_batch 32
        out = eng.predict(X[:n].tolist())
        if family == "forest_regr":
            np.testing.assert_allclose(out, tm.predict(X[:n]), rtol=1e-6)
        else:
            np.testing.assert_array_equal(out, tm.predict(X[:n]))
    tables = eng.servable.device_tables()
    assert all(t.device == torch.device(CPU) for t in tables)
    assert eng.table_bytes == sum(t.numel() * t.element_size()
                                  for t in tables) > 0


def test_tree_staging_is_f32_with_edges_narrowed(tmp_path):
    _, tm = _models("gbt")
    freeze(tm, str(tmp_path / "g"))
    sv = make_servable(load(str(tmp_path / "g")), device=CPU)
    assert sv.stage_dtype == np.float32
    assert sv.intercept.dtype == np.float32
    assert all(b.edges.dtype == np.float32 for b in sv.bins)
    X, _ = _data(n=8)
    staged = sv.stage(X.tolist(), 8, 16)
    assert staged.dtype == np.int32 and staged.shape == (8, 4)
    keys = sv.row_keys(X.tolist(), 16)
    assert len(keys) == 8 and len(set(keys)) == len(
        {r.tobytes() for r in staged})


def test_tree_serving_keeps_f64_when_edges_collapse(tmp_path):
    """A nominal code >= 2^24 collapses under f32 onto its neighbour: the
    model stays on the f64 path end to end, and still answers predict."""
    rng = np.random.RandomState(1)
    X = rng.rand(200, 2)
    codes = np.array([2.0 ** 24, 2.0 ** 24 + 1, 5.0])
    X[:, 1] = codes[rng.randint(0, 3, 200)]
    assert np.unique(codes.astype(np.float32)).size < 3
    y = ((X[:, 1] == 2.0 ** 24 + 1) | (X[:, 0] > 0.8)).astype(int)
    tm = TF.train_gradient_tree_boosting_classifier(
        X, y, "-trees 4 -depth 3 -seed 1 -attrs Q,C", device=CPU)
    freeze(tm, str(tmp_path / "g"))
    eng = ServingEngine(str(tmp_path / "g"), name="tf64", max_batch=64,
                        device=CPU)
    sv = eng.servable
    assert sv.stage_dtype == np.float64
    assert all(b.edges.dtype == np.float64 for b in sv.bins)
    assert sv.intercept.dtype == np.float64
    np.testing.assert_array_equal(eng.predict(X[:64].tolist()),
                                  tm.predict(X[:64]))
    bins = [BinInfo(False, np.array([1.7e9, 1.7e9 + 40.0, 1.7e9 + 80.0]), 3)]
    assert _TreeServable([], bins, torch.device(CPU)).stage_dtype == \
        np.float64


@pytest.mark.parametrize("quantize", ["bf16", "int8"])
def test_tree_quantize_and_rebuild_are_refused(tmp_path, quantize):
    _, tm = _models("forest")
    with pytest.raises(ValueError, match="no quantized serving path"):
        freeze(tm, str(tmp_path / "q"), quantize=quantize)
    freeze(tm, str(tmp_path / "f"))
    with pytest.raises(ValueError, match="make_servable"):
        rebuild_model(load(str(tmp_path / "f")), device=CPU)


@pytest.mark.parametrize("family", FAMILIES)
def test_tree_iter_model_rows_equal_jax(family):
    jm, tm = _models(family)
    tc, trows = iter_model_rows(tm)
    jc, jrows = jax_iter(jm)
    assert tc == jc
    assert list(trows) == list(jrows)


def test_tree_model_moves_to_another_device_only_when_asked():
    _, tm = _models("forest")
    sv = make_servable(tm)
    assert sv.device == tm.device == torch.device(CPU)
    assert make_servable(tm, device=CPU).device == torch.device(CPU)


def test_forest_registry_predict_round_trip(tmp_path):
    """A port forest, frozen, deployed beside a linear model: /predict
    answers the forest's labels as JSON ints equal to predict()."""
    X, y = _data(n=200, seed=2)
    forest = TF.train_randomforest_classifier(X, y, "-trees 3 -seed 4",
                                              device=CPU)
    freeze(forest, str(tmp_path / "rf1"), name="rf", version="1")
    rows = [[f"{i}:1.0" for i in np.random.RandomState(r).randint(0, 64, 5)]
            for r in range(64)]
    lin = train_arow(rows, [r % 2 for r in range(64)], "-dims 64",
                     device=CPU)
    registry = ModelRegistry(max_batch=32, max_delay_ms=1.0, device=CPU,
                             engine_kwargs={"max_batch": 32})
    server = serve(registry)
    try:
        registry.deploy("rf", str(tmp_path / "rf1"))
        registry.deploy("ctr", lin, version="1")
        port = server.server_address[1]
        for s in (0, 64, 128):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict",
                data=json.dumps({"model": "rf",
                                 "instances": X[s:s + 64].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                out = json.loads(r.read())
            assert out["model"] == "rf"
            assert out["predictions"] == forest.predict(X[s:s + 64]).tolist()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/models",
                                    timeout=TIMEOUT) as r:
            models = json.loads(r.read())["models"]
        assert {(m["name"], m["family"]) for m in models} == \
            {("rf", "forest"), ("ctr", "linear")}
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
