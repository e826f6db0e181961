"""Multiclass serving across the two packages (hivemall_tpu_torch/serving/
artifact.py, engine.py and adapters/model_rows.py against the JAX
package's), on the CPU.

One warm multiclass state (labels: strings and an int) is carried into
both packages. The artifacts each freezes from it, at f32, bf16 and int8,
hold equal arrays and equal manifests but for ``created_unix`` and
``sha256``; each package loads and serves the other's artifact, and the
port answers the JAX engine's labels, with its per-label scores within
rtol 1e-5 / atol 1e-6. Then the port's own contracts: f32 serving equals
``TrainedMulticlassModel.predict``, int8 scores equal numpy on the
dequantized table, table bytes per precision, model rows, and an HTTP
round trip answering labels as JSON values."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from hivemall_tpu.adapters.model_rows import iter_model_rows as jax_iter
from hivemall_tpu.serving import ServingEngine as JEngine
from hivemall_tpu.serving import freeze as jax_freeze
from hivemall_tpu.serving import load as jax_load
from hivemall_tpu.serving.artifact import host_score_tables as jax_tables
from hivemall_tpu.serving.artifact import rebuild_model as jax_rebuild
from hivemall_tpu_torch.adapters.model_rows import iter_model_rows
from hivemall_tpu_torch.io.checkpoint import dequantize_int8
from hivemall_tpu_torch.models.classifier import train_arow
from hivemall_tpu_torch.models.multiclass import train_multiclass_arow
from hivemall_tpu_torch.serving import (ModelRegistry, ServingEngine, freeze,
                                        load, make_servable, serve)
from hivemall_tpu_torch.serving.artifact import (MANIFEST_FILE, family_of,
                                                 host_score_tables,
                                                 rebuild_model)

from torch_cases import ATOL, RTOL, carried_mc_models, request_rows

DIMS = 1024
PRECISIONS = [None, "bf16", "int8"]
IDS = ["f32", "bf16", "int8"]
TIMEOUT = 10


def _freeze_both(tmp_path, quantize, use_cov=True):
    jm, tm = carried_mc_models(num_labels=5, dims=DIMS, use_cov=use_cov)
    kw = dict(name="mc", version="2", quantize=quantize,
              quant_block_rows=64 if quantize == "int8" else None)
    p_port, p_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    m_port = freeze(tm, p_port, **kw)
    m_jax = jax_freeze(jm, p_jax, **kw)
    return jm, tm, (p_port, m_port), (p_jax, m_jax)


def _raw_scores(servable, rows, b_pad=64, width=16):
    raw = servable.run_padded(rows, b_pad, width)
    return np.asarray(raw.cpu() if torch.is_tensor(raw) else raw)[:len(rows)]


@pytest.mark.parametrize("use_cov", [True, False])
@pytest.mark.parametrize("quantize", PRECISIONS, ids=IDS)
def test_mc_artifacts_of_one_state_are_equal(tmp_path, quantize, use_cov):
    _, _, (p_port, m_port), (p_jax, m_jax) = _freeze_both(tmp_path, quantize,
                                                          use_cov)
    assert m_port["family"] == "multiclass"
    strip = ("created_unix", "sha256")
    assert {k: v for k, v in m_port.items() if k not in strip} == \
        {k: v for k, v in m_jax.items() if k not in strip}
    with open(os.path.join(p_port, MANIFEST_FILE)) as f:
        assert json.load(f) == m_port
    a, b = load(p_port).arrays, load(p_jax).arrays
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("quantize", PRECISIONS, ids=IDS)
def test_mc_jax_freeze_port_serve(tmp_path, quantize):
    """JAX freeze -> port load -> port engine: the JAX engine's labels,
    and per-label scores within tolerance, at the manifest's precision."""
    _, _, _, (p_jax, man) = _freeze_both(tmp_path, quantize)
    rows = request_rows(DIMS, n=40, k=14)
    jeng = JEngine(jax_load(p_jax), name="mx_jax", max_batch=16,
                   max_width=16)
    eng = ServingEngine(load(p_jax), name="mx_port", max_batch=16,
                        max_width=16, device="cpu")
    assert eng.family == "multiclass"
    assert eng.weights_dtype == man["meta"]["weights_dtype"]
    assert eng.predict(rows) == jeng.predict(rows)
    np.testing.assert_allclose(_raw_scores(eng.servable, rows),
                               _raw_scores(jeng.servable, rows),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quantize", PRECISIONS, ids=IDS)
def test_mc_port_freeze_jax_serve(tmp_path, quantize):
    _, _, (p_port, man), _ = _freeze_both(tmp_path, quantize)
    rows = request_rows(DIMS, n=40, k=14, seed=2)
    jeng = JEngine(jax_load(p_port), name="my_jax", max_batch=16,
                   max_width=16)
    assert jeng.weights_dtype == man["meta"]["weights_dtype"]
    eng = ServingEngine(load(p_port), name="my_port", max_batch=16,
                        max_width=16, device="cpu")
    assert eng.predict(rows) == jeng.predict(rows)
    np.testing.assert_allclose(_raw_scores(eng.servable, rows),
                               _raw_scores(jeng.servable, rows),
                               rtol=RTOL, atol=ATOL)


def test_mc_f32_served_equals_model_predict(tmp_path):
    _, tm = carried_mc_models(num_labels=6, dims=DIMS, seed=5)
    rows = request_rows(DIMS, n=70, k=14, seed=3)
    freeze(tm, str(tmp_path / "a"))
    for source in (tm, str(tmp_path / "a")):
        eng = ServingEngine(source, name="m_live", max_batch=32,
                            max_width=16, device="cpu")
        assert eng.predict(rows) == tm.predict(rows)  # chunks of 32 too
        np.testing.assert_allclose(_raw_scores(eng.servable, rows[:32], 32),
                                   tm.scores(rows[:32]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("quantize", PRECISIONS, ids=IDS)
def test_mc_table_bytes_and_dtype_per_precision(tmp_path, quantize):
    _, tm = carried_mc_models(num_labels=5, dims=DIMS)
    freeze(tm, str(tmp_path / "a"), quantize=quantize)
    sv = make_servable(str(tmp_path / "a"), device="cpu")
    L, nb = 5, DIMS // 64
    want = {None: 4 * L * DIMS, "bf16": 2 * L * DIMS,
            "int8": L * DIMS + 4 * L * nb}[quantize]
    assert sv.table_bytes() == want
    if quantize == "int8":
        assert sv.qW.dtype == torch.int8 and sv.scales.shape == (L, nb)
    else:
        assert sv.weights.dtype == (torch.bfloat16 if quantize
                                    else torch.float32)


def test_mc_int8_scores_equal_numpy_on_dequantized_table(tmp_path):
    _, tm = carried_mc_models(num_labels=5, dims=DIMS, seed=8)
    art_dir = str(tmp_path / "q")
    freeze(tm, art_dir, quantize="int8", quant_block_rows=64)
    a = load(art_dir).arrays
    W = dequantize_int8(a["weights"], a["weights__scale"], 64, axis=1)
    rows = request_rows(DIMS, n=50, k=14, seed=4)
    want = []
    for r in rows:
        ids = np.array([int(c.split(":")[0]) % DIMS for c in r])
        xs = np.array([float(c.split(":")[1]) for c in r], np.float32)
        want.append(W[:, ids] @ xs)
    sv = make_servable(art_dir, device="cpu")
    np.testing.assert_allclose(_raw_scores(sv, rows), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_cov", [True, False])
def test_mc_iter_model_rows_equal_jax(use_cov):
    jm, tm = carried_mc_models(num_labels=4, dims=128, use_cov=use_cov)
    tc, trows = iter_model_rows(tm)
    jc, jrows = jax_iter(jm)
    assert tc == jc
    assert list(trows) == list(jrows)


def test_mc_family_tables_and_rebuild_answer_as_jax(tmp_path):
    jm, tm = carried_mc_models(num_labels=4, dims=256)
    assert family_of(tm) == "multiclass"
    for q in (None, "int8"):
        path = str(tmp_path / str(q))
        freeze(tm, path, quantize=q, quant_block_rows=64 if q else None)
        with pytest.raises(ValueError, match="make_servable") as port_err:
            rebuild_model(load(path), device="cpu")
        with pytest.raises(ValueError, match="make_servable") as jax_err:
            jax_rebuild(jax_load(path))
        assert str(port_err.value) == str(jax_err.value)
        got, want = host_score_tables(load(path)), jax_tables(jax_load(path))
        assert got["weights_dtype"] == want["weights_dtype"]
        assert [(n, ax, g) for n, _, ax, g in got["striped"]] == \
            [(n, ax, g) for n, _, ax, g in want["striped"]]
        np.testing.assert_array_equal(np.asarray(got["striped"][0][1]),
                                      np.asarray(want["striped"][0][1]))
    live = host_score_tables(tm)
    assert live["meta"]["label_vocab"] == tm.label_vocab
    assert live["striped"][0][2] == 1


def test_mc_registry_predict_round_trip(tmp_path):
    """A trained port multiclass model, frozen, deployed beside a linear
    model: /predict answers labels (strings and an int) equal to the
    engine's."""
    rng = np.random.RandomState(0)
    rows = [[f"{i}:1.0" for i in rng.randint(0, 300, 6)] for _ in range(200)]
    y = [["red", "green", 3][int(r[0].split(":")[0]) % 3] for r in rows]
    mc = train_multiclass_arow(rows, y, "-dims 512 -mini_batch 32",
                               device="cpu")
    freeze(mc, str(tmp_path / "mc1"), name="mc", version="1")
    lin = train_arow(rows, [1 if v == "red" else 0 for v in y], "-dims 512",
                     device="cpu")
    registry = ModelRegistry(max_batch=32, max_delay_ms=1.0, device="cpu",
                             engine_kwargs={"max_batch": 32, "max_width": 16})
    server = serve(registry)
    try:
        registry.deploy("mc", str(tmp_path / "mc1"))
        registry.deploy("ctr", lin, version="1")
        port = server.server_address[1]
        for s in (0, 64, 128):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict",
                data=json.dumps({"model": "mc",
                                 "instances": rows[s:s + 64]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                out = json.loads(r.read())
            assert out["model"] == "mc"
            assert out["predictions"] == mc.predict(rows[s:s + 64])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/models",
                                    timeout=TIMEOUT) as r:
            models = json.loads(r.read())["models"]
        assert {(m["name"], m["family"]) for m in models} == \
            {("mc", "multiclass"), ("ctr", "linear")}
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
