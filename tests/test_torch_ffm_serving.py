"""FFM model blobs, artifacts and serving across the two packages
(hivemall_tpu_torch/models/ffm.py to_blob / from_blob,
serving/artifact.py, engine.py and adapters/model_rows.py against the JAX
package's), on the CPU.

The models are trained by the JAX package on a small table, so most V
rows are still the initial draw: the blob stores only the rows that moved
and re-derives the rest from the seeded draw, which the port makes with
its numpy copy of JAX's stream (utils/jax_prng.py). The state is carried
into the port; each package's blob of it is byte-equal, each reads the
other's, and the scores agree within rtol 1e-5 / atol 1e-6."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from hivemall_tpu.adapters.model_rows import iter_model_rows as jax_iter
from hivemall_tpu.models import ffm as JFF
from hivemall_tpu.serving import ServingEngine as JEngine
from hivemall_tpu.serving import freeze as jax_freeze
from hivemall_tpu.serving import load as jax_load
from hivemall_tpu_torch.adapters.model_rows import iter_model_rows
from hivemall_tpu_torch.models import ffm as TFF
from hivemall_tpu_torch.models.classifier import train_arow
from hivemall_tpu_torch.serving import (ModelRegistry, ServingEngine, freeze,
                                        load, make_servable, serve)
from hivemall_tpu_torch.serving.artifact import family_of, rebuild_model

from torch_cases import ATOL, RTOL, ffm_rows, jax_ffm_numpy

TIMEOUT = 10
OPTS = ["-factor 4 -feature_hashing 12 -v_bits 12 -num_fields 8 "
        "-mini_batch 64", "-factor 3 -feature_hashing 12 -v_bits 13 "
        "-num_fields 8 -w0 -disable_wi -seed 5"]


def carried_ffm_models(opts):
    """(jax_model, port_model): a JAX-trained FFM and its state carried
    into the port's TrainedFFMModel (on the CPU)."""
    rows, y = ffm_rows(n=200, extra=2)
    jm = JFF.train_ffm(rows, y, opts)
    hyper = TFF.ffm_hyper_from_options(TFF._ffm_options().parse(opts,
                                                                "train_ffm"))
    tm = TFF.TrainedFFMModel(
        state=TFF.ffm_state_from_numpy(jax_ffm_numpy(jm.state), "cpu"),
        hyper=hyper)
    return jm, tm, rows


@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("half", [False, True])
def test_to_blob_bytes_equal_jax(opts, half):
    jm, tm, _ = carried_ffm_models(opts)
    blob = tm.to_blob(half_float=half)
    assert blob == jm.to_blob(half_float=half)
    n_changed = int(np.any(np.asarray(jm.state.v) != TFF.initial_v(tm.hyper),
                           axis=1).sum())
    assert 0 < n_changed < tm.hyper.v_dims  # untouched rows left out


@pytest.mark.parametrize("opts", OPTS)
def test_blobs_cross_load(opts):
    jm, tm, rows = carried_ffm_models(opts)
    want = np.asarray(jm.predict(rows))
    # the JAX blob read by the port, and the port's blob read by JAX
    from_jax = TFF.TrainedFFMModel.from_blob(jm.to_blob(half_float=False),
                                             device="cpu")
    np.testing.assert_allclose(from_jax.predict(rows), want, rtol=RTOL,
                               atol=ATOL)
    from_port = JFF.TrainedFFMModel.from_blob(tm.to_blob(half_float=False))
    np.testing.assert_allclose(np.asarray(from_port.predict(rows)),
                               tm.predict(rows), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.predict(rows), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(from_jax.state.v.numpy(),
                                  np.asarray(jm.state.v))


@pytest.mark.parametrize("opts", OPTS)
def test_ffm_artifacts_cross_load_and_serve(tmp_path, opts):
    jm, tm, rows = carried_ffm_models(opts)
    p_port, p_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    m_port = freeze(tm, p_port, name="ffm")
    m_jax = jax_freeze(jm, p_jax, name="ffm")
    strip = ("created_unix", "sha256")
    assert {k: v for k, v in m_port.items() if k not in strip} == \
        {k: v for k, v in m_jax.items() if k not in strip}
    assert load(p_port).arrays["blob"].tobytes() == \
        load(p_jax).arrays["blob"].tobytes()
    want = JEngine(jax_load(p_jax), name="fz_jax", max_batch=16,
                   max_width=16).predict(rows)
    for path in (p_jax, p_port):
        eng = ServingEngine(load(path), name="fz_port", max_batch=16,
                            max_width=16, device="cpu")
        assert eng.family == "ffm"
        np.testing.assert_allclose(eng.predict(rows), want, rtol=RTOL,
                                   atol=ATOL)
    jeng = JEngine(jax_load(p_port), name="fz_jax2", max_batch=16,
                   max_width=16)
    np.testing.assert_allclose(jeng.predict(rows), want, rtol=RTOL,
                               atol=ATOL)
    model = rebuild_model(load(p_port), device="cpu")
    assert isinstance(model, TFF.TrainedFFMModel)
    np.testing.assert_allclose(model.predict(rows), tm.predict(rows),
                               rtol=1e-6, atol=1e-7)


def test_ffm_served_equals_model_predict_and_table_bytes(tmp_path):
    _, tm, rows = carried_ffm_models(OPTS[0])
    freeze(tm, str(tmp_path / "a"))
    for source in (tm, str(tmp_path / "a")):
        eng = ServingEngine(source, name="ff_live", max_batch=32,
                            max_width=16, device="cpu")
        assert eng.warmup() == 0
        np.testing.assert_allclose(eng.predict(rows), tm.predict(rows),
                                   rtol=1e-6, atol=1e-7)
        hy = tm.hyper
        assert eng.table_bytes == 4 * (hy.v_dims * hy.factors
                                       + hy.num_features + 1)


def test_ffm_quantized_freeze_refused_as_jax(tmp_path):
    jm, tm, _ = carried_ffm_models(OPTS[0])
    assert family_of(tm) == "ffm"
    for q in ("int8", "bf16"):
        with pytest.raises(ValueError, match="no quantized") as port_err:
            freeze(tm, str(tmp_path / f"p{q}"), quantize=q)
        with pytest.raises(ValueError, match="no quantized") as jax_err:
            jax_freeze(jm, str(tmp_path / f"j{q}"), quantize=q)
        assert str(port_err.value) == str(jax_err.value)


def test_ffm_iter_model_rows_equal_jax():
    jm, tm, _ = carried_ffm_models(OPTS[0])
    tc, trows = iter_model_rows(tm)
    jc, jrows = jax_iter(jm)
    assert tc == jc == ["feature", "Wi", "blob"]
    trows, jrows = list(trows), list(jrows)
    assert trows == jrows
    assert trows[-1][0] == -2 and trows[-1][2]


def test_ffm_serving_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    _, tm, _ = carried_ffm_models(OPTS[0])
    freeze(tm, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_servable(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFF.TrainedFFMModel.from_blob(tm.to_blob())
    assert make_servable(tm).device == torch.device("cpu")


def test_ffm_registry_predict_round_trip(tmp_path):
    """A trained port FFM, frozen, deployed beside a linear model:
    /predict answers each by name with its engine's scores."""
    rows, y = ffm_rows(n=200, extra=2)
    ffm = TFF.train_ffm(rows, y, OPTS[0], device="cpu")
    freeze(ffm, str(tmp_path / "ffm1"), name="ffm", version="1")
    lin_rows = [[t.split(":", 1)[1] for t in r] for r in rows]
    lin = train_arow(lin_rows, y, "-dims 512", device="cpu")
    registry = ModelRegistry(max_batch=32, max_delay_ms=1.0, device="cpu",
                             engine_kwargs={"max_batch": 32, "max_width": 16})
    server = serve(registry)
    try:
        registry.deploy("ffm", str(tmp_path / "ffm1"))
        registry.deploy("ctr", lin, version="1")
        port = server.server_address[1]
        for s in (0, 64, 128):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict",
                data=json.dumps({"model": "ffm",
                                 "instances": rows[s:s + 64]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                out = json.loads(r.read())
            assert out["model"] == "ffm"
            np.testing.assert_allclose(out["predictions"],
                                       ffm.predict(rows[s:s + 64]),
                                       rtol=1e-6, atol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/models",
                                    timeout=TIMEOUT) as r:
            models = json.loads(r.read())["models"]
        assert {(m["name"], m["family"]) for m in models} == \
            {("ffm", "ffm"), ("ctr", "linear")}
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
