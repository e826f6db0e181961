"""FM serving across the two packages (hivemall_tpu_torch/serving/
artifact.py, engine.py and adapters/model_rows.py against the JAX
package's), on the CPU.

One warm FM state is carried into both packages. The artifacts each
freezes from it, at f32, bf16 and int8, hold exactly equal arrays and
equal manifests but for ``created_unix`` and ``sha256`` (the npz's zip
members carry their write time); each package loads and serves the other's
artifact, and the port's served scores equal the JAX engine's within rtol
1e-5 / atol 1e-6. Then the port's own contracts: f32 serving equals
``TrainedFMModel.predict``, int8 equals numpy scoring of the dequantized
tables, table bytes per precision, and one HTTP round trip."""

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
from hivemall_tpu.serving.artifact import rebuild_model as jax_rebuild
from hivemall_tpu_torch.adapters.model_rows import iter_model_rows
from hivemall_tpu_torch.io.checkpoint import dequantize_int8
from hivemall_tpu_torch.models.classifier import train_arow
from hivemall_tpu_torch.models.fm import train_fm
from hivemall_tpu_torch.serving import (ModelRegistry, ServingEngine, freeze,
                                        load, make_servable, serve)
from hivemall_tpu_torch.serving.artifact import (MANIFEST_FILE, family_of,
                                                 rebuild_model)

from torch_cases import ATOL, RTOL, carried_fm_models, request_rows

DIMS = 1024
PRECISIONS = [None, "bf16", "int8"]
IDS = ["f32", "bf16", "int8"]
TIMEOUT = 10


def _freeze_both(tmp_path, quantize, factors=5):
    jm, tm = carried_fm_models(dims=DIMS, factors=factors, seed=3)
    kw = dict(name="fm", version="2", quantize=quantize,
              quant_block_rows=64 if quantize == "int8" else None)
    p_port, p_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    m_port = freeze(tm, p_port, **kw)
    m_jax = jax_freeze(jm, p_jax, **kw)
    return jm, tm, (p_port, m_port), (p_jax, m_jax)


def _scores_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("quantize", PRECISIONS, ids=IDS)
def test_fm_artifacts_of_one_state_are_equal(tmp_path, quantize):
    _, _, (p_port, m_port), (p_jax, m_jax) = _freeze_both(tmp_path, quantize)
    assert m_port["family"] == "fm"
    strip = ("created_unix", "sha256")
    assert {k: v for k, v in m_port.items() if k not in strip} == \
        {k: v for k, v in m_jax.items() if k not in strip}
    with open(os.path.join(p_port, MANIFEST_FILE)) as f:
        assert json.load(f) == m_port
    a, b = load(p_port).arrays, load(p_jax).arrays
    assert list(a) == list(b)  # same names, same order in the pack
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    c = jax_load(p_port).arrays  # the JAX loader reads the port's pack
    for k in a:
        assert a[k].tobytes() == c[k].tobytes(), k


@pytest.mark.parametrize("quantize", PRECISIONS, ids=IDS)
def test_fm_jax_freeze_port_serve(tmp_path, quantize):
    """JAX freeze -> port load -> port engine == JAX engine on the same
    artifact, at the manifest's precision."""
    _, _, _, (p_jax, man) = _freeze_both(tmp_path, quantize)
    rows = request_rows(DIMS, n=40, k=14)
    want = JEngine(jax_load(p_jax), name="fx_jax", max_batch=16,
                   max_width=16).predict(rows)
    eng = ServingEngine(load(p_jax), name="fx_port", max_batch=16,
                        max_width=16, device="cpu")
    assert eng.family == "fm"
    assert eng.weights_dtype == man["meta"]["weights_dtype"]
    _scores_close(eng.predict(rows), want)


@pytest.mark.parametrize("quantize", PRECISIONS, ids=IDS)
def test_fm_port_freeze_jax_serve(tmp_path, quantize):
    """port freeze -> JAX load -> JAX engine == port engine on the same
    artifact, and the JAX runtime sees the dtype the port recorded."""
    _, _, (p_port, man), _ = _freeze_both(tmp_path, quantize)
    rows = request_rows(DIMS, n=40, k=14, seed=2)
    jeng = JEngine(jax_load(p_port), name="fy_jax", max_batch=16,
                   max_width=16)
    assert jeng.weights_dtype == man["meta"]["weights_dtype"]
    eng = ServingEngine(load(p_port), name="fy_port", max_batch=16,
                        max_width=16, device="cpu")
    _scores_close(eng.predict(rows), jeng.predict(rows))


@pytest.mark.parametrize("factors", [5, 8])
def test_fm_f32_served_equals_model_predict(tmp_path, factors):
    _, tm = carried_fm_models(dims=DIMS, factors=factors, seed=6)
    rows = request_rows(DIMS, n=70, k=14, seed=3)
    want = tm.predict(rows)
    freeze(tm, str(tmp_path / "a"))
    for source in (tm, str(tmp_path / "a")):
        eng = ServingEngine(source, name="f_live", max_batch=32,
                            max_width=16, device="cpu")
        _scores_close(eng.predict(rows), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("quantize,kp", [(None, 8), ("bf16", 8),
                                         ("int8", 8), ("int8", 16)])
def test_fm_table_bytes_and_dtype_per_precision(tmp_path, quantize, kp):
    """Resident score-table bytes: w [D] and v [D, kp] at 4 / 2 bytes, or
    int8 plus f32 scales of [D/64] and [D/64, kp]."""
    _, tm = carried_fm_models(dims=DIMS, factors=kp - 3 if kp == 8 else 11)
    assert tm.state.v.shape == (DIMS, kp)
    freeze(tm, str(tmp_path / "a"), quantize=quantize)
    sv = make_servable(str(tmp_path / "a"), device="cpu")
    nb = DIMS // 64
    want = {None: 4 * DIMS * (1 + kp), "bf16": 2 * DIMS * (1 + kp),
            "int8": DIMS * (1 + kp) + 4 * nb * (1 + kp)}[quantize]
    assert sv.table_bytes() == want
    if quantize == "int8":
        assert sv.qv.dtype == torch.int8 and sv.v_scales.shape == (nb, kp)
        assert sv.w0.dtype == torch.float32
    else:
        dt = torch.bfloat16 if quantize else torch.float32
        assert sv.state.w.dtype == sv.state.v.dtype == dt
        assert sv.state.w0.dtype == torch.float32


def test_fm_int8_scores_equal_numpy_on_dequantized_tables(tmp_path):
    _, tm = carried_fm_models(dims=DIMS, seed=8)
    art_dir = str(tmp_path / "q")
    freeze(tm, art_dir, quantize="int8", quant_block_rows=64)
    a = load(art_dir).arrays
    w = dequantize_int8(a["w"], a["w__scale"], 64).astype(np.float64)
    v = dequantize_int8(a["v"], a["v__scale"], 64).astype(np.float64)
    rows = request_rows(DIMS, n=50, k=14, seed=4)
    want = []
    for r in rows:
        ids = np.array([int(c.split(":")[0]) % DIMS for c in r])
        xs = np.array([float(c.split(":")[1]) for c in r])
        vx = v[ids] * xs[:, None]
        want.append(float(a["w0"]) + w[ids] @ xs + 0.5 * np.sum(
            vx.sum(0) ** 2 - (vx * vx).sum(0)))
    got = ServingEngine(art_dir, name="f_q8", max_batch=16, max_width=16,
                        device="cpu").predict(rows)
    _scores_close(got, want)


def test_fm_iter_model_rows_equal_jax():
    jm, tm = carried_fm_models(dims=256, seed=2)
    tc, trows = iter_model_rows(tm)
    jc, jrows = jax_iter(jm)
    assert tc == jc == ["feature", "Wi", "Vif"]
    trows, jrows = list(trows), list(jrows)
    assert trows == jrows
    assert trows[0] == (-1, float(tm.state.w0), None)
    assert all(len(r[2]) == 5 for r in trows[1:])


def test_fm_family_and_rebuild_model_answer_as_jax(tmp_path):
    jm, tm = carried_fm_models(dims=256)
    assert family_of(tm) == "fm"
    for q in (None, "int8"):
        path = str(tmp_path / str(q))
        freeze(tm, path, quantize=q)
        with pytest.raises(ValueError, match="make_servable") as port_err:
            rebuild_model(load(path))
        with pytest.raises(ValueError, match="make_servable") as jax_err:
            jax_rebuild(jax_load(path))
        assert str(port_err.value) == str(jax_err.value)


def test_fm_serving_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    _, tm = carried_fm_models(dims=256)
    freeze(tm, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_servable(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(load(str(tmp_path / "a")), name="f_nocuda")
    # a trained port model serves on its own device (here the CPU)
    assert make_servable(tm).device == torch.device("cpu")


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_fm_registry_predict_round_trip(tmp_path):
    """A trained port FM, frozen, deployed beside a linear model in one
    registry: /predict answers each by name with its engine's scores."""
    rng = np.random.RandomState(0)
    rows = [[f"{i}:1.0" for i in rng.randint(0, 300, 6)] for _ in range(200)]
    labels = rng.randint(0, 2, 200)
    fm = train_fm(rows, labels, "-c -dims 512 -factor 5 -mini_batch 32",
                  device="cpu")
    freeze(fm, str(tmp_path / "fm1"), name="fm", version="1")
    lin = train_arow(rows, labels, "-dims 512", device="cpu")
    registry = ModelRegistry(max_batch=32, max_delay_ms=1.0, device="cpu",
                             engine_kwargs={"max_batch": 32, "max_width": 16})
    server = serve(registry)
    try:
        registry.deploy("fm", str(tmp_path / "fm1"))
        registry.deploy("ctr", lin, version="1")
        port = server.server_address[1]
        for s in (0, 64, 128):
            out = _post(port, {"model": "fm", "instances": rows[s:s + 64]})
            assert out["model"] == "fm" and out["version"] == "1"
            _scores_close(out["predictions"], fm.predict(rows[s:s + 64]),
                          rtol=1e-6, atol=1e-6)
        out = _post(port, {"model": "ctr", "instances": rows[:8]})
        _scores_close(out["predictions"], lin.predict(rows[:8]), rtol=1e-6,
                      atol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/models",
                                    timeout=TIMEOUT) as r:
            models = json.loads(r.read())["models"]
        assert {(m["name"], m["family"]) for m in models} == \
            {("fm", "fm"), ("ctr", "linear")}
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
