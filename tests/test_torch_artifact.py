"""Serving artifacts across the two packages (hivemall_tpu_torch/serving/
artifact.py against hivemall_tpu/serving/artifact.py), on the CPU.

One warm linear state is carried into both packages; the artifacts each
freezes from it must hold exactly equal arrays (names, dtypes, values) and
equal manifests but for ``created_unix`` and the pack's ``sha256`` (the
npz's zip members carry their write time). Then each package serves the
other's artifact: scores within rtol 1e-5 / atol 1e-6 of the writer's own
engine."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.serving import ServingEngine as JEngine
from hivemall_tpu.serving import freeze as jax_freeze
from hivemall_tpu.serving import load as jax_load
from hivemall_tpu.serving.artifact import manifest_quant as jax_manifest_quant
from hivemall_tpu.serving.engine import make_servable as jax_make_servable
from hivemall_tpu_torch.io.checkpoint import dequantize_int8
from hivemall_tpu_torch.serving import ServingEngine, freeze, load
from hivemall_tpu_torch.serving.artifact import (ARRAYS_FILE, MANIFEST_FILE,
                                                 manifest_quant, rebuild_model)
from hivemall_tpu_torch.serving.engine import make_servable, q8_linear_scores

from torch_cases import ATOL, RTOL, carried_models, request_rows

# (rule, table dtype of the trained state, freeze quantize=)
CASES = [("arow", False, None), ("pa1", False, None), ("arow", True, None),
         ("arow", False, "bf16"), ("arow", False, "int8"),
         ("pa1", True, "int8"), ("arow_regr", False, "bf16")]
IDS = [f"{r}-{'bf16' if b else 'f32'}-{q or 'full'}" for r, b, q in CASES]
DIMS = 1024


def _freeze_both(tmp_path, rule, bf16, quantize, block_rows=None):
    jm, tm = carried_models(rule, dims=DIMS, seed=3, bf16=bf16)
    kw = dict(name="ctr", version="4", quantize=quantize,
              quant_block_rows=block_rows)
    p_port, p_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    m_port = freeze(tm, p_port, **kw)
    m_jax = jax_freeze(jm, p_jax, **kw)
    return jm, tm, (p_port, m_port), (p_jax, m_jax)


@pytest.mark.parametrize("rule,bf16,quantize", CASES, ids=IDS)
def test_artifacts_of_one_state_are_equal(tmp_path, rule, bf16, quantize):
    _, _, (p_port, m_port), (p_jax, m_jax) = _freeze_both(
        tmp_path, rule, bf16, quantize)
    strip = ("created_unix", "sha256")
    assert {k: v for k, v in m_port.items() if k not in strip} == \
        {k: v for k, v in m_jax.items() if k not in strip}
    with open(os.path.join(p_port, MANIFEST_FILE)) as f:
        assert json.load(f) == m_port
    a, b = load(p_port).arrays, load(p_jax).arrays
    assert list(a) == list(b)  # same names, same order in the pack
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # and the JAX loader reads the port's pack to the same arrays
    c = jax_load(p_port).arrays
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)


def _scores_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rule,bf16,quantize", CASES, ids=IDS)
def test_jax_freeze_port_serve(tmp_path, rule, bf16, quantize):
    """JAX freeze -> port load -> port engine == JAX engine on the same
    artifact; the table reloads at the manifest dtype."""
    _, _, _, (p_jax, man) = _freeze_both(tmp_path, rule, bf16, quantize)
    rows = request_rows(DIMS)
    want = JEngine(jax_load(p_jax), name="x_jax", max_batch=16,
                   max_width=16).predict(rows)
    eng = ServingEngine(load(p_jax), name="x_port", max_batch=16,
                        max_width=16, device="cpu")
    assert eng.weights_dtype == man["meta"]["weights_dtype"]
    _scores_close(eng.predict(rows), want)


@pytest.mark.parametrize("rule,bf16,quantize", CASES, ids=IDS)
def test_port_freeze_jax_serve(tmp_path, rule, bf16, quantize):
    """port freeze -> JAX load -> JAX engine == port engine on the same
    artifact, and the JAX runtime sees the dtype the port recorded."""
    _, _, (p_port, man), _ = _freeze_both(tmp_path, rule, bf16, quantize)
    rows = request_rows(DIMS, seed=2)
    jeng = JEngine(jax_load(p_port), name="y_jax", max_batch=16,
                   max_width=16)
    assert jeng.weights_dtype == man["meta"]["weights_dtype"]
    eng = ServingEngine(load(p_port), name="y_port", max_batch=16,
                        max_width=16, device="cpu")
    _scores_close(eng.predict(rows), jeng.predict(rows))


@pytest.mark.parametrize("quantize,bytes_per_row", [(None, 4), ("bf16", 2),
                                                    ("int8", 1)])
def test_table_bytes_and_dtype_per_precision(tmp_path, quantize,
                                             bytes_per_row):
    """Resident score-table bytes, counted from tensors: D*4, D*2 and
    D + 4*ceil(D/64) (int8 plus its f32 scales)."""
    _, tm = carried_models("arow", dims=DIMS, seed=5)
    freeze(tm, str(tmp_path / "a"), quantize=quantize)
    sv = make_servable(str(tmp_path / "a"), device="cpu")
    extra = 4 * (DIMS // 64) if quantize == "int8" else 0
    assert sv.table_bytes() == DIMS * bytes_per_row + extra
    want = {None: torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[quantize]
    table = sv.qw if quantize == "int8" else sv.state.weights
    assert table.dtype == want


def test_bf16_trained_state_reloads_at_bf16(tmp_path):
    """A bf16-trained linear model freezes widened (value-exact) with
    weights_dtype "bfloat16", and reloads AT bf16 — never wide."""
    _, tm = carried_models("arow", dims=DIMS, seed=6, bf16=True)
    man = freeze(tm, str(tmp_path / "a"))
    assert man["meta"]["weights_dtype"] == "bfloat16"
    art = load(str(tmp_path / "a"))
    assert art.arrays["weight"].dtype == np.float32
    sv = make_servable(art, device="cpu")
    assert sv.state.weights.dtype == torch.bfloat16
    assert sv.state.covars.dtype == torch.bfloat16
    staged = sv.stage(request_rows(DIMS)[:4], 8, 16)
    assert staged.values.dtype == np.float32  # request payloads stay f32
    jsv = jax_make_servable(jax_load(str(tmp_path / "a")))
    assert jsv.state.weights.dtype == jnp.bfloat16


def test_int8_scores_equal_the_dequantized_table(tmp_path):
    """The dequant-free int8 scorer equals scoring against the numpy
    dequantize_int8 table; a non-default block size (32, dims 100 with a
    tail block) lands in the manifest and folds the right scale."""
    _, tm = carried_models("pa1", dims=100, seed=8)
    man = freeze(tm, str(tmp_path / "q"), quantize="int8",
                 quant_block_rows=32)
    assert manifest_quant(man["meta"])["block_rows"] == 32
    art = load(str(tmp_path / "q"))
    w = dequantize_int8(art.arrays["weight"], art.arrays["weight__scale"],
                        32)
    rows = request_rows(100, n=30)
    eng = ServingEngine(art, name="q32", max_batch=16, max_width=16,
                        device="cpu")
    got = eng.predict(rows)
    from hivemall_tpu_torch.models.base import _stage_rows

    idx, val = _stage_rows(rows, 100)
    want = [float(np.dot(w[i[:16]], v[:16])) for i, v in zip(idx, val)]
    _scores_close(got, want)


def test_q8_pad_lanes_read_zero():
    """Pad lanes (index == D) and out-of-range ids contribute 0 instead of
    raising: the int8 gather is masked by live lanes."""
    qw = torch.tensor([10, -20, 30, 40], dtype=torch.int8)
    scales = torch.tensor([0.5, 2.0])
    idx = torch.tensor([[0, 3, 4, 4], [2, -1, 7, 1]])
    val = torch.tensor([[1.0, 1.0, 5.0, 5.0], [1.0, 3.0, 3.0, 1.0]])
    out = q8_linear_scores(qw, scales, idx, val, block_shift=1)
    np.testing.assert_allclose(out.numpy(), [5.0 + 80.0, 60.0 - 10.0])


def test_quantized_artifacts_refuse_rebuild_and_record_quant(tmp_path):
    _, tm = carried_models("arow", dims=256, seed=2)
    for q, scheme in (("bf16", "bf16"), ("int8", "int8_absmax")):
        man = freeze(tm, str(tmp_path / q), quantize=q)
        quant = manifest_quant(man["meta"])
        assert quant == jax_manifest_quant(
            jax_load(str(tmp_path / q)).meta)
        assert quant["scheme"] == scheme and quant["tables"] == ["weight"]
        assert man["meta"]["use_covariance"] is False
        with pytest.raises(ValueError, match="quantized"):
            rebuild_model(load(str(tmp_path / q)))
    freeze(tm, str(tmp_path / "f"))
    with pytest.raises(ValueError, match="make_servable"):
        rebuild_model(load(str(tmp_path / "f")))


def test_artifacts_are_immutable(tmp_path):
    _, tm = carried_models("pa1", dims=128)
    freeze(tm, str(tmp_path / "v1"))
    with pytest.raises(FileExistsError):
        freeze(tm, str(tmp_path / "v1"))


def test_corrupt_artifact_detected(tmp_path):
    _, tm = carried_models("pa1", dims=128)
    path = str(tmp_path / "v1")
    freeze(tm, path)
    with open(os.path.join(path, ARRAYS_FILE), "ab") as f:
        f.write(b"tamper")
    with pytest.raises(ValueError, match="sha256"):
        load(path)
    load(path, verify=False)  # explicit opt-out still works


def test_quantize_argument_validation(tmp_path):
    _, tm = carried_models("pa1", dims=128)
    with pytest.raises(ValueError, match="bf16.*int8|int8.*bf16"):
        freeze(tm, str(tmp_path / "v1"), quantize="fp4")
    with pytest.raises(ValueError, match="quant_block_rows"):
        freeze(tm, str(tmp_path / "v2"), quant_block_rows=64)
    with pytest.raises(ValueError, match="power of two"):
        freeze(tm, str(tmp_path / "v3"), quantize="int8",
               quant_block_rows=48)


def test_later_slices_raise_by_name(tmp_path):
    _, tm = carried_models("pa1", dims=128)
    # the retrieval index landed with MF; a linear model has no catalog
    with pytest.raises(ValueError, match="has no retrieval path"):
        freeze(tm, str(tmp_path / "r"), retrieval_index={})

    # the tree families landed: the port's own models freeze and emit rows
    from hivemall_tpu_torch.models.trees import forest as TF

    X = np.random.RandomState(0).rand(60, 3)
    y = (X[:, 0] > 0.5).astype(int)
    for family, model in (
            ("forest", TF.train_randomforest_classifier(
                X, y, "-trees 2 -seed 1", device="cpu")),
            ("gbt", TF.train_gradient_tree_boosting_classifier(
                X, y, "-trees 2 -seed 1", device="cpu"))):
        man = freeze(model, str(tmp_path / family))
        assert man["family"] == family
        assert man["meta"]["columns"][:2] in (["model_id", "model_type"],
                                              ["iter", "cls"])

    class Forest:  # the JAX package's TrainedForest fields, not the class
        trees = []
        classification = True

    class GBT:  # ... and TrainedGBT's
        trees = []
        shrinkage = 0.1

    with pytest.raises(ValueError, match="no serving family"):
        freeze(Forest(), str(tmp_path / "forest_stand_in"))
    with pytest.raises(ValueError, match="no serving family"):
        freeze(GBT(), str(tmp_path / "gbt_stand_in"))
    # sharded and replicated placements landed: over CPU devices they
    # serve the single-device scores
    from hivemall_tpu_torch.serving import ModelSharded, Replicated

    rows = [[f"{i % 13}:1.0", f"{(i * 7) % 13}:0.5"] for i in range(16)]
    want = make_servable(tm).run_padded(rows, 16, 8).numpy()
    cpu = [torch.device("cpu")] * 4
    for placement in (ModelSharded(2, devices=cpu), Replicated(
            devices=cpu)):
        got = make_servable(tm, placement=placement).run_padded(rows, 16, 8)
        np.testing.assert_array_equal(got.numpy(), want)


def test_artifact_serving_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    _, tm = carried_models("pa1", dims=128)
    freeze(tm, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_servable(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(load(str(tmp_path / "a")), name="nocuda")
    # a trained port model serves on its own device (here the CPU)
    assert make_servable(tm).device == torch.device("cpu")
