"""The port's Arrow bridge (hivemall_tpu_torch/adapters/arrow.py) against
the JAX package's (hivemall_tpu/adapters/arrow.py): every case of
tests/test_arrow_adapter.py run through both on the same seeded tables.
Model rows: features exact, floats at the reference's rtol 2e-5 / atol
1e-6; the model table's schema equal; an IPC file written by either
package reads back in the other. The port trains with device="cpu" here;
without a device it raises where there is no CUDA device."""

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")

from hivemall_tpu import adapters as jad
from hivemall_tpu.adapters import arrow as jarrow
from hivemall_tpu_torch import adapters as tad
from hivemall_tpu_torch.adapters import arrow as tarrow
from torch_cases import assert_model_rows_match

RTOL, ATOL = 2e-5, 1e-6


def _make_table(n=600, d=64, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d)
    feats, labels = [], []
    for _ in range(n):
        f = rng.choice(d, size=6, replace=False)
        v = rng.rand(6).round(3)
        feats.append([f"{i}:{x}" for i, x in zip(f, v)])
        labels.append(float(np.sign(np.dot(w_true[f], v))) or 1.0)
    return pa.table({"features": feats, "label": labels}), w_true


def _train_both(table, trainer="train_arow", opts="-dims 64"):
    mj = getattr(jad.arrow_ops(table), trainer)("features", "label", opts)
    mt = getattr(tad.arrow_ops(table, device="cpu"), trainer)(
        "features", "label", opts)
    return mj, mt


def _assert_tables_match(got, want):
    assert got.schema == want.schema, (got.schema, want.schema)
    np.testing.assert_array_equal(got.column("feature").to_numpy(),
                                  want.column("feature").to_numpy())
    for name in got.column_names[1:]:
        np.testing.assert_allclose(got.column(name).to_numpy(),
                                   want.column(name).to_numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_train_from_arrow_table():
    table, _ = _make_table()
    mj, mt = _train_both(table)
    assert mt.state.weights.device == torch.device("cpu")
    assert_model_rows_match(mt, mj)
    feats = table.column("features").to_pylist()
    y = np.asarray(table.column("label").to_numpy())
    acc = float(np.mean(np.sign(mt.predict(feats)) == y))
    assert acc > 0.9, acc
    np.testing.assert_allclose(mt.predict(feats),
                               np.asarray(mj.predict(feats)),
                               rtol=RTOL, atol=ATOL)


def test_model_arrow_round_trip(tmp_path):
    table, _ = _make_table(seed=1)
    mj, mt = _train_both(table)

    t, tj = tad.model_to_arrow(mt), jad.model_to_arrow(mj)
    assert t.column_names == ["feature", "weight", "covar"]  # AROW has covar
    assert t.num_rows > 0
    _assert_tables_match(t, tj)

    w, cov = tad.model_from_arrow(t, dims=64)
    state_w = mt.state.weights.numpy()
    np.testing.assert_allclose(w, np.where(
        mt.state.touched.numpy() != 0, state_w, 0.0), rtol=1e-6)
    assert cov is not None
    wj, covj = jad.model_from_arrow(t, dims=64)
    np.testing.assert_array_equal(w, wj)
    np.testing.assert_array_equal(cov, covj)

    path = str(tmp_path / "model.arrow")
    tad.write_model_ipc(mt, path)
    w2, cov2 = tad.read_model_ipc(path, dims=64)
    np.testing.assert_array_equal(w2, w)
    np.testing.assert_array_equal(cov2, cov)


def test_warm_start_from_arrow_model(tmp_path):
    """The -loadmodel analog: a model table read back from IPC seeds a new
    state, and one AROW step from it equals the JAX package's step from
    the same arrays."""
    from hivemall_tpu.core.engine import make_train_step as jstep
    from hivemall_tpu.core.state import init_linear_state as jinit
    from hivemall_tpu.models.classifier import AROW as JAROW
    from hivemall_tpu_torch.core.engine import make_train_step as tstep
    from hivemall_tpu_torch.core.state import init_linear_state as tinit
    from hivemall_tpu_torch.models.classifier import AROW as TAROW

    table, _ = _make_table(seed=2)
    _, mt = _train_both(table)
    path = str(tmp_path / "m.arrow")
    tad.write_model_ipc(mt, path)
    w, cov = tad.read_model_ipc(path, dims=64)

    state = tinit(64, use_covariance=True, initial_weights=w,
                  initial_covars=cov, device="cpu")
    # the warm start actually took: the seeded state IS the loaded model
    np.testing.assert_array_equal(state.weights.numpy(), w)
    np.testing.assert_array_equal(state.covars.numpy(), cov)
    idx = np.array([[1, 2, 3, 0, 0, 0]], np.int32)
    val = np.array([[1.0, 0.5, 0.2, 0, 0, 0]], np.float32)
    y = np.array([1.0], np.float32)
    out, loss = tstep(TAROW, {"r": 0.1}, device="cpu")(
        state, torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(y))
    assert np.isfinite(float(loss))
    jstate = jinit(64, use_covariance=True, initial_weights=w,
                   initial_covars=cov)
    jout, jloss = jstep(JAROW, {"r": 0.1}, donate=False)(jstate, idx, val, y)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for k in ("weights", "covars"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(jout, k)), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_streaming_predict_over_batches():
    table, _ = _make_table(seed=3)
    mj, mt = _train_both(table)
    batches = table.to_batches(max_chunksize=128)
    outs = list(tad.predict_batches(mt, batches))
    assert sum(len(o) for o in outs) == table.num_rows
    assert all(isinstance(o, np.ndarray) for o in outs)
    whole = np.asarray(mt.predict(table.column("features").to_pylist()))
    np.testing.assert_allclose(np.concatenate(outs), whole, rtol=1e-5)
    want = list(jad.predict_batches(mj, batches))
    assert [len(o) for o in outs] == [len(o) for o in want]
    np.testing.assert_allclose(np.concatenate(outs), np.concatenate(want),
                               rtol=RTOL, atol=ATOL)


def test_registry_trainers_reachable():
    table, _ = _make_table(seed=4)
    ops = tad.arrow_ops(table, device="cpu")
    m1 = ops.train_perceptron("features", "label", "-dims 64")
    m2 = ops.train_scw("features", "label", "-dims 64")
    assert m1.state.weights.shape == (64,)
    assert m2.state.covars is not None
    with pytest.raises(AttributeError):
        ops.not_a_trainer
    jops = jad.arrow_ops(table)
    assert_model_rows_match(m1, jops.train_perceptron("features", "label",
                                                      "-dims 64"))
    assert_model_rows_match(m2, jops.train_scw("features", "label",
                                               "-dims 64"))
    # a weight-only model's table has no covar column, in both packages
    _assert_tables_match(tad.model_to_arrow(m1), jad.model_to_arrow(
        jops.train_perceptron("features", "label", "-dims 64")))
    assert tad.model_to_arrow(m1).column_names == ["feature", "weight"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ipc_cross_load(tmp_path, writer):
    """An IPC model file written by either package reads back in the other
    to the same arrays, and the files hold equal tables."""
    table, _ = _make_table(seed=5)
    mj, mt = _train_both(table)
    path = str(tmp_path / f"{writer}.arrow")
    if writer == "jax":
        jad.write_model_ipc(mj, path)
        src = jad.model_to_arrow(mj)
    else:
        tad.write_model_ipc(mt, path)
        src = tad.model_to_arrow(mt)
    got = tad.read_model_ipc(path, dims=64)
    want = jad.read_model_ipc(path, dims=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    w_src, cov_src = tad.model_from_arrow(src, dims=64)
    np.testing.assert_array_equal(got[0], w_src)
    np.testing.assert_array_equal(got[1], cov_src)


def test_model_from_arrow_refuses_a_smaller_dims():
    table, _ = _make_table(seed=6)
    mj, mt = _train_both(table)
    t = tad.model_to_arrow(mt)
    with pytest.raises(ValueError, match="outside"):
        tad.model_from_arrow(t, dims=8)
    with pytest.raises(ValueError, match="outside"):
        jad.model_from_arrow(t, dims=8)


def test_table_helpers_on_record_batches():
    table, _ = _make_table(n=40, seed=7)
    batch = table.to_batches()[0]
    for src in (table, batch):
        assert tarrow.table_features(src, "features") == \
            jarrow.table_features(src, "features")
        got = tarrow.table_labels(src, "label")
        np.testing.assert_array_equal(got, jarrow.table_labels(src, "label"))
        assert got.dtype == jarrow.table_labels(src, "label").dtype


def test_arrow_ops_without_a_device_and_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    table, _ = _make_table(n=20, seed=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tad.arrow_ops(table).train_arow("features", "label", "-dims 64")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tad.arrow_ops(table).train_arow("features", "label")


def test_importing_the_adapters_loads_no_torch_pandas_or_pyarrow():
    """`hivemall_tpu_torch.adapters` re-exports the frame adapters, whose
    optional engines load at first use; the registry and torch load at the
    first trainer lookup, so the TRANSFORM bridge's predict process (which
    imports adapters.hive_transform) stays free of torch."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "import hivemall_tpu_torch.adapters\n"
            "import hivemall_tpu_torch.adapters.hive_transform\n"
            "import hivemall_tpu_torch.adapters.spark\n"
            "print(sorted(m for m in ('torch', 'pandas', 'pyarrow') "
            "if m in sys.modules))\n")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
