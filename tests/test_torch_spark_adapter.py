"""The port's pyspark DSL glue (hivemall_tpu_torch/adapters/spark.py)
against the JAX package's (hivemall_tpu/adapters/spark.py): every case of
tests/test_spark_adapter.py run through both on the same seeded
partitions, with that file's fake of pyspark's mapInPandas /
groupBy().applyInPandas contract (which checks each frame's columns
against the declared DDL schema). Model rows: features exact, floats at
the reference's rtol 2e-5 / atol 1e-6; the schema of every registry
trainer equal to the JAX package's; the functions handed to mapInPandas
carry the device as a string or None and no tensor, model or
torch.device. The port trains with device="cpu" here; without a device
it raises where there is no CUDA device."""

import types
import warnings

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

from hivemall_tpu.adapters import spark as jsp
from hivemall_tpu.ensemble import argmin_kld as jargmin_kld
from hivemall_tpu_torch.adapters import spark as tsp
from hivemall_tpu_torch.adapters.spark import (SparkHivemallOps,
                                               lr_datagen_spark,
                                               model_row_schema,
                                               predict_stream_spark,
                                               spark_hivemall_ops)
from hivemall_tpu_torch.ensemble import argmin_kld
from hivemall_tpu_torch.sql import list_functions

# the fake of pyspark's partitions that drives the JAX adapter's tests
from test_spark_adapter import FakeSparkDataFrame, _ddl_names, \
    _two_partition_df

RTOL, ATOL = 2e-5, 1e-6


def _ops(df, **kw):
    return jsp.spark_hivemall_ops(df, **kw), \
        spark_hivemall_ops(df, device="cpu", **kw)


def _cell_close(a, b, where):
    if isinstance(a, (list, tuple, np.ndarray)) or \
            isinstance(b, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=where)
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None or np.isnan(a) or np.isnan(b):
            assert (a is None or np.isnan(a)) and \
                (b is None or np.isnan(b)), (where, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=where)
    else:
        assert a == b, (where, a, b)


def _assert_partitions_match(got, want):
    """Partition for partition: the same columns and dtypes, integer and
    text cells exact, float and list cells at rtol 2e-5 / atol 1e-6."""
    assert len(got.partitions) == len(want.partitions)
    for p, (g, w) in enumerate(zip(got.partitions, want.partitions)):
        assert list(g.columns) == list(w.columns), p
        assert list(g.dtypes) == list(w.dtypes), (p, g.dtypes, w.dtypes)
        assert len(g) == len(w), (p, len(g), len(w))
        for c in g.columns:
            for i, (a, b) in enumerate(zip(g[c].tolist(), w[c].tolist())):
                _cell_close(a, b, f"partition {p} {c}[{i}]")


# ---- the cases of tests/test_spark_adapter.py ----

def test_train_arow_one_model_per_partition():
    sj, st = _ops(_two_partition_df())
    rows = st.train_arow("features", "label", "-dims 64")
    # each partition emitted its own (feature, weight, covar) model
    assert len(rows.partitions) == 2
    for p in rows.partitions:
        assert list(p.columns) == ["feature", "weight", "covar"]
        assert len(p) > 0 and p["covar"].notna().all()
    _assert_partitions_match(rows, sj.train_arow("features", "label",
                                                 "-dims 64"))


def test_argmin_kld_merge_matches_direct():
    sj, st = _ops(_two_partition_df())
    rows = st.train_arow("features", "label", "-dims 64")
    merged = spark_hivemall_ops(rows).groupby("feature").argmin_kld(
        "weight", "covar", key_type="bigint").toPandas()
    # parity vs the ensemble op applied by hand across the partitions
    whole = rows.toPandas()
    for feat, grp in whole.groupby("feature"):
        want = argmin_kld(list(zip(grp["weight"], grp["covar"])))
        got = float(merged.loc[merged["feature"] == feat, "value"].iloc[0])
        assert abs(got - want) < 1e-9
    # and features trained in both partitions really merged two entries
    assert (whole.groupby("feature").size() > 1).any()
    jrows = sj.train_arow("features", "label", "-dims 64")
    jmerged = jsp.spark_hivemall_ops(jrows).groupby("feature").argmin_kld(
        "weight", "covar", key_type="bigint").toPandas()
    pd.testing.assert_frame_equal(merged, jmerged, rtol=RTOL, atol=ATOL)
    for feat, grp in jrows.toPandas().groupby("feature"):
        assert jargmin_kld(list(zip(grp["weight"], grp["covar"]))) == \
            pytest.approx(float(merged.loc[merged["feature"] == feat,
                                           "value"].iloc[0]), rel=RTOL,
                          abs=ATOL)


def test_train_fm_schema_and_bias_row():
    sj, st = _ops(_two_partition_df(seed=3))
    opts = "-dims 64 -classification -factors 3 -iters 1"
    rows = st.train_fm("features", "label", opts)
    p = rows.partitions[0]
    assert list(p.columns) == _ddl_names(model_row_schema("train_fm"))
    bias = p[p["feature"] == -1]
    assert len(bias) == 1 and bias["Vif"].iloc[0] is None
    body = p[p["feature"] >= 0]
    assert all(len(v) == 3 for v in body["Vif"])
    _assert_partitions_match(rows, sj.train_fm("features", "label", opts))


def test_train_multiclass_label_column():
    rng = np.random.RandomState(5)
    rows, labels = [], []
    for _ in range(150):
        c = rng.randint(0, 3)
        rows.append([f"{c * 4 + j}:1" for j in range(3)])
        labels.append(f"class{c}")
    df = FakeSparkDataFrame([pd.DataFrame({"features": rows,
                                           "label": labels})])
    sj, st = _ops(df)
    out = st.train_multiclass_arow("features", "label", "-dims 64")
    p = out.partitions[0]
    assert list(p.columns) == ["label", "feature", "weight", "covar"]
    assert set(p["label"]) == {"class0", "class1", "class2"}
    _assert_partitions_match(out, sj.train_multiclass_arow(
        "features", "label", "-dims 64"))


def test_forest_trainer_and_mix_fallback():
    # RF takes dense array<double> features like the reference UDTF
    rng = np.random.RandomState(7)
    rows = [[rng.rand(), rng.rand()] for _ in range(80)]
    labels = [float(rng.randint(0, 2)) for _ in range(80)]
    df = FakeSparkDataFrame([pd.DataFrame({"features": rows,
                                           "label": labels})])
    sj, st = _ops(df, mix_servs="host1:11212")
    with pytest.warns(UserWarning, match="does not accept -mix"):
        out = st.train_randomforest_classifier(
            "features", "label", "-trees 3 -seed 1")
    p = out.partitions[0]
    assert list(p.columns) == _ddl_names(
        model_row_schema("train_randomforest_classifier"))
    assert len(p) == 3 and all(isinstance(t, str) for t in p["pred_model"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # forest takes no -mix, falls back
        want = sj.train_randomforest_classifier("features", "label",
                                                "-trees 3 -seed 1")
    _assert_partitions_match(out, want)


def test_amplify_preserves_schema_per_partition():
    df = _two_partition_df()
    sj, st = _ops(df)
    out = st.amplify(3).df
    for before, after in zip(df.partitions, out.partitions):
        assert len(after) == 3 * len(before)
        assert list(after.columns) == list(before.columns)
    for g, w in zip(out.partitions, sj.amplify(3).df.partitions):
        pd.testing.assert_frame_equal(g, w)


def test_each_top_k_declared_schema():
    df = FakeSparkDataFrame([pd.DataFrame({
        "g": ["a", "a", "a", "b", "b"],
        "v": [3.0, 1.0, 2.0, 9.0, 8.0],
    })])
    sj, st = _ops(df)
    schema = "rank int, value double, g string, v double"
    out = st.each_top_k(2, "g", "v", schema=schema).df
    p = out.partitions[0]
    assert list(p.columns) == ["rank", "value", "g", "v"]
    assert len(p) == 4  # top-2 per group
    assert p[p["g"] == "a"]["v"].tolist() == [3.0, 2.0]
    pd.testing.assert_frame_equal(
        p, sj.each_top_k(2, "g", "v", schema=schema).df.partitions[0])


@pytest.mark.parametrize("trainer", ["train_mf_sgd", "train_mf_adagrad",
                                     "train_bprmf"])
def test_mf_trainer_refused(trainer):
    sj, st = _ops(_two_partition_df())
    with pytest.raises(NotImplementedError):
        getattr(st, trainer)("features", "label")
    with pytest.raises(NotImplementedError):
        getattr(sj, trainer)("features", "label")


def test_lr_datagen_and_predict_stream():
    class FakeSession:
        def createDataFrame(self, pdf):
            return FakeSparkDataFrame([pdf])

    opts = "-n_examples 50 -n_features 5"
    df = lr_datagen_spark(FakeSession(), opts)
    pdf = df.toPandas()
    assert set(pdf.columns) == {"features", "label"} and len(pdf) == 50
    pd.testing.assert_frame_equal(
        pdf, jsp.lr_datagen_spark(FakeSession(), opts).toPandas())

    from hivemall_tpu.models.classifier import train_arow as jtrain
    from hivemall_tpu_torch.models.classifier import train_arow

    feats = pdf["features"].tolist()
    labels = np.where(pdf["label"].to_numpy() > 0, 1, -1)
    model = train_arow(feats, labels, "-dims 1024", device="cpu")
    scores = list(predict_stream_spark(model, [df]))  # toPandas path
    assert len(scores) == 1 and scores[0].shape == (50,)
    want = list(jsp.predict_stream_spark(jtrain(feats, labels, "-dims 1024"),
                                         [pdf]))  # pandas path
    np.testing.assert_allclose(scores[0], np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)


def test_empty_partitions_emit_nothing():
    df = _two_partition_df()
    df.partitions.append(pd.DataFrame({"features": [], "label": []}))
    sj, st = _ops(df)
    rows = st.train_arow("features", "label", "-dims 64")
    assert len(rows.partitions[2]) == 0  # empty partition -> no model rows
    out = st.amplify(2).df
    assert len(out.partitions[2]) == 0
    _assert_partitions_match(rows, sj.train_arow("features", "label",
                                                 "-dims 64"))


def test_grouped_value_coercion_for_spark_types():
    import json

    votes = pd.DataFrame({"g": ["a"] * 3 + ["b"] * 2,
                          "vote": [1, 1, 0, 2, 2],
                          "label": [10, 10, 20, 30, 30],
                          "score": [0.5, 0.6, 0.9, 0.1, 0.2]})
    df = FakeSparkDataFrame([votes])
    sj, st = _ops(df)
    rf = st.groupby("g").rf_ensemble("vote", key_type="string").toPandas()
    a = json.loads(rf.loc[rf["g"] == "a", "value"].iloc[0])
    assert a["label"] == 1 and abs(a["probability"] - 2 / 3) < 1e-9
    ml = st.groupby("g").max_label("score", "label",
                                   key_type="string").toPandas()
    assert all(isinstance(v, str) for v in ml["value"])  # declared string
    pd.testing.assert_frame_equal(
        rf, sj.groupby("g").rf_ensemble("vote", key_type="string").toPandas())
    pd.testing.assert_frame_equal(
        ml, sj.groupby("g").max_label("score", "label",
                                      key_type="string").toPandas())


def test_unknown_trainer_fails_on_driver():
    sj, st = _ops(_two_partition_df())
    with pytest.raises(KeyError):  # eager registry lookup, no job launch
        st.train_adagrad  # typo of train_adagrad_rda
    with pytest.raises(KeyError):
        sj.train_adagrad
    with pytest.raises(AttributeError):
        st.not_a_trainer


# ---- beyond the JAX suite ----

@pytest.mark.parametrize("trainer", [n for n in list_functions()
                                     if n.startswith("train_")])
def test_model_row_schema_equals_the_jax_packages(trainer):
    assert model_row_schema(trainer) == jsp.model_row_schema(trainer)


GROUPED = (("voted_avg", ("weight",), "value"),
           ("weight_voted_avg", ("weight",), "value"),
           ("argmin_kld", ("weight", "covar"), "value"),
           ("mae", ("weight", "covar"), "mae"),
           ("mse", ("weight", "covar"), "mse"),
           ("rmse", ("weight", "covar"), "rmse"))


@pytest.mark.parametrize("op,cols,name", GROUPED,
                         ids=[g[0] for g in GROUPED])
def test_grouped_aggregates_equal_the_jax_packages(op, cols, name):
    sj, st = _ops(_two_partition_df(seed=4))
    rows = st.train_arow("features", "label", "-dims 64")
    got = getattr(spark_hivemall_ops(rows).groupby("feature"), op)(
        *cols, key_type="bigint").toPandas()
    want = getattr(jsp.spark_hivemall_ops(rows).groupby("feature"), op)(
        *cols, key_type="bigint").toPandas()
    assert list(got.columns) == ["feature", name]
    pd.testing.assert_frame_equal(got, want, rtol=RTOL, atol=ATOL)


def test_f1score_grouped_equals_the_jax_packages():
    frame = pd.DataFrame({"g": ["a", "a", "b"],
                          "truth": [[1, 2], [3], [4, 5]],
                          "pred": [[1], [3, 4], [5]]})
    sj, st = _ops(FakeSparkDataFrame([frame]))
    got = st.groupby("g").f1score("truth", "pred",
                                  key_type="string").toPandas()
    pd.testing.assert_frame_equal(
        got, sj.groupby("g").f1score("truth", "pred",
                                     key_type="string").toPandas())


def test_rand_amplify_and_part_amplify_equal_the_jax_partitions():
    df = _two_partition_df(n=30)
    sj, st = _ops(df)
    for name, args in (("rand_amplify", (3, 2, 5)), ("part_amplify", (2,))):
        got = getattr(st, name)(*args).df
        want = getattr(sj, name)(*args).df
        for g, w in zip(got.partitions, want.partitions):
            pd.testing.assert_frame_equal(g, w)


class _RecordingFrame(FakeSparkDataFrame):
    """Keeps every function handed to mapInPandas."""

    handed = []

    def mapInPandas(self, fn, schema):
        self.handed.append(fn)
        return super().mapInPandas(fn, schema)


def _closure_values(fn, seen=None):
    """Every value a function's closure reaches, through nested functions."""
    seen = set() if seen is None else seen
    if id(fn) in seen:
        return []
    seen.add(id(fn))
    out = []
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        out.append(v)
        if isinstance(v, types.FunctionType):
            out += _closure_values(v, seen)
    return out


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_executor_closures_carry_the_device_as_a_string(device):
    from hivemall_tpu_torch.models.base import TrainedLinearModel

    _RecordingFrame.handed = []
    df = _RecordingFrame(_two_partition_df().partitions)
    ops = spark_hivemall_ops(df, device=device).set_mix_servs("h:1")
    ops.train_arow("features", "label", "-dims 64")
    ops.amplify(2)
    assert len(_RecordingFrame.handed) == 2
    for fn in _RecordingFrame.handed:
        values = _closure_values(fn)
        assert "cpu" in values
        for v in values:
            assert not isinstance(v, (torch.Tensor, torch.device,
                                      torch.nn.Module, TrainedLinearModel,
                                      SparkHivemallOps)), (fn, v)
    out = ops.amplify(2)
    assert isinstance(out, SparkHivemallOps)
    assert out._device == "cpu" and out._mix_servs == "h:1"


def test_spark_trainers_without_a_device_and_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    df = _two_partition_df()
    for ops in (spark_hivemall_ops(df), SparkHivemallOps(df, mix_servs="h"),
                spark_hivemall_ops(df).amplify(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.train_arow("features", "label", "-dims 64")
    assert tsp.spark_hivemall_ops(df)._device is None
