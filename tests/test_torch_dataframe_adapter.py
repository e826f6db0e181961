"""The port's DataFrame DSL (hivemall_tpu_torch/adapters/dataframe.py)
against the JAX package's (hivemall_tpu/adapters/dataframe.py): the
TestAdapters cases of tests/test_runtime_adapters.py run through both on
the same seeded frames, then every row transform and grouped aggregate.
Model rows: features exact, floats at the reference's rtol 2e-5 / atol
1e-6; transformed and aggregated frames: pd.testing.assert_frame_equal
against the JAX adapter's. The port trains with device="cpu" here;
without a device it raises where there is no CUDA device."""

import warnings

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

from hivemall_tpu import adapters as jad
from hivemall_tpu.adapters import dataframe as jdf
from hivemall_tpu_torch import adapters as tad
from hivemall_tpu_torch.adapters import dataframe as tdf
from torch_cases import assert_model_rows_match

RTOL, ATOL = 2e-5, 1e-6


def _df():
    rng = np.random.RandomState(0)
    n, d = 200, 8
    w = rng.randn(d)
    X = rng.randn(n, d).astype(np.float32)
    y = np.sign(X @ w)
    feats = [[f"{i}:{X[r, i]}" for i in range(d)] for r in range(n)]
    return pd.DataFrame({"features": feats, "label": y})


def _ops(df):
    return jad.hivemall_ops(df), tad.hivemall_ops(df, device="cpu")


def _assert_frames_equal(got, want):
    assert isinstance(got, tdf.HivemallFrame) == isinstance(
        want, jdf.HivemallFrame)
    if isinstance(got, tdf.HivemallFrame):
        got, want = got.df, want.df
    pd.testing.assert_frame_equal(got, want, rtol=RTOL, atol=ATOL)


# ---- the TestAdapters cases of tests/test_runtime_adapters.py ----

def test_train_via_dataframe():
    hj, ht = _ops(_df())
    mt = ht.train_arow("features", "label", "-dims 64")
    mj = hj.train_arow("features", "label", "-dims 64")
    assert_model_rows_match(mt, mj)
    scores = mt.predict(_df()["features"].tolist())
    acc = np.mean(np.sign(scores) == _df()["label"].to_numpy())
    assert acc > 0.9


def test_amplify():
    hj, ht = _ops(_df())
    assert len(ht.amplify(3).df) == 600
    _assert_frames_equal(ht.amplify(3), hj.amplify(3))


def test_grouped_argmin_kld():
    df = pd.DataFrame({"feature": ["a", "a", "b"],
                       "weight": [1.0, 3.0, 5.0],
                       "covar": [0.01, 1.0, 1.0]})
    hj, ht = _ops(df)
    out = ht.groupby("feature").argmin_kld("weight", "covar")
    a_val = float(out[out["feature"] == "a"]["value"].iloc[0])
    assert a_val == pytest.approx((1 / 0.01 + 3) / (1 / 0.01 + 1))
    _assert_frames_equal(out, hj.groupby("feature").argmin_kld("weight",
                                                               "covar"))


def test_predict_stream():
    df = _df()
    hj, ht = _ops(df)
    mt = ht.train_perceptron("features", "label", "-dims 64")
    mj = hj.train_perceptron("features", "label", "-dims 64")
    batches = [df.iloc[:50], df.iloc[50:100]]
    outs = list(tdf.predict_stream(mt, batches))
    assert len(outs) == 2 and len(outs[0]) == 50
    for got, want in zip(outs, jdf.predict_stream(mj, batches)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_part_amplify_and_explode_array():
    hj, ht = _ops(_df())
    assert len(ht.part_amplify(2).df) == 400
    _assert_frames_equal(ht.part_amplify(2), hj.part_amplify(2))
    df = pd.DataFrame({"id": [1, 2, 3, 4],
                       "arr": [[10, 20], [30], [], None]})
    hj, ht = _ops(df)
    out = ht.explode_array("arr")
    assert out.df["arr"].tolist() == [10, 20, 30]
    _assert_frames_equal(out, hj.explode_array("arr"))


def test_minhash_dsl():
    from hivemall_tpu_torch.knn import minhashes

    df = pd.DataFrame({"item": [7, 9],
                       "features": [["a:1", "b:1"], ["b:1", "c:2"]]})
    hj, ht = _ops(df)
    out = ht.minhash("item", "features")
    assert out.df["item"].tolist() == [7] * 5 + [9] * 5
    assert out.df["clusterid"].tolist()[:5] == minhashes(["a:1", "b:1"])
    _assert_frames_equal(out, hj.minhash("item", "features"))
    _assert_frames_equal(ht.minhash("item", "features", 3, 1),
                         hj.minhash("item", "features", 3, 1))


def test_quantify_dsl():
    df = pd.DataFrame({"color": ["red", "blue", "red"], "n": [3, 1, 2],
                       "size": ["s", "m", "s"]})
    hj, ht = _ops(df)
    out = ht.quantify("color", "n")
    assert out.df["color"].tolist() == [0.0, 1.0, 0.0]  # first-seen ids
    assert out.df["n"].tolist() == [3.0, 1.0, 2.0]  # numerics pass through
    _assert_frames_equal(out, hj.quantify("color", "n"))
    _assert_frames_equal(ht.quantify(), hj.quantify())


def test_binarize_label_dsl():
    df = pd.DataFrame({"pos": [2, 0], "neg": [1, 1],
                       "features": [["a:1"], ["b:1"]]})
    hj, ht = _ops(df)
    out = ht.binarize_label("pos", "neg", "features")
    assert out.df["label"].tolist() == [1, 1, 0, 0]
    assert out.df["features"].iloc[3] == ["b:1"]
    _assert_frames_equal(out, hj.binarize_label("pos", "neg", "features"))


def test_lr_datagen_frame_and_set_mix_servs():
    opts = "-n_examples 120 -n_features 5 -n_dims 32 -cl"
    df = tdf.lr_datagen_frame(opts)
    assert len(df) == 120 and set(df["label"]) <= {0.0, 1.0}
    pd.testing.assert_frame_equal(df, jdf.lr_datagen_frame(opts))
    # -mix injection must parse cleanly through every trainer's options
    hf = tad.hivemall_ops(df, device="cpu").set_mix_servs("host1,host2")
    mt = hf.train_perceptron("features", "label", "-dims 32")
    assert mt.predict(df["features"].tolist()).shape == (120,)
    mj = jad.hivemall_ops(df).set_mix_servs("host1,host2").train_perceptron(
        "features", "label", "-dims 32")
    assert_model_rows_match(mt, mj)


# ---- beyond the JAX suite: the remaining transforms and aggregates ----

def test_rand_amplify_equals_the_jax_frames():
    df = _df().iloc[:30].reset_index(drop=True)
    hj, ht = _ops(df)
    for args in ((3,), (2, 4, 7)):
        out = ht.rand_amplify(*args)
        assert len(out.df) == args[0] * len(df)
        _assert_frames_equal(out, hj.rand_amplify(*args))


def test_each_top_k_equals_the_jax_frame():
    df = pd.DataFrame({"g": ["b", "a", "a", "b", "a", "c"],
                       "v": [9.0, 3.0, 1.0, 8.0, 2.0, 5.0],
                       "id": [0, 1, 2, 3, 4, 5]})
    hj, ht = _ops(df)
    for k in (2, -1):
        out = ht.each_top_k(k, "g", "v")
        assert list(out.df.columns) == ["rank", "value", "g", "v", "id"]
        _assert_frames_equal(out, hj.each_top_k(k, "g", "v"))


GROUPED = {
    "voted_avg": ("voted_avg", ("score",)),
    "weight_voted_avg": ("weight_voted_avg", ("score",)),
    "argmin_kld": ("argmin_kld", ("score", "covar")),
    "max_label": ("max_label", ("score", "label")),
    "rf_ensemble": ("rf_ensemble", ("vote",)),
    "maxrow": ("maxrow", ("score",)),
    "mae": ("mae", ("score", "actual")),
    "mse": ("mse", ("score", "actual")),
    "rmse": ("rmse", ("score", "actual")),
    "f1score": ("f1score", ("truth", "pred")),
}


def _grouped_frame(seed=3):
    rng = np.random.RandomState(seed)
    n = 60
    return pd.DataFrame({
        "g": rng.choice(["a", "b", "c"], n),
        "score": rng.randn(n),
        "covar": rng.rand(n) + 0.1,
        "label": rng.randint(0, 4, n),
        "vote": rng.randint(0, 3, n),
        "actual": rng.randn(n),
        "truth": [list(rng.choice(5, 2, replace=False)) for _ in range(n)],
        "pred": [list(rng.choice(5, 3, replace=False)) for _ in range(n)],
    })


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_grouped_aggregate_equals_the_jax_frame(case):
    op, cols = GROUPED[case]
    hj, ht = _ops(_grouped_frame())
    got = getattr(ht.groupby("g"), op)(*cols)
    want = getattr(hj.groupby("g"), op)(*cols)
    assert len(got) == 3
    if op == "rf_ensemble":  # (label, probability, probabilities) tuples
        assert got["g"].tolist() == want["g"].tolist()
        for a, b in zip(got["value"], want["value"]):
            assert a[0] == b[0]
            np.testing.assert_allclose(a[1], b[1], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a[2], b[2], rtol=RTOL, atol=ATOL)
    else:
        _assert_frames_equal(got, want)


def test_transforms_and_mix_keep_the_device_and_mix_servers():
    hf = tad.hivemall_ops(_df(), device="cpu")
    mixed = hf.set_mix_servs("host1:11212")
    for out in (hf.amplify(2), mixed, mixed.amplify(2),
                mixed.rand_amplify(2), mixed.part_amplify(2),
                mixed.quantify("label")):
        assert out._device == "cpu"
    assert mixed.amplify(2)._mix_servs == "host1:11212"
    m = mixed.amplify(2).train_arow("features", "label", "-dims 64")
    assert m.state.weights.device == torch.device("cpu")


def test_forest_refuses_mix_with_a_warning_as_in_jax():
    rng = np.random.RandomState(7)
    df = pd.DataFrame({"features": [[rng.rand(), rng.rand()]
                                    for _ in range(80)],
                       "label": [float(rng.randint(0, 2)) for _ in range(80)]})
    ht = tad.hivemall_ops(df, device="cpu").set_mix_servs("host1")
    with pytest.warns(UserWarning, match="does not accept -mix"):
        mt = ht.train_randomforest_classifier("features", "label",
                                              "-trees 2 -seed 1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mj = jad.hivemall_ops(df).set_mix_servs(
            "host1").train_randomforest_classifier("features", "label",
                                                   "-trees 2 -seed 1")
    assert [r[2] for r in mt.model_rows()] == [r[2] for r in mj.model_rows()]


def test_unknown_option_is_not_swallowed_by_the_mix_catch():
    from hivemall_tpu_torch.utils.options import OptionError

    ht = tad.hivemall_ops(_df(), device="cpu").set_mix_servs("host1")
    with pytest.raises(OptionError, match="-nope"):
        ht.train_arow("features", "label", "-dims 64 -nope")


def test_frame_trainers_without_a_device_and_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    df = _df()
    for hf in (tad.hivemall_ops(df), tad.HivemallFrame(df),
               tad.hivemall_ops(df).amplify(2),
               tad.HivemallFrame(df, mix_servs="host1")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hf.train_arow("features", "label", "-dims 64")
