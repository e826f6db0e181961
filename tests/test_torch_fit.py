"""The port's user API (`train_*` -> `fit_linear`, `predict`, `model_rows`)
against the JAX package's, end to end on the CPU (`device="cpu"`), for
train_arow / train_pa1 / train_adagrad_rda / train_arow_regr under the
execution options the port runs: scan, `-pallas` (the kernel's plain version
on the CPU), `-mini_batch`, and multi-epoch `-iters -shuffle`.

Same numpy rows on both sides; tolerance rtol 1e-5 / atol 1e-6; `touched`
exact. AdaGradRDA under `-mini_batch` is held against the JAX `-mxu_scatter`
backend, whose duplicate-feature rule the port follows (see
test_torch_engine.py)."""

import numpy as np
import pytest
import torch

from hivemall_tpu.models import classifier as JC
from hivemall_tpu.models import regression as JR
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import regression as TR

RTOL, ATOL = 1e-5, 1e-6

TRAINERS = {
    "arow": (TC.train_arow, JC.train_arow, True),
    "pa1": (TC.train_pa1, JC.train_pa1, True),
    "adagrad_rda": (TC.train_adagrad_rda, JC.train_adagrad_rda, True),
    "arow_regr": (TR.train_arow_regr, JR.train_arow_regr, False),
}
OPTIONS = ["-dims 64", "-dims 64 -pallas", "-dims 64 -mini_batch 16",
           "-dims 64 -iters 3 -shuffle"]


def rows(binary, n=240, d=64, k=8, seed=0):
    """Hashed rows with repeated ids (drawn with replacement), ragged
    lengths, and labels from a hidden linear model."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d)
    lens = rng.randint(3, k + 1, size=n)
    idx = [rng.randint(0, d, size=m).astype(np.int64) for m in lens]
    val = [rng.randn(m).astype(np.float32) for m in lens]
    score = np.array([v @ w[i] for i, v in zip(idx, val)])
    y = np.sign(score) if binary else (0.3 * np.tanh(score)).astype(np.float32)
    return (idx, val), y


def assert_models_match(mt, mj, feats):
    np.testing.assert_allclose(mt.state.weights.numpy(),
                               np.asarray(mj.state.weights), rtol=RTOL,
                               atol=ATOL)
    if mj.state.covars is not None:
        np.testing.assert_allclose(mt.state.covars.numpy(),
                                   np.asarray(mj.state.covars), rtol=RTOL,
                                   atol=ATOL)
    for s in mj.state.slots:
        np.testing.assert_allclose(mt.state.slots[s].numpy(),
                                   np.asarray(mj.state.slots[s]), rtol=RTOL,
                                   atol=ATOL)
    assert mt.state.step == int(mj.state.step)
    np.testing.assert_allclose(mt.predict(feats), mj.predict(feats),
                               rtol=RTOL, atol=ATOL)
    got, want = mt.model_rows(), mj.model_rows()
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("name", list(TRAINERS))
def test_train_matches_jax(name, opts):
    train_t, train_j, binary = TRAINERS[name]
    feats, y = rows(binary)
    jopts = opts
    if name == "adagrad_rda" and "-mini_batch" in opts:
        jopts += " -mxu_scatter"
    mt = train_t(feats, y, opts, device="cpu")
    mj = train_j(feats, y, jopts)
    assert_models_match(mt, mj, feats)


def test_predict_variance_and_string_features_match_jax():
    """String features go through the port's own murmur3 hashing."""
    rng = np.random.RandomState(4)
    feats = [[f"f{rng.randint(50)}:{rng.randn():.3f}" for _ in range(6)]
             + ["bias"] for _ in range(120)]
    y = rng.randint(0, 2, size=120)
    mt = TC.train_arow(feats, y, "-dims 1024", device="cpu")
    mj = JC.train_arow(feats, y, "-dims 1024")
    assert_models_match(mt, mj, feats)
    st, vt = mt.predict(feats, return_variance=True)
    sj, vj = mj.predict(feats, return_variance=True)
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)


def test_bf16_storage_above_2_24_dims():
    """Above 2^24 dims the tables are bf16 (the reference's half-float
    SpaceEfficientDenseModel switch) in both packages."""
    dims = (1 << 24) + 16
    feats = ([np.array([1, 5, dims - 1])] * 4, [np.ones(3, np.float32)] * 4)
    y = np.array([1, 0, 1, 1])
    mt = TC.train_pa1(feats, y, f"-dims {dims}", device="cpu")
    mj = JC.train_pa1(feats, y, f"-dims {dims}")
    assert mt.state.weights.dtype == torch.bfloat16
    got = mt.state.weights[[1, 5, dims - 1]].float().numpy()
    want = np.asarray(mj.state.weights[np.array([1, 5, dims - 1])],
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flag,match", [
    ("-native_apply", "rides the -batch backend"),
    # this case held -mini_batch -mxu_scatter refused as a later slice
    # until ops/mxu_scatter.py landed; it keeps its id and now holds the
    # refusal that stays, -batch with -mxu_scatter
    pytest.param("-batch 16 -mxu_scatter", "does not compose",
                 id="-mini_batch 16 -mxu_scatter-later slice")])
def test_later_slice_flags_are_refused(flag, match):
    feats, y = rows(True, n=10)
    with pytest.raises(ValueError, match=match):
        TC.train_arow(feats, y, f"-dims 64 {flag}", device="cpu")


def test_pallas_with_mini_batch_runs_minibatch():
    """As in the JAX package, -pallas selects the exact scan only; with
    -mini_batch the minibatch engine runs."""
    feats, y = rows(True)
    a = TC.train_arow(feats, y, "-dims 64 -mini_batch 16 -pallas",
                      device="cpu")
    b = TC.train_arow(feats, y, "-dims 64 -mini_batch 16", device="cpu")
    torch.testing.assert_close(a.state.weights, b.state.weights)
