"""`-native_scan` in the port (hivemall_tpu_torch/models/base.py,
models/fm.py) against the JAX package's (hivemall_tpu/models/base.py:139,
models/fm.py:608) on the CPU (`device="cpu"`), same numpy inputs.

Both packages run the same C row loops (native/hivemall_native.cpp), built
from one source by one compiler, so the tables are expected bitwise equal;
they are held at rtol 1e-6 / atol 1e-7, `touched` and `step` exact. The FM
runs start from JAX's initial V, carried into the port as
tests/test_torch_fm.py carries it (the port draws V from a torch
generator). None of the JAX functions used here is red on this tree.

AROW's -native_scan is also held against the port's own exact scan on rows
with no id repeated within a row, at the JAX package's parity tolerance
rtol 1e-4 / atol 1e-5; a repeated id is pinned as the deviation it is."""

import numpy as np
import pytest
import torch

from hivemall_tpu.models import classifier as JC
from hivemall_tpu.models import fm as JF
from hivemall_tpu_torch import native as TN
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import fm as TF

from torch_cases import jax_fm_numpy

RTOL, ATOL = 1e-6, 1e-7


def _rows(n=400, d=64, k=6, seed=0):
    """Rows of k distinct ids with random values; label from a hidden
    linear model."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d)
    idx = [rng.choice(d, size=k, replace=False) for _ in range(n)]
    val = [rng.randn(k).astype(np.float32) for _ in range(n)]
    y = np.array([1.0 if w_true[i] @ v > 0 else -1.0
                  for i, v in zip(idx, val)])
    return idx, val, y


def _assert_linear_match(got, want):
    np.testing.assert_allclose(got.state.weights.numpy(),
                               np.asarray(want.state.weights),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.state.covars.numpy(),
                               np.asarray(want.state.covars),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.state.touched.numpy(),
                                  np.asarray(want.state.touched))
    assert got.state.step == int(want.state.step)


# --- AROW --------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    "-dims 64",
    "-dims 64 -block_size 37",
    "-dims 64 -iters 3 -disable_cv -shuffle",
    "-dims 64 -iters 5 -cv_rate 0.5",
    "-dims 64 -r 0.5 -pallas",
])
def test_arow_native_scan_matches_jax(opts):
    feats, y = _rows()[:2], _rows()[2]
    before = TN.CALLS["arow_reference_rowloop"]
    got = TC.train_arow(feats, y, f"{opts} -native_scan", device="cpu")
    assert TN.CALLS["arow_reference_rowloop"] > before
    want = JC.train_arow(feats, y, f"{opts} -native_scan")
    assert got.state.weights.device.type == "cpu"
    _assert_linear_match(got, want)
    np.testing.assert_allclose(got.predict((feats[0][:50], feats[1][:50])),
                               want.predict((feats[0][:50], feats[1][:50])),
                               rtol=RTOL, atol=ATOL)


def test_arow_native_scan_warm_start_matches_jax():
    """From warm weights and covariances (numpy, and the weights as a
    tensor too); a warm-only feature the data never reaches stays in the
    model emission (touched = the C loop's flags OR the warm mask)."""
    idx, val, y = _rows(seed=1)
    idx = [i % 60 for i in idx]  # features 60..63 only in the warm state
    rng = np.random.RandomState(2)
    w0 = (rng.randn(64) * (rng.rand(64) < 0.5)).astype(np.float32)
    w0[63] = 1.5
    c0 = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = JC.train_arow((idx, val), y, "-dims 64 -native_scan",
                         initial_weights=w0, initial_covars=c0)
    for w_init in (w0, torch.from_numpy(w0)):
        got = TC.train_arow((idx, val), y, "-dims 64 -native_scan",
                            initial_weights=w_init, initial_covars=c0,
                            device="cpu")
        _assert_linear_match(got, want)
        feats, w_emit, _ = got.model_rows()
        assert 63 in feats.tolist()
        assert w_emit[feats.tolist().index(63)] == 1.5


def test_arow_native_scan_string_rows_match_jax():
    rng = np.random.RandomState(4)
    rows = [[f"f{i}:{v:.3f}" for i, v in zip(rng.randint(0, 500, 5),
                                             rng.randn(5))]
            for _ in range(200)]
    y = np.sign(rng.randn(200))
    got = TC.train_arow(rows, y, "-dims 256 -native_scan", device="cpu")
    want = JC.train_arow(rows, y, "-dims 256 -native_scan")
    _assert_linear_match(got, want)


def test_arow_native_scan_refusals_match_jax():
    idx, val, y = _rows(n=20)
    cases = [
        (TC.train_perceptron, JC.train_perceptron, "-dims 64 -native_scan",
         "train_arow only"),
        (TC.train_arow, JC.train_arow, "-dims 64 -mini_batch 8 -native_scan",
         "exact per-row path"),
        (TC.train_arow, JC.train_arow,
         "-dims 64 -mini_batch 8 -mxu_scatter -native_scan",
         "exact per-row path"),
        (TC.train_arow, JC.train_arow, "-dims 64 -batch 8 -native_scan",
         "does not compose"),
    ]
    for port, jax, opts, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jax((idx, val), y, opts)
        with pytest.raises(ValueError, match=msg):
            port((idx, val), y, opts, device="cpu")


# the JAX package's own -native_scan vs engine-scan parity tolerance
# (tests/test_native.py): the C loop and the engine sum a row's lanes in
# other orders
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("mode", ["", "-pallas"])
def test_arow_native_scan_matches_the_exact_scan_without_repeats(mode):
    """On rows with no id repeated within a row, -native_scan equals the
    port's exact scan (engine scan mode, and -pallas's plain version) at
    SCAN_RTOL / SCAN_ATOL. `touched` is exact against the features whose
    covariance the scan moved: the C loop and engine scan mode mark the
    features of rows that updated (margin < 1), while -pallas, as in the
    JAX package, marks every feature it read."""
    idx, val, y = _rows(n=600, d=255, k=12, seed=3)
    # a last row the trained model already classifies at a margin of 2,
    # with id 255 that no other row holds: read by the scan, never updated
    w = TC.train_arow((idx, val), y, "-dims 256 -native_scan",
                      device="cpu").state.weights.numpy()
    margins = np.array([yi * (w[i] @ v) for i, v, yi in zip(idx, val, y)])
    best = int(np.argmax(margins))
    idx.append(np.append(idx[best], 255))
    val.append(np.append(val[best] * (2 / margins[best]), 1).astype(np.float32))
    y = np.append(y, y[best])
    got = TC.train_arow((idx, val), y, "-dims 256 -native_scan",
                        device="cpu")
    want = TC.train_arow((idx, val), y, f"-dims 256 {mode}", device="cpu")
    for f in ("weights", "covars"):
        np.testing.assert_allclose(getattr(got.state, f).numpy(),
                                   getattr(want.state, f).numpy(),
                                   rtol=SCAN_RTOL, atol=SCAN_ATOL)
    updated = want.state.covars.numpy() != 1
    np.testing.assert_array_equal(got.state.touched.numpy().astype(bool),
                                  updated)
    read = want.state.touched.numpy().astype(bool)
    if mode == "-pallas":
        assert (read >= updated).all() and read[255] and not updated[255]
    else:
        np.testing.assert_array_equal(read, updated)


def test_arow_native_scan_repeated_id_updates_lanes_in_place():
    """The pinned deviation: an id repeated within a row. The C loop
    updates lane after lane in place, so the second lane of id 3 reads
    the covariance the first lane left; the exact scan computes every
    lane's update from the row's one gather and adds them."""
    idx = [np.array([3, 3, 5])]
    val = [np.array([1.0, 0.5, 2.0], np.float32)]
    f32 = np.float32
    beta = f32(1) / (f32(1 + 0.25 + 4) + f32(0.1))  # variance + r; alpha = beta
    in_place_w = beta + beta * (1 - beta) * f32(0.5)
    in_place_cov = (1 - beta) - beta * ((1 - beta) * f32(0.5)) ** 2
    added_w, added_cov = beta * f32(1.5), 1 - beta * f32(1.25)
    nat = TC.train_arow((idx, val), [1.0], "-dims 8 -native_scan",
                        device="cpu")
    np.testing.assert_allclose(nat.state.weights.numpy()[[3, 5]],
                               [in_place_w, 2 * beta], rtol=1e-6)
    np.testing.assert_allclose(nat.state.covars.numpy()[[3, 5]],
                               [in_place_cov, 1 - 4 * beta], rtol=1e-6)
    for mode in ("", "-pallas"):
        scan = TC.train_arow((idx, val), [1.0], f"-dims 8 {mode}",
                             device="cpu")
        np.testing.assert_allclose(scan.state.weights.numpy()[[3, 5]],
                                   [added_w, 2 * beta], rtol=1e-6)
        np.testing.assert_allclose(scan.state.covars.numpy()[[3, 5]],
                                   [added_cov, 1 - 4 * beta], rtol=1e-6)


# --- FM ----------------------------------------------------------------------

@pytest.fixture
def jax_init(monkeypatch):
    """Make the port's train_fm start from JAX's initial state."""
    def init(dims, hyper, device=None):
        jh = JF.FMHyper(factors=hyper.factors, sigma=hyper.sigma,
                        lambda0=hyper.lambda0, seed=hyper.seed)
        return TF.fm_state_from_numpy(
            jax_fm_numpy(JF.init_fm_state(dims, jh)), device)

    monkeypatch.setattr(TF, "init_fm_state", init)


@pytest.mark.parametrize("opts", [
    "-c -dims 64 -factor 5 -eta 0.05",
    "-c -dims 64 -factor 4 -eta 0.1 -lambda0 0.02 -iters 2 -disable_cv",
    "-c -dims 64 -factor 8 -eta 0.05 -iters 3 -disable_cv -shuffle "
    "-block_size 64",
])
def test_fm_native_scan_matches_jax(jax_init, opts):
    idx, val, y = _rows(seed=5)
    idx[3] = np.array([7, 7, 1, 2, 3, 4])  # a repeated id within a row
    before = TN.CALLS["fm_reference_rowloop"]
    got = TF.train_fm((idx, val), y, f"{opts} -native_scan", device="cpu")
    assert TN.CALLS["fm_reference_rowloop"] > before
    want = jax_fm_numpy(JF.train_fm((idx, val), y,
                                    f"{opts} -native_scan").state)
    a = TF.fm_state_to_numpy(got.state)
    for k in ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v"):
        np.testing.assert_allclose(a[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(a["touched"], want["touched"])
    assert int(a["step"]) == int(want["step"])
    assert a["v"].shape == want["v"].shape  # the lane padding restored
    assert got.state.w.device.type == "cpu"


@pytest.mark.parametrize("opts,msg", [
    ("-dims 64 -eta 0.05", "classification"),
    ("-c -dims 64", "fixed -eta"),
    ("-c -dims 64 -eta 0.05 -adareg", "adareg"),
    ("-c -dims 64 -eta 0.05 -mini_batch 8", "per-row scan mode"),
])
def test_fm_native_scan_refusals_match_jax(opts, msg):
    idx, val, y = _rows(n=20)
    with pytest.raises(ValueError, match=msg):
        JF.train_fm((idx, val), y, f"{opts} -native_scan")
    with pytest.raises(ValueError, match=msg):
        TF.train_fm((idx, val), y, f"{opts} -native_scan", device="cpu")
