"""`-batch B -native_apply` in the port (hivemall_tpu_torch/core/
native_batch.py, models/base.py) against the JAX package's native apply
(hivemall_tpu/core/native_batch.py) and against the port's own plain-torch
`-batch` step, on the CPU, same numpy inputs, for every rule with a native
closed form (perceptron, CW, AROW, AROWh).

Tolerances are the reference's for native apply against its batch step
(tests/test_native_batch.py:133-139): float tables rtol 5e-5 / atol 5e-6
(the C pass and the torch step sum in different orders), `touched` exact,
the block's loss to rel 1e-4. The loud fallback (an unsupported rule, bf16
tables) warns with the reference's reason and trains through the port's
`-batch` path. None of the JAX functions used here is red on this tree."""

import numpy as np
import pytest
import torch

from hivemall_tpu.core import batch_update as JBU
from hivemall_tpu.core import native_batch as JNB
from hivemall_tpu.models import classifier as JC
from hivemall_tpu_torch import native as TN
from hivemall_tpu_torch.core import native_batch as TNB
from hivemall_tpu_torch.core.batch_update import (make_batch_train_step,
                                                  stage_block_plans)
from hivemall_tpu_torch.core.state import init_linear_state
from hivemall_tpu_torch.models import classifier as TC

RTOL, ATOL = 5e-5, 5e-6
RULES = {
    "perceptron": (TC.PERCEPTRON, JC.PERCEPTRON, {}, "train_perceptron"),
    "cw": (TC.CW, JC.CW, {"phi": 1.0}, "train_cw"),
    "arow": (TC.AROW, JC.AROW, {"r": 0.1}, "train_arow"),
    "arowh": (TC.AROWH, JC.AROWH, {"r": 0.1, "c": 1.0}, "train_arowh"),
}


def _data(n, k, d, seed=2, pad_frac=0.25):
    """A block with duplicate features, pad lanes (index d, value 0) and,
    for n not a multiple of B, a tail chunk."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, size=(n, k)).astype(np.int32)
    if pad_frac:
        idx[:, -1] = np.where(rng.rand(n) < pad_frac, d, idx[:, -1])
    val = rng.randn(n, k).astype(np.float32)
    val[idx >= d] = 0.0
    y = np.sign(rng.randn(n)).astype(np.float32)
    return idx, val, y


def _warm(d, use_cov, seed):
    rng = np.random.RandomState(seed)
    w0 = (rng.randn(d) * (rng.rand(d) < 0.3)).astype(np.float32)
    c0 = rng.uniform(0.5, 1.5, d).astype(np.float32) if use_cov else None
    return w0, c0


def _three_ways(name, d, b, idx, val, y, w0=None, c0=None):
    """The block through the port's native step, JAX's native step and the
    port's plain-torch -batch step, each from (w0, c0) or a fresh state.
    Returns [(weights, covars, touched, loss)] in that order."""
    trule, jrule, hyper, _ = RULES[name]
    use_cov = trule.use_covariance
    out = []
    tables = TNB.init_native_tables(d, use_cov, w0, c0)
    loss = TNB.make_native_batch_step(trule, hyper)(
        tables, val, y, stage_block_plans(idx, b, d))
    st = TNB.native_tables_to_state(tables, trule, len(y), device="cpu")
    assert st.step == len(y) and st.weights.device.type == "cpu"
    out.append((st.weights.numpy(),
                None if st.covars is None else st.covars.numpy(),
                st.touched.numpy(), loss))
    jt = JNB.init_native_tables(d, use_cov, w0, c0)
    jloss = JNB.make_native_batch_step(jrule, hyper)(
        jt, val, y, JBU.stage_block_plans(idx, b, d))
    out.append((jt["w"], jt["cov"], jt["touched"], jloss))
    step = make_batch_train_step(trule, hyper, batch_size=b, device="cpu")
    ps, ploss = step(
        init_linear_state(d, use_covariance=use_cov, initial_weights=w0,
                          initial_covars=c0, device="cpu"),
        idx, val, y, stage_block_plans(idx, b, d))
    out.append((ps.weights.numpy(),
                None if ps.covars is None else ps.covars.numpy(),
                ps.touched.numpy(), float(ploss)))
    return out


def _assert_all_match(results):
    (w, c, t, loss), *others = results
    for ow, oc, ot, oloss in others:
        np.testing.assert_allclose(w, ow, rtol=RTOL, atol=ATOL)
        if oc is not None:
            np.testing.assert_allclose(c, oc, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(t, ot)
        assert loss == pytest.approx(oloss, rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("name", sorted(RULES))
def test_native_apply_matches_jax_and_the_batch_step(name):
    """A 53-row block at B = 8: six stacked chunks and a tail, duplicate
    features and pad lanes."""
    d = 128
    idx, val, y = _data(53, 4, d)
    before = TN.CALLS["batch_apply_block"]
    _assert_all_match(_three_ways(name, d, 8, idx, val, y))
    assert TN.CALLS["batch_apply_block"] == before + 1


@pytest.mark.parametrize("name", sorted(RULES))
def test_native_apply_warm_start_and_b1(name):
    """From warm tables (touched seeded from the nonzero weights), and at
    B = 1, which replays the per-row semantics."""
    d = 64
    idx, val, y = _data(24, 4, d, seed=9, pad_frac=0.0)
    w0, c0 = _warm(d, RULES[name][0].use_covariance, seed=1)
    for b in (1, 8):
        _assert_all_match(_three_ways(name, d, b, idx, val, y, w0, c0))


def _rows(n=120, d=256, seed=11):
    rng = np.random.RandomState(seed)
    idx_rows = [rng.choice(d, 5, replace=False).astype(np.int64)
                for _ in range(n)]
    val_rows = [rng.randn(5).astype(np.float32) for _ in range(n)]
    w_true = rng.randn(d).astype(np.float32)
    labels = [1.0 if v @ w_true[i] > 0 else -1.0
              for i, v in zip(idx_rows, val_rows)]
    return (idx_rows, val_rows), labels


@pytest.mark.parametrize("name", sorted(RULES))
def test_fit_linear_native_apply_end_to_end(name):
    """The public train_* entry: -batch 16 -native_apply against the JAX
    package's and against the port's -batch 16; then several epochs with
    -shuffle (the plan cache cleared per re-deal) against JAX's."""
    feats, labels = _rows()
    _, _, _, train = RULES[name]
    tr, jr = getattr(TC, train), getattr(JC, train)
    opts = "-dims 256 -batch 16 -native_apply"
    m_nat = tr(feats, labels, opts, device="cpu")
    m_jax = jr(feats, labels, opts)
    m_bat = tr(feats, labels, "-dims 256 -batch 16", device="cpu")
    for other in (m_jax, m_bat):
        np.testing.assert_allclose(m_nat.state.weights.numpy(),
                                   np.asarray(other.state.weights),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(m_nat.state.touched.numpy(),
                                      np.asarray(other.state.touched))
        assert m_nat.state.step == int(other.state.step)
    np.testing.assert_allclose(m_nat.predict((feats[0][:8], feats[1][:8])),
                               m_jax.predict((feats[0][:8], feats[1][:8])),
                               rtol=5e-4, atol=5e-5)
    opts = "-dims 256 -batch 8 -native_apply -iters 3 -disable_cv -shuffle"
    m = tr(feats, labels, opts, device="cpu")
    j = jr(feats, labels, opts)
    np.testing.assert_allclose(m.state.weights.numpy(),
                               np.asarray(j.state.weights), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(m.state.touched.numpy(),
                                  np.asarray(j.state.touched))
    assert m.state.step == int(j.state.step) == 3 * len(labels)


def test_native_apply_warm_start_through_fit_linear():
    feats, labels = _rows(seed=12)
    w0, c0 = _warm(256, True, seed=3)
    opts = "-dims 256 -batch 16 -native_apply"
    got = TC.train_arow(feats, labels, opts, initial_weights=w0,
                        initial_covars=c0, device="cpu")
    want = JC.train_arow(feats, labels, opts, initial_weights=w0,
                         initial_covars=c0)
    np.testing.assert_allclose(got.state.weights.numpy(),
                               np.asarray(want.state.weights), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.state.covars.numpy(),
                               np.asarray(want.state.covars), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got.state.touched.numpy(),
                                  np.asarray(want.state.touched))


# --- the loud fallback and the refusals --------------------------------------

def test_unsupported_rule_falls_back_loudly():
    """A rule without a native closed form warns with the reference's
    reason and trains through the port's -batch path."""
    feats, labels = _rows(n=24, d=64)
    with pytest.warns(UserWarning, match="no native batch closed form"):
        JC.train_pa1(feats, labels, "-dims 64 -batch 8 -native_apply")
    with pytest.warns(UserWarning, match="no native batch closed form"):
        m_fb = TC.train_pa1(feats, labels, "-dims 64 -batch 8 -native_apply",
                            device="cpu")
    m_ref = TC.train_pa1(feats, labels, "-dims 64 -batch 8", device="cpu")
    torch.testing.assert_close(m_fb.state.weights, m_ref.state.weights,
                               rtol=0, atol=0)


def test_bf16_tables_fall_back_loudly():
    """Above 2^24 dims the tables are bf16, which the native pass refuses:
    both packages warn with the same reason, and the port's -batch path
    trains on bf16 tables."""
    dims = (1 << 24) + 16
    feats = ([np.array([1, 5, dims - 1])] * 8, [np.ones(3, np.float32)] * 8)
    labels = [1, -1] * 4
    opts = f"-dims {dims} -batch 4 -native_apply"
    with pytest.warns(UserWarning, match="bf16 table storage"):
        got = TC.train_arow(feats, labels, opts, device="cpu")
    assert got.state.weights.dtype == torch.bfloat16
    want = TC.train_arow(feats, labels, f"-dims {dims} -batch 4",
                         device="cpu")
    torch.testing.assert_close(got.state.weights, want.state.weights,
                               rtol=0, atol=0)
    assert JNB.native_batch_unsupported_reason(
        JC.AROW, table_dtype_is_f32=False) == \
        TNB.native_batch_unsupported_reason(TC.AROW, table_dtype_is_f32=False)


@pytest.mark.parametrize("rule", ["pa1", "adagrad_rda", "arow", "deltas"])
def test_unsupported_reasons_are_the_references(rule):
    trule = {"pa1": TC.PA1, "adagrad_rda": TC.ADAGRAD_RDA}.get(rule, TC.AROW)
    jrule = {"pa1": JC.PA1, "adagrad_rda": JC.ADAGRAD_RDA}.get(rule, JC.AROW)
    deltas = rule == "deltas"
    got = TNB.native_batch_unsupported_reason(trule, track_deltas=deltas)
    assert got == JNB.native_batch_unsupported_reason(
        jrule, track_deltas=deltas)
    assert (got is None) == (rule == "arow")
    if deltas:
        assert "DELTA_SLOT" in got


@pytest.mark.parametrize("bad,msg", [
    ("-native_apply", "rides the -batch backend"),
    ("-native_apply -mini_batch 4", "rides the -batch backend"),
    ("-native_apply -native_scan", "rides the -batch backend"),
    ("-native_apply -mxu_scatter -mini_batch 4", "rides the -batch backend"),
    ("-batch 8 -native_apply -mxu_scatter", "does not compose"),
])
def test_native_apply_refusals_match_jax(bad, msg):
    feats, labels = _rows(n=24, d=64)
    with pytest.raises(ValueError, match=msg):
        JC.train_arow(feats, labels, f"-dims 64 {bad}")
    with pytest.raises(ValueError, match=msg):
        TC.train_arow(feats, labels, f"-dims 64 {bad}", device="cpu")


def test_make_native_batch_step_refuses_an_unsupported_rule():
    with pytest.raises(RuntimeError, match="no native batch closed form"):
        TNB.make_native_batch_step(TC.PA1, {})


def test_batch_apply_block_argument_validation():
    """The ctypes wrapper refuses unknown rules, wrong table dtypes, a
    missing required hyperparameter, and label / table length mismatches
    before native code touches any memory; device plans are refused by the
    plan ABI."""
    d = 32
    idx, val, y = _data(8, 4, d, pad_frac=0.0)
    plans = stage_block_plans(idx, 4, d)
    w = np.zeros(d, np.float32)
    cov = np.ones(d, np.float32)
    touched = np.zeros(d, np.int8)
    args = (plans.main, plans.tail, d)
    with pytest.raises(ValueError, match="no native batch closed form"):
        TN.batch_apply_block("pa1", {}, val, y, *args, w, cov, touched)
    with pytest.raises(ValueError, match="C-contiguous"):
        TN.batch_apply_block("arow", {"r": 0.1}, val, y, *args,
                             w.astype(np.float64), cov, touched)
    with pytest.raises(KeyError, match="phi"):
        TN.batch_apply_block("cw", {}, val, y, *args, w, cov, touched)
    with pytest.raises(ValueError, match="labels shape"):
        TN.batch_apply_block("arow", {"r": 0.1}, val, y[:-1], *args, w, cov,
                             touched)
    with pytest.raises(ValueError, match="rows < dims"):
        TN.batch_apply_block("arow", {"r": 0.1}, val, y, *args, w[:d - 4],
                             cov, touched)
    device_plan = type(plans.main)(*(torch.from_numpy(a)
                                     for a in plans.main))
    with pytest.raises(TypeError, match="host numpy"):
        TN.batch_apply_block("arow", {"r": 0.1}, val, y, device_plan, None,
                             d, w, cov, touched)
    assert not w.any() and (cov == 1).all()  # nothing was applied
