"""The port's `-batch B` backend (hivemall_tpu_torch/core/batch_update.py,
`fit_linear -batch`) against the JAX package's (hivemall_tpu/core/
batch_update.py), on the CPU, on the same numpy inputs.

Tolerances are the reference's own for this backend
(tests/test_batch_update.py:214-226): float tables rtol 5e-5 / atol 5e-6;
`touched` and the DELTA_SLOT update counts EXACT; the scalar globals rtol
1e-5; `step` exact.

The port's segment totals take their prefix sum in float64 where the JAX
step's is float32 (ops/scatter.py::staged_segment_totals), so the port's
per-feature sums are the minibatch engine's to f32 rounding while the JAX
batch step's carry the f32 prefix's error. Against the JAX batch step the
derive_w rule (AdaGradRDA, whose squared-gradient column has the largest
prefix) therefore runs on chunk-disjoint features, as the reference's own
derive_w pins do (tests/test_batch_update.py:63-83, :200-202); on colliding
features, from a warm state, every rule is held against the JAX minibatch
engine applied chunk by chunk — AdaGradRDA against its `mxu` backend, whose
"a lane that fired wins" is the batch backend's rule.

AdaGradRDA and the red reference: `test_batch_b1_equals_minibatch_b1
[adagrad_rda]` is red on this tree, so nothing here goes through that
identity; the port's AdaGradRDA is held against the JAX batch step and the
JAX minibatch step directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.core import batch_update as JB
from hivemall_tpu.core import engine as JE
from hivemall_tpu.core.engine import DELTA_SLOT
from hivemall_tpu.models import classifier as JC
from hivemall_tpu.models import regression as JR
from hivemall_tpu_torch.core import batch_update as TB
from hivemall_tpu_torch.core.state import (linear_state_from_numpy,
                                           linear_state_to_numpy)
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import regression as TR

from torch_cases import (PORT_RULES, bf16_values, jax_state_from_numpy,
                         jax_state_numpy, warm_numpy)

B_RTOL, B_ATOL = 5e-5, 5e-6

# the reference's 14 rules (tests/test_batch_update.py:37-52)
RULES = [
    (JC.PERCEPTRON, {}, True),
    (JC.PA, {}, True),
    (JC.PA1, {"c": 1.0}, True),
    (JC.PA2, {"c": 1.0}, True),
    (JC.CW, {"phi": 1.0}, True),
    (JC.AROW, {"r": 0.1}, True),
    (JC.AROWH, {"r": 0.1, "c": 1.0}, True),
    (JC.SCW1, {"phi": 1.0, "c": 1.0}, True),
    (JC.SCW2, {"phi": 1.0, "c": 1.0}, True),
    (JC.ADAGRAD_RDA, {"eta": 0.1, "lambda": 1e-6, "scale": 100.0}, True),
    (JR.AROW_REGR, {"r": 0.1}, False),
    (JR.AROWE2_REGR, {"r": 0.1, "epsilon": 0.01}, False),
    (JR.ADAGRAD_REGR, {"eta": 1.0, "eps": 1.0, "scale": 100.0}, False),
    (JR.ADADELTA_REGR, {"rho": 0.95, "eps": 1e-6, "scale": 100.0}, False),
]
RULE_IDS = [r[0].name for r in RULES]


def block(n, k, d, seed=2, binary=True, pad_frac=0.25, disjoint=False,
          chunk=None):
    """Hashed rows with pad lanes (the reference's `_data`); `disjoint`
    makes every feature appear in at most one row of each `chunk`-row
    window."""
    rng = np.random.RandomState(seed)
    if disjoint:
        idx = np.stack([(i % chunk) * k + rng.permutation(k)
                        for i in range(n)]).astype(np.int32)
    else:
        idx = rng.randint(0, d, size=(n, k)).astype(np.int32)
    if pad_frac:
        idx[:, -1] = np.where(rng.rand(n) < pad_frac, d, idx[:, -1])
    val = rng.randn(n, k).astype(np.float32)
    val[idx >= d] = 0.0
    y = np.sign(rng.randn(n)).astype(np.float32) if binary else \
        rng.randn(n).astype(np.float32) * 0.1
    return idx, val, y


def warm_pair(rule, d, seed, track_deltas=True, bf16=False):
    """One warm state (random tables, globals, step) in both packages."""
    w = warm_numpy(rule, d, seed)
    if track_deltas:
        w["slots"][DELTA_SLOT] = np.random.RandomState(seed).randint(
            0, 5, d).astype(np.float32)
    if bf16:
        w["weights"] = bf16_values(w["weights"])
        if w["covars"] is not None:
            w["covars"] = bf16_values(w["covars"])
    js, ts = jax_state_from_numpy(w), linear_state_from_numpy(w, "cpu")
    if bf16:
        js = js.replace(weights=js.weights.astype(jnp.bfloat16),
                        covars=None if js.covars is None
                        else js.covars.astype(jnp.bfloat16))
        ts = ts.replace(weights=ts.weights.to(torch.bfloat16),
                        covars=None if ts.covars is None
                        else ts.covars.to(torch.bfloat16))
    return js, ts


def assert_batch_states_match(got, jst, got_loss=None, want_loss=None):
    a, b = linear_state_to_numpy(got), jax_state_numpy(jst)
    np.testing.assert_allclose(a["weights"], b["weights"], rtol=B_RTOL,
                               atol=B_ATOL, err_msg="weights")
    if b["covars"] is not None:
        np.testing.assert_allclose(a["covars"], b["covars"], rtol=B_RTOL,
                                   atol=B_ATOL, err_msg="covars")
    assert set(a["slots"]) == set(b["slots"])
    for s in b["slots"]:
        if s == DELTA_SLOT:
            np.testing.assert_array_equal(a["slots"][s], b["slots"][s])
        else:
            np.testing.assert_allclose(a["slots"][s], b["slots"][s],
                                       rtol=B_RTOL, atol=B_ATOL, err_msg=s)
    for g in b["globals"]:
        np.testing.assert_allclose(a["globals"][g], b["globals"][g],
                                   rtol=1e-5, atol=1e-6, err_msg=g)
    np.testing.assert_array_equal(a["touched"], b["touched"])
    assert int(a["step"]) == int(b["step"])
    if want_loss is not None:
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=B_RTOL, atol=B_ATOL)


def run_both(jrule, hyper, idx, val, y, b, d, seed=3, average=True,
             bf16=False):
    rule = PORT_RULES[jrule.name]
    js, ts = warm_pair(rule, d, seed, bf16=bf16)
    jst, jloss = JB.make_batch_train_step(
        jrule, hyper, batch_size=b, mini_batch_average=average,
        track_deltas=True, donate=False)(
        js, idx, val, y, JB.stage_block_plans(idx, b, d))
    step = TB.make_batch_train_fn(rule, hyper, batch_size=b,
                                  mini_batch_average=average,
                                  track_deltas=True, device="cpu")
    got, loss = step(ts, idx, val, y, TB.stage_block_plans(idx, b, d))
    return got, loss, jst, jloss


@pytest.mark.parametrize("rule,hyper,binary", RULES, ids=RULE_IDS)
def test_batch_step_matches_jax(rule, hyper, binary):
    """A 53-row block at B = 8 (six chunks and a 5-row tail) with pad
    lanes, from a warm state; colliding features except for derive_w rules
    (module docstring)."""
    d, b = 128, 8
    disjoint = rule.derive_w is not None
    idx, val, y = block(53, 4, d, binary=binary, disjoint=disjoint, chunk=b,
                        pad_frac=0.0 if disjoint else 0.25)
    got, loss, jst, jloss = run_both(rule, hyper, idx, val, y, b, d)
    assert_batch_states_match(got, jst, loss, jloss)


@pytest.mark.parametrize("rule,hyper,binary", RULES, ids=RULE_IDS)
def test_batch_step_matches_jax_minibatch_chunks(rule, hyper, binary):
    """The batch backend IS the minibatch semantics: the same block, with
    colliding features, equals the JAX minibatch engine stepped over the
    same 8-row chunks (AdaGradRDA: its mxu backend)."""
    d, b = 128, 8
    idx, val, y = block(53, 4, d, binary=binary)
    rule_t = PORT_RULES[rule.name]
    js, ts = warm_pair(rule_t, d, 3)
    backend = "mxu" if rule.derive_w is not None else "xla"
    mb = jax.jit(JE.make_train_fn(rule, hyper, mode="minibatch",
                                  track_deltas=True, update_backend=backend))
    for s in range(0, len(y), b):
        js, _ = mb(js, idx[s:s + b], val[s:s + b], y[s:s + b])
    got, _ = TB.make_batch_train_fn(rule_t, hyper, b, track_deltas=True,
                                    device="cpu")(
        ts, idx, val, y, TB.stage_block_plans(idx, b, d))
    assert_batch_states_match(got, js)


@pytest.mark.parametrize("average", [True, False])
def test_adagrad_rda_on_chunk_disjoint_features(average):
    """AdaGradRDA (derive_w) on chunk-disjoint features, with and without
    count averaging: no feature is shared by two rows of a chunk."""
    rule, hyper, _ = RULES[9]
    d, b = 128, 8
    idx, val, y = block(53, 4, d, disjoint=True, chunk=b, pad_frac=0.0)
    got, loss, jst, jloss = run_both(rule, hyper, idx, val, y, b, d,
                                     average=average)
    assert_batch_states_match(got, jst, loss, jloss)


@pytest.mark.parametrize("name", ["arow", "pa1"])
def test_batch_step_bf16_tables_match_jax(name):
    """bf16 weight/covariance tables (the above-2^24-dims storage): the
    sums are cast to bf16 before the add, as in the JAX batch backend."""
    jrule = {r.name: (r, h) for r, h, _ in RULES}[name]
    d, b = 96, 8
    idx, val, y = block(40, 4, d, seed=9)
    got, loss, jst, jloss = run_both(*jrule, idx, val, y, b, d, bf16=True)
    assert got.weights.dtype == torch.bfloat16
    assert jst.weights.dtype == jnp.bfloat16
    assert_batch_states_match(got, jst, loss, jloss)


def test_uploaded_plans_equal_host_plans():
    """The fit's form (plans uploaded once, live counts beside them) and
    the per-call upload give the same state."""
    rule, hyper = TC.AROW, {"r": 0.1}
    d, b = 128, 8
    idx, val, y = block(53, 4, d)
    plans = TB.stage_block_plans(idx, b, d)
    dev = TB.upload_block_plans(plans, d, "cpu")
    assert dev.main_live == tuple(int((r < d).sum()) for r in plans.main.rep)
    assert dev.tail_live == int((plans.tail.rep < d).sum())
    step = TB.make_batch_train_step(rule, hyper, b, device="cpu")
    outs = [step(warm_pair(rule, d, 3)[1], idx, val, y, p) for p in
            (plans, dev)]
    a, b_ = (linear_state_to_numpy(s) for s, _ in outs)
    for k in ("weights", "covars", "touched"):
        np.testing.assert_array_equal(a[k], b_[k])


# ------------------------------------------------------- fit_linear -batch

TRAINERS = {
    "arow": (TC.train_arow, JC.train_arow, True),
    "pa1": (TC.train_pa1, JC.train_pa1, True),
    "adagrad_rda": (TC.train_adagrad_rda, JC.train_adagrad_rda, True),
    "arow_regr": (TR.train_arow_regr, JR.train_arow_regr, False),
}


def rows(binary, n=240, d=64, k=8, seed=0):
    """Ragged hashed rows with repeated ids and labels from a hidden
    linear model (tests/test_torch_fit.py's generator)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d)
    lens = rng.randint(3, k + 1, size=n)
    idx = [rng.randint(0, d, size=m).astype(np.int64) for m in lens]
    val = [rng.randn(m).astype(np.float32) for m in lens]
    score = np.array([v @ w[i] for i, v in zip(idx, val)])
    y = np.sign(score) if binary else (0.3 * np.tanh(score)).astype(np.float32)
    return (idx, val), y


def assert_models_match(mt, mj, feats):
    assert_batch_states_match(mt.state, mj.state)
    np.testing.assert_allclose(mt.predict(feats), mj.predict(feats),
                               rtol=5e-4, atol=5e-5)
    got, want = mt.model_rows(), mj.model_rows()
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("opts", [
    "-dims 64 -batch 16 -block_size 100",  # blocks of 112 rows, a tail
    "-dims 64 -batch 7",  # block rounds 4096 up to 4102: one block, a tail
    "-dims 64 -batch 16 -iters 3 -disable_cv",
    "-dims 64 -batch 16 -iters 3 -disable_cv -shuffle -block_size 64",
])
@pytest.mark.parametrize("name", list(TRAINERS))
def test_fit_linear_batch_matches_jax(name, opts):
    train_t, train_j, binary = TRAINERS[name]
    feats, y = rows(binary)
    mt = train_t(feats, y, opts, device="cpu")
    mj = train_j(feats, y, opts)
    assert_models_match(mt, mj, feats)


BAD_FLAGS = {
    "-batch 0": "-batch must be >= 1",
    "-batch -2": "-batch must be >= 1",
    "-batch 16 -mini_batch 4": "-batch IS the mini-batch backend",
    "-batch 16 -native_scan": "does not compose",
    "-batch 16 -pallas": "does not compose",
    "-batch 16 -mxu_scatter": "does not compose",
    "-native_apply": "-native_apply rides the -batch backend",
    "-mini_batch 8 -native_apply": "-native_apply rides the -batch backend",
}


@pytest.mark.parametrize("bad", list(BAD_FLAGS))
def test_batch_flag_refusals_match_jax(bad):
    """Every combination the JAX package refuses, the port refuses with the
    same message."""
    feats, y = rows(True, n=20)
    for train in (TC.train_arow, JC.train_arow):
        kw = {"device": "cpu"} if train is TC.train_arow else {}
        with pytest.raises(ValueError, match=BAD_FLAGS[bad]):
            train(feats, y, f"-dims 64 {bad}", **kw)

