"""The port's rule engine (hivemall_tpu_torch/core/engine.py) against the JAX
engine (hivemall_tpu/core/engine.py), on the CPU, for the eight rule
families of tests/pallas_cases.py: scan and minibatch steps, predict, epoch
driver, track_deltas, and minibatch-with-B=1 == scan.

Same numpy inputs on both sides; tolerance rtol 1e-5 / atol 1e-6 (the
reference's own); `touched` and `step` exact.

AdaGradRDA's minibatch step scatter-SETS derived weights; where one lane that
fired and one that did not share a feature, the JAX xla backend's winner is
the device's choice. The port takes "a lane that fired wins", the rule of the
JAX mxu backend (engine.py:471), so its minibatch AdaGradRDA is held against
`update_backend="mxu"`. (The reference's AdaGradRDA *batch* backend test is
red on this tree; nothing here uses that path.)"""

import numpy as np
import pytest
import torch

from hivemall_tpu.core import engine as JE
from hivemall_tpu.core.state import init_linear_state as jax_init_state
from hivemall_tpu_torch.core import engine as TE
from hivemall_tpu_torch.core.state import (init_linear_state,
                                           linear_state_from_numpy,
                                           linear_state_to_numpy)
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import regression as TR

from pallas_cases import generic_rules, make_block_data
from torch_cases import (PORT_RULES, RTOL, ATOL, assert_states_match,
                         jax_state_numpy)


def both_states(rule, dims, slot_names=None):
    slot_names = rule.slot_names if slot_names is None else slot_names
    js = jax_init_state(dims, use_covariance=rule.use_covariance,
                        slot_names=slot_names, global_names=rule.global_names)
    return js, linear_state_from_numpy(jax_state_numpy(js), device="cpu")


def data(i, binary, dup=False, B=48):
    idx, val, y = make_block_data(B=B, K=8, D=128, seed=i)
    if dup:
        idx[::2, 1] = idx[::2, 0]
    if not binary:
        y = (y * 0.3).astype(np.float32)
    return idx, val, y


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("i", range(8))
def test_scan_matches_jax(i, dup):
    jrule, hyper, binary = generic_rules()[i]
    rule = PORT_RULES[jrule.name]
    idx, val, y = data(i, binary, dup)
    js, ts = both_states(rule, 128)
    jst, jloss = JE.make_train_step(jrule, hyper, mode="scan", donate=False)(
        js, idx, val, y)
    step = TE.make_train_fn(rule, hyper, mode="scan", device="cpu")
    got, loss = step(ts, idx, val, y)
    assert_states_match(got, jax_state_numpy(jst), float(loss), float(jloss))


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("i", range(8))
def test_minibatch_matches_jax(i, average):
    jrule, hyper, binary = generic_rules()[i]
    rule = PORT_RULES[jrule.name]
    idx, val, y = data(i, binary, dup=True)
    js, ts = both_states(rule, 128)
    backend = "mxu" if rule.derive_w is not None else "xla"
    jfn = JE.make_train_fn(jrule, hyper, mode="minibatch",
                           mini_batch_average=average, update_backend=backend)
    jst, jloss = jfn(js, idx, val, y)
    step = TE.make_train_fn(rule, hyper, mode="minibatch",
                            mini_batch_average=average, device="cpu")
    got, loss = step(ts, idx, val, y)
    assert_states_match(got, jax_state_numpy(jst), float(loss), float(jloss))


@pytest.mark.parametrize("i", range(8))
def test_minibatch_b1_equals_scan(i):
    """Batch size 1 is exactly scan mode (core/engine.py docstring)."""
    jrule, hyper, binary = generic_rules()[i]
    rule = PORT_RULES[jrule.name]
    idx, val, y = data(i, binary, B=12)
    scan = TE.make_train_fn(rule, hyper, mode="scan", device="cpu")
    mb = TE.make_train_fn(rule, hyper, mode="minibatch", device="cpu")
    _, a = both_states(rule, 128)
    _, b = both_states(rule, 128)
    a, _ = scan(a, idx, val, y)
    for r in range(idx.shape[0]):
        b, _ = mb(b, idx[r:r + 1], val[r:r + 1], y[r:r + 1])
    assert_states_match(a, linear_state_to_numpy(b), 0.0, 0.0)


@pytest.mark.parametrize("mode", ["scan", "minibatch"])
def test_track_deltas_matches_jax(mode):
    jrule, hyper, _ = generic_rules()[2]  # AROW
    idx, val, y = data(2, True, dup=True)
    js, ts = both_states(TC.AROW, 128, slot_names=(JE.DELTA_SLOT,))
    jst, _ = JE.make_train_fn(jrule, hyper, mode=mode, track_deltas=True)(
        js, idx, val, y)
    got, _ = TE.make_train_fn(TC.AROW, hyper, mode=mode, track_deltas=True,
                              device="cpu")(ts, idx, val, y)
    np.testing.assert_array_equal(got.slots[TE.DELTA_SLOT].numpy(),
                                  np.asarray(jst.slots[JE.DELTA_SLOT]))


@pytest.mark.parametrize("cov", [False, True])
def test_predict_matches_jax(cov):
    rng = np.random.RandomState(5)
    d = {"weights": rng.randn(64).astype(np.float32),
         "covars": rng.uniform(0.5, 2, 64).astype(np.float32) if cov else None,
         "slots": {}, "touched": np.zeros(64, np.int8), "step": 0,
         "globals": {}}
    idx, val, _ = make_block_data(B=20, K=8, D=64, seed=1)
    js = jax_init_state(64, use_covariance=cov).replace(
        weights=d["weights"], covars=d["covars"])
    want = JE.make_predict(use_covariance=cov)(js, idx, val)
    got = TE.make_predict(use_covariance=cov)(
        linear_state_from_numpy(d, device="cpu"), idx, val)
    if cov:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_epoch_matches_jax():
    jrule, hyper, _ = generic_rules()[1]  # PA1
    idx, val, y = make_block_data(B=48, K=8, D=128, seed=9)
    stacked = (idx.reshape(4, 12, 8), val.reshape(4, 12, 8), y.reshape(4, 12))
    js, ts = both_states(TC.PA1, 128)
    jst, jl = JE.make_epoch(JE.make_train_fn(jrule, hyper, mode="scan"),
                            donate=False)(js, *stacked)
    epoch = TE.make_epoch(TE.make_train_fn(TC.PA1, hyper, mode="scan",
                                           device="cpu"))
    got, losses = epoch(ts, *(torch.from_numpy(s) for s in stacked))
    assert_states_match(got, jax_state_numpy(jst), losses.numpy(),
                        np.asarray(jl))


def test_batch_update_matches_rule():
    rule, hyper = TC.AROW, {"r": 0.1}
    idx, val, y = data(2, True)
    st = init_linear_state(128, use_covariance=True, device="cpu")
    ctx, live, _ = TE.row_context((st.weights, st.covars, st.slots),
                                  torch.from_numpy(idx).long(),
                                  torch.from_numpy(val), torch.from_numpy(y),
                                  torch.arange(48).float() + 1, True)
    out = TE.make_batch_update(rule, hyper)(ctx.w, ctx.cov, ctx.slots,
                                            ctx.val, ctx.y, ctx.t, {})
    ref = rule.update(ctx, hyper)
    torch.testing.assert_close(out.dw, ref.dw)
    torch.testing.assert_close(out.dcov, ref.dcov)


def test_refused_backends_name_the_later_slice():
    """No backend is a later slice any more: mxu (lifted with
    ops/mxu_scatter.py, held against JAX in tests/test_torch_mxu_scatter.py)
    builds and keeps only the reference's refusals; feature_shard (lifted
    with parallel/sharded_train.py) runs: one stripe of a one-rank mesh is
    the whole model, the unsharded step's."""
    TE.make_train_fn(TC.AROW, {"r": 0.1}, update_backend="mxu",
                     device="cpu")
    with pytest.raises(ValueError, match="requires minibatch mode"):
        TE.make_train_fn(TC.AROW, {"r": 0.1}, mode="scan",
                         update_backend="mxu", device="cpu")
    from torch_cases import one_rank_mesh

    rng = np.random.RandomState(0)
    idx = rng.randint(0, 64, size=(8, 4))
    val = rng.rand(8, 4).astype(np.float32)
    lab = np.sign(rng.randn(8)).astype(np.float32)
    for mode in ("minibatch", "scan"):
        ref, ref_loss = TE.make_train_fn(TC.AROW, {"r": 0.1}, mode=mode,
                                         device="cpu")(
            init_linear_state(64, use_covariance=True, device="cpu"),
            idx, val, lab)
        with one_rank_mesh() as mesh:
            got, loss = TE.make_train_fn(
                TC.AROW, {"r": 0.1}, mode=mode,
                feature_shard=(mesh, "workers", 64), device="cpu")(
                init_linear_state(64, use_covariance=True, device="cpu"),
                idx, val, lab)
        torch.testing.assert_close(got.weights, ref.weights)
        torch.testing.assert_close(got.covars, ref.covars)
        torch.testing.assert_close(loss, ref_loss)
    with pytest.raises(ValueError, match="unknown mode"):
        TE.make_train_fn(TC.AROW, {"r": 0.1}, mode="bogus", device="cpu")


def test_logress_rule_matches_jax():
    """The one rule without a kernel form, through both engines' scan."""
    from hivemall_tpu.models.regression import _make_logress_rule as jlog
    from hivemall_tpu.ops.eta import simple as jsimple
    from hivemall_tpu_torch.ops.eta import simple

    idx, val, y = data(0, False)
    y = (y > 0).astype(np.float32)
    js, ts = both_states(TR.PA1_REGR, 128)
    jst, _ = JE.make_train_step(jlog(jsimple(0.2, 30)), {}, mode="scan",
                                donate=False)(js, idx, val, y)
    got, _ = TE.make_train_fn(TR._make_logress_rule(simple(0.2, 30)), {},
                              mode="scan", device="cpu")(ts, idx, val, y)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(jst.weights),
                               rtol=RTOL, atol=ATOL)
