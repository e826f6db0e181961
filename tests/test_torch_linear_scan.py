"""The port's exact-scan plain version (hivemall_tpu_torch/kernels/
linear_scan.py, run on CPU tensors) against the JAX package's Pallas kernel
`pallas_scan_raw(..., interpret=True)`, for the eight rule families of
tests/pallas_cases.py.

Both sides get the same numpy inputs and the same warm state (carried with
`linear_state_from_numpy`). Tolerance rtol 1e-5 / atol 1e-6, the reference's
own (tests/test_pallas_kernels.py); `touched`, `step` are exact. The CUDA
kernel itself is held against this plain version on the card by
chip_smoke.py (phase "families")."""

import numpy as np
import pytest
import torch

from hivemall_tpu.core.engine import make_train_step as jax_train_step
from hivemall_tpu.core.state import init_linear_state as jax_init_state
from hivemall_tpu.kernels.linear_scan import pallas_scan_raw
from hivemall_tpu_torch.core.state import linear_state_from_numpy
from hivemall_tpu_torch.kernels.linear_scan import (KERNEL_FORMS, linear_scan,
                                                    linear_scan_reference,
                                                    make_pallas_scan_step)
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import regression as TR

from pallas_cases import generic_rules, make_block_data
from torch_cases import (PORT_RULES, RTOL, ATOL, assert_states_match,
                         jax_state_from_numpy, jax_state_numpy, warm_numpy)

def case_data(case, i, binary):
    """Blocks for each case: the reference's own block ("plain"), duplicate
    lanes ("dup"), B=300 rows with K=16 so the JAX chunk (4096//16 = 256)
    does not divide B ("ragged"), and a warm start ("warm")."""
    if case == "ragged":
        idx, val, y = make_block_data(B=300, K=16, D=512, seed=i)
        dims = 512
    else:
        idx, val, y = make_block_data(B=48, K=8, D=128, seed=i)
        dims = 128
    if case == "dup":
        # repeat lanes within rows: pairs, a triple, and a repeat of a pad
        # lane's neighbour
        idx[::2, 1] = idx[::2, 0]
        idx[1::4, 2] = idx[1::4, 0]
        idx[1::4, 3] = idx[1::4, 0]
        idx[3::6, 5] = idx[3::6, 4]
    if not binary:
        y = (y * 0.3).astype(np.float32)
    return idx, val, y, dims


@pytest.mark.parametrize("case", ["plain", "dup", "ragged", "warm"])
@pytest.mark.parametrize("i", range(8))
def test_plain_version_matches_pallas_interpret(i, case):
    jrule, hyper, binary = generic_rules()[i]
    rule = PORT_RULES[jrule.name]
    idx, val, y, dims = case_data(case, i, binary)
    if case == "warm":
        d0 = warm_numpy(rule, dims, seed=100 + i)
    else:
        d0 = jax_state_numpy(jax_init_state(
            dims, use_covariance=rule.use_covariance,
            slot_names=rule.slot_names, global_names=rule.global_names))
    jst, jloss = pallas_scan_raw(jrule, hyper, jax_state_from_numpy(d0), idx,
                                 val, y, interpret=True)
    st = linear_state_from_numpy(d0, device="cpu")
    got, loss = linear_scan(rule, hyper, st, torch.from_numpy(idx),
                            torch.from_numpy(val), torch.from_numpy(y))
    assert_states_match(got, jax_state_numpy(jst), loss.numpy(), jloss)


def test_updates_in_place():
    """The wrapper updates the state's own tables (the Pallas kernel aliases
    its tables in->out the same way)."""
    idx, val, y = make_block_data(B=16, K=8, D=64, seed=3)
    st = linear_state_from_numpy(warm_numpy(TC.AROW, 64, 1), device="cpu")
    w_before = st.weights
    got, _ = linear_scan(TC.AROW, {"r": 0.1}, st, torch.from_numpy(idx),
                         torch.from_numpy(val), torch.from_numpy(y))
    assert got.weights is w_before


def test_duplicate_lanes_sum_and_derive_w_last_lane_wins():
    """A row holding one feature twice: additive deltas sum; AdaGradRDA's
    derived w is set from the LAST lane's slots (the Pallas lane order)."""
    idx = np.array([[3, 3, 5, 64]], np.int32)  # 64 == D is a pad lane
    val = np.array([[1.0, 2.0, 0.5, 0.0]], np.float32)
    y = np.array([1.0], np.float32)
    st = linear_state_from_numpy(warm_numpy(TC.PA1, 64, 2), device="cpu")
    w0 = st.weights.clone()
    got, _ = linear_scan_reference(TC.PA1, {"c": 1.0}, st,
                                   torch.from_numpy(idx),
                                   torch.from_numpy(val), torch.from_numpy(y))
    score = float(w0[3] * 1.0 + w0[3] * 2.0 + w0[5] * 0.5)
    sq = 1.0 + 4.0 + 0.25
    eta = min(1.0, max(0.0, 1.0 - score) / sq)
    np.testing.assert_allclose(float(got.weights[3]),
                               float(w0[3]) + eta * 1.0 + eta * 2.0, rtol=1e-5)

    rda = {"eta": 0.1, "lambda": 1e-6, "scale": 100.0}
    d0 = warm_numpy(TC.ADAGRAD_RDA, 64, 3)
    st = linear_state_from_numpy(d0, device="cpu")
    got, _ = linear_scan_reference(TC.ADAGRAD_RDA, rda, st,
                                   torch.from_numpy(idx),
                                   torch.from_numpy(val), torch.from_numpy(y))
    jst, _ = pallas_scan_raw(generic_rules()[4][0], rda,
                             jax_state_from_numpy(d0), idx, val, y,
                             interpret=True)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(jst.weights),
                               rtol=RTOL, atol=ATOL)
    # the last lane (val 2.0) decides w[3]: recompute it by hand
    g = -1.0 * 2.0 * 100.0
    g_first = -1.0 * 1.0 * 100.0
    u = (d0["slots"]["sum_grad"][3] + g) * 100.0
    G = (d0["slots"]["sum_sqgrad"][3] + g * g) * 100.0
    t = 501.0
    sign = 1.0 if u > 0 else -1.0
    mog = sign * u / t - 1e-6
    w_last = 0.0 if mog < 0 else -sign * 0.1 * t * mog / np.sqrt(G)
    np.testing.assert_allclose(float(got.weights[3]), w_last, rtol=1e-5)
    # ...while the slots took both lanes' deltas
    np.testing.assert_allclose(
        float(got.slots["sum_grad"][3]),
        d0["slots"]["sum_grad"][3] + g_first + g, rtol=1e-6)


def test_sequential_dependence():
    """Two successive identical rows: the second sees the first's update
    (true sequential semantics, not batch-stale) — the port of
    tests/test_pallas_kernels.py::test_arow_pallas_sequential_dependence."""
    d = 16
    idx = np.array([[0, 1], [0, 1]], np.int32)
    val = np.ones((2, 2), np.float32)
    y = np.ones(2, np.float32)
    st = linear_state_from_numpy(jax_state_numpy(
        jax_init_state(d, use_covariance=True)), device="cpu")
    got, _ = linear_scan(TC.AROW, {"r": 0.1}, st, torch.from_numpy(idx),
                         torch.from_numpy(val), torch.from_numpy(y))
    w = got.weights.numpy()
    assert w[0] > 1.0 / 2.1 - 1e-6  # row 2 (margin 2/2.1 < 1) updated again
    step = jax_train_step(generic_rules()[2][0], {"r": 0.1}, mode="scan",
                          donate=False)
    ref, _ = step(jax_init_state(d, use_covariance=True), idx, val, y)
    np.testing.assert_allclose(w, np.asarray(ref.weights), rtol=RTOL)


def test_touched_marks_every_live_lane():
    """The Pallas path's `touched` marks every live lane of every row, even
    rows where the rule did not fire (unlike the engine's scan mode)."""
    idx = np.array([[1, 2, 8], [3, 4, 8]], np.int32)  # 8 == D: pad lane
    val = np.ones((2, 3), np.float32)
    y = np.array([1.0, 1.0], np.float32)
    d0 = jax_state_numpy(jax_init_state(8, use_covariance=True))
    d0["weights"][:5] = 5.0  # margin >> 1: AROW does not fire
    st = linear_state_from_numpy(d0, device="cpu")
    got, loss = linear_scan(TC.AROW, {"r": 0.1}, st, torch.from_numpy(idx),
                            torch.from_numpy(val), torch.from_numpy(y))
    np.testing.assert_array_equal(got.touched.numpy(),
                                  [0, 1, 1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(got.weights.numpy()[:5], 5.0)
    assert loss.tolist() == [0.0, 0.0]


def test_every_engine_rule_but_logress_has_a_kernel_form():
    """Every rule has a form in the CUDA kernel, logress too (its rule is
    built per call around its eta schedule, so PORT_RULES lacks it; the
    schedule's fields travel as its hyperparameters)."""
    assert set(KERNEL_FORMS) == set(PORT_RULES) | {"logress"}
    ids = sorted(v[0] for v in KERNEL_FORMS.values())
    assert ids == list(range(len(KERNEL_FORMS)))
    for name, (_, keys) in KERNEL_FORMS.items():
        assert len(keys) <= 4, name


def test_pallas_step_on_cpu_is_the_plain_version():
    """On the CPU the step runs the plain version for any rule (logress
    too); the CUDA library is never loaded."""
    from hivemall_tpu_torch.kernels import linear_scan as ls
    from hivemall_tpu_torch.ops.eta import fixed

    rule = TR._make_logress_rule(fixed(0.1))
    step = make_pallas_scan_step(rule, {}, device="cpu")
    idx, val, y = make_block_data(B=8, K=8, D=32, seed=0)
    st = linear_state_from_numpy(jax_state_numpy(jax_init_state(32)),
                                 device="cpu")
    st, loss = step(st, idx, val, (y * 0.5).astype(np.float32))
    assert st.step == 8 and np.isfinite(float(loss))
    assert ls._lib is None and ls.LAUNCHES["linear_scan"] == 0
