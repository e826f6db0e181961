"""The port's timing helpers (hivemall_tpu_torch/runtime/benchmark.py)
against the JAX package's (hivemall_tpu/runtime/benchmark.py), on the
CPU: the benchmark id law byte for byte for the same RandomState, and the
four contract cases of tests/test_benchmark_timing.py (budget-bounded,
chunks auto-ranging, the step-counter check that catches dropped
executions, and the engine epoch probed through its step counter) on the
port's torch state; the int32 wrap guard; the reference row loops timed
over the port's native library."""

import time

import numpy as np
import pytest
import torch

from hivemall_tpu.runtime import benchmark as JB
from hivemall_tpu_torch.runtime import benchmark as TB


@pytest.mark.parametrize("dims,shape,seed", [
    (1 << 22, (4096, 32), 0), (1 << 14, (1000, 8), 7), (1000, (3, 5, 7), 3),
    (1 << 20, (7,), 11)])
def test_make_workload_ids_byte_equal(dims, shape, seed):
    got = TB.make_workload_ids(np.random.RandomState(seed), shape, dims)
    want = JB.make_workload_ids(np.random.RandomState(seed), shape, dims)
    assert got.dtype == want.dtype == np.int32 and got.shape == shape
    assert got.tobytes() == want.tobytes()
    # the permutation is cached per dims: a second draw goes on from the
    # same stream, equal again
    rng_t, rng_j = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        assert (TB.make_workload_ids(rng_t, shape, dims).tobytes()
                == JB.make_workload_ids(rng_j, shape, dims).tobytes())
    assert dims in TB._PERMS


class _Counter:
    def __init__(self):
        self.n = torch.zeros((), dtype=torch.int64)


def test_counts_and_budget():
    def run(s):
        s.n += 1
        time.sleep(0.001)
        return s

    iters, secs, state = TB.honest_timed_loop(
        run, _Counter(), lambda s: float(s.n.item()), budget_s=0.05,
        expect_probe_delta=1)
    assert iters >= 1
    assert int(state.n) == iters
    assert secs >= 0.05


def test_chunk_growth_fast_backend():
    # near-zero per-iteration cost: chunks must double so iters >> budget
    iters, secs, _ = TB.honest_timed_loop(
        lambda s: s + 1, torch.zeros(()), lambda s: float(s.item()),
        budget_s=0.05, expect_probe_delta=1)
    assert iters > 64  # doubling happened


def test_probe_mismatch_raises():
    # a "runtime" that silently drops every other execution
    class Flaky:
        def __init__(self):
            self.n = torch.zeros(())
            self.calls = 0

    def run(s):
        s.calls += 1
        if s.calls % 2 == 0:
            s.n += 1  # half the executions "complete"
        return s

    with pytest.raises(RuntimeError, match="probe counter mismatch"):
        TB.honest_timed_loop(run, Flaky(), lambda s: float(s.n.item()),
                             budget_s=0.2, expect_probe_delta=1)


def test_engine_epoch_probe_is_step_counter():
    # the real usage shape: an epoch over staged blocks, probed through
    # the engine's own step counter, with the weights' sum fetched too
    from hivemall_tpu_torch.core.engine import make_epoch, make_train_fn
    from hivemall_tpu_torch.core.state import init_linear_state
    from hivemall_tpu_torch.models.classifier import AROW

    fn = make_train_fn(AROW, {"r": 0.1}, mode="minibatch", device="cpu")
    epoch = make_epoch(fn)
    rng = np.random.RandomState(0)
    n_blocks, batch, width, dims = 2, 8, 4, 64
    idx = torch.from_numpy(rng.randint(0, dims, size=(n_blocks, batch, width),
                                       dtype=np.int32))
    val = torch.ones((n_blocks, batch, width))
    lab = torch.from_numpy(np.sign(rng.randn(n_blocks, batch))
                           .astype(np.float32))

    state = init_linear_state(dims, use_covariance=True, device="cpu")
    state, _ = epoch(state, idx, val, lab)

    def probe(s):
        assert np.isfinite(s.weights.sum().item())
        return float(s.step)

    iters, secs, state = TB.honest_timed_loop(
        lambda s: epoch(s, idx, val, lab)[0], state, probe, budget_s=0.2,
        expect_probe_delta=n_blocks * batch)
    assert iters >= 1
    assert float(state.step) == (iters + 1) * n_blocks * batch


def test_int32_wrap_guard_matches_jax():
    """A counter within one chunk of 2^31 raises before timing; one that
    would cross it later returns early — in both packages alike."""
    near = float(2 ** 31 - 2)
    for mod in (TB, JB):
        with pytest.raises(RuntimeError, match="int32 wrap"):
            mod.honest_timed_loop(lambda s: s + 1, near, float,
                                  budget_s=5.0, expect_probe_delta=1)
    start = float(2 ** 31 - 1 - 100)
    got = TB.honest_timed_loop(lambda s: s + 1, start, float, budget_s=5.0,
                               expect_probe_delta=1)
    want = JB.honest_timed_loop(lambda s: s + 1, start, float, budget_s=5.0,
                                expect_probe_delta=1)
    assert got[0] == want[0] < 100 and got[2] == want[2]


def test_measure_reference_rowloops_runs_the_native_loops():
    from hivemall_tpu_torch import native

    rng = np.random.RandomState(1)
    dims = 1 << 12
    idx = TB.make_workload_ids(rng, (512, 8), dims)
    val = np.ones((512, 8), np.float32)
    lab = np.where(rng.rand(512) < 0.5, -1.0, 1.0).astype(np.float32)
    before = dict(native.CALLS)
    out = TB.measure_reference_rowloops(idx, val, lab, dims, budget_s=0.05)
    assert set(out) == {"arow_rows_per_sec", "fm_rows_per_sec"}
    assert all(v > 0 for v in out.values())
    assert native.CALLS["arow_reference_rowloop"] > \
        before["arow_reference_rowloop"]
    assert native.CALLS["fm_reference_rowloop"] > \
        before["fm_reference_rowloop"]
