"""The port's dedup plans and their ops (hivemall_tpu_torch/ops/scatter.py,
the planners of core/batch_update.py) against the JAX package's
(hivemall_tpu/ops/scatter.py, core/batch_update.py), on the CPU.

- Host planners: the port's plans equal the reference's ARRAY FOR ARRAY
  (int32 dtype, values, shapes) on the same numpy ids, and both refuse the
  same inputs.
- The frozen plan ABI: port-built plans pass the reference's
  `plan_abi_arrays`; the port's check rejects what the reference's does.
- Device ops: every staged op and every jit-built `dedup_*` op against the
  JAX op on the same inputs — the tests of tests/test_dedup_scatter.py and
  tests/test_batch_update.py:88-160, run through both packages. Integer
  results exact, float sums at the reference's rtol 1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.core import batch_update as JB
from hivemall_tpu.ops import scatter as JS
from hivemall_tpu_torch.core import batch_update as TB
from hivemall_tpu_torch.ops import scatter as TS

from torch_cases import bf16_values

DIMS = 97  # not a power of two
N = 512


def ids(seed, n=N, dims=DIMS, high=23, pad_frac=0.1):
    """Heavily duplicated ids with pad lanes (id == dims)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, high, size=n).astype(np.int32)
    idx[rng.rand(n) < pad_frac] = dims
    return idx


def assert_plans_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in JS.StagedDedupPlan._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert isinstance(a, np.ndarray), f
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def assert_block_plans_equal(got, want):
    for part in ("main", "tail"):
        a, b = getattr(got, part), getattr(want, part)
        assert (a is None) == (b is None), part
        if a is not None:
            assert_plans_equal(a, b)
    assert got.slot_bucket == want.slot_bucket


def to_dev(plan):
    return TS.staged_plan_to_device(plan, "cpu")


def to_jax(plan):
    return jax.tree_util.tree_map(jnp.asarray, plan)


# ------------------------------------------------------------ host planners

PLAN_CASES = {
    "random_with_pads": (ids(0), DIMS, None),
    "all_pad": (np.full(64, DIMS, np.int32), DIMS, None),
    "one_lane": (np.array([5], np.int32), DIMS, None),
    "one_pad_lane": (np.array([DIMS], np.int32), DIMS, None),
    "pinned_slots": (ids(1), DIMS, 320),
    "exact_fit": (np.arange(256, dtype=np.int32) % 300, 300, 256),
    "wide_ids": (ids(2, n=4096, dims=1 << 22, high=1 << 22), 1 << 22, None),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_build_staged_plan_equals_reference(case):
    idx, dims, slots = PLAN_CASES[case]
    assert_plans_equal(TS.build_staged_plan(idx, dims, slots),
                       JS.build_staged_plan(idx, dims, slots))


def test_plan_bucket_too_small_refused_by_both():
    idx = np.arange(40, dtype=np.int32)
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="plan bucket 32 < 40"):
            mod.build_staged_plan(idx, 64, slots=32)


def test_plan_slot_bucket_equals_reference():
    for n in list(range(0, 1100)) + [4095, 4096, 4097, 31517, 65536,
                                     100_000, 1 << 20]:
        assert TS.plan_slot_bucket(n) == JS.plan_slot_bucket(n), n
        assert TS.plan_slot_bucket(n, 64) == JS.plan_slot_bucket(n, 64), n


def test_pad_plan_equals_reference():
    plan_t = TS.build_staged_plan(ids(3), DIMS)
    plan_j = JS.build_staged_plan(ids(3), DIMS)
    u = plan_t.rep.shape[0]
    for slots in (u, u + 1, u + 64):
        assert_plans_equal(TS.pad_plan(plan_t, slots, DIMS),
                           JS.pad_plan(plan_j, slots, DIMS))
    for mod, plan in ((TS, plan_t), (JS, plan_j)):
        with pytest.raises(ValueError, match="cannot shrink"):
            mod.pad_plan(plan, u - 1, DIMS)


@pytest.mark.parametrize("rows,batch,slots", [(53, 8, None), (48, 8, None),
                                              (53, 8, 512), (5, 8, None),
                                              (64, 1, None)])
def test_stage_block_plans_equal_reference(rows, batch, slots):
    rng = np.random.RandomState(rows + batch)
    idx = rng.randint(0, 64, size=(rows, 4)).astype(np.int32)
    idx[::3, -1] = 64
    got = TB.stage_block_plans(idx, batch, 64, slots=slots)
    want = JB.stage_block_plans(idx, batch, 64, slots=slots)
    assert_block_plans_equal(got, want)
    assert (got.tail is None) == (rows % min(batch, rows) == 0)


def test_stage_epoch_plans_equal_reference_and_refuse_a_tail():
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 64, size=(3, 16, 4)).astype(np.int32)
    assert_block_plans_equal(TB.stage_epoch_plans(idx, 8, 64),
                             JB.stage_epoch_plans(idx, 8, 64))
    for mod in (TB, JB):
        with pytest.raises(ValueError, match="divisible by the batch size"):
            mod.stage_epoch_plans(idx[:, :15], 8, 64)


# ---------------------------------------------------------------- plan ABI

def test_port_plans_pass_the_reference_abi_check():
    single = TS.build_staged_plan(ids(4), DIMS)
    stacked = TB.stage_block_plans(ids(4).reshape(64, 8), 16, DIMS).main
    assert TS.PLAN_ABI_VERSION == JS.PLAN_ABI_VERSION == 1
    for plan, st in ((single, False), (stacked, True)):
        want = JS.plan_abi_arrays(plan, stacked=st)
        got = TS.plan_abi_arrays(plan, stacked=st)
        for a, b in zip(got, want):
            assert a is b


@pytest.mark.parametrize("bad", ["dtype", "rank", "contiguity", "device"])
def test_port_abi_check_rejects_what_the_reference_rejects(bad):
    plan = TS.build_staged_plan(ids(5), DIMS)
    if bad == "dtype":
        plan = plan._replace(rep=plan.rep.astype(np.int64))
    elif bad == "rank":
        plan = plan._replace(starts=plan.starts[None])
    elif bad == "contiguity":
        plan = plan._replace(order=np.repeat(plan.order, 2)[::2])
    else:
        plan = plan._replace(ends=torch.from_numpy(plan.ends))
    err = ValueError if bad in ("rank", "contiguity") else TypeError
    for mod in (TS, JS):
        with pytest.raises(err):
            mod.plan_abi_arrays(plan)


# ----------------------------------------------------------- staged device ops

@pytest.mark.parametrize("pass_live", [False, True])
def test_staged_ops_match_jax(pass_live):
    """One plan, every staged op: gather (fill on the dropped slots),
    broadcast, [N] and [N, k] segment totals, averaged and raw adds, the
    derive_w set and the touch max."""
    rng = np.random.RandomState(7)
    idx = ids(6)
    plan_np = TS.build_staged_plan(idx, DIMS)
    tp, jp = to_dev(plan_np), to_jax(plan_np)
    live = int(np.sum(plan_np.rep < DIMS)) if pass_live else None
    u = plan_np.rep.shape[0]
    table = rng.randn(DIMS).astype(np.float32)

    for fill in (0.0, 1.0):
        got = TS.staged_gather(torch.from_numpy(table), tp, fill, live)
        want = JS.staged_gather(jnp.asarray(table), jp, fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    uniq = rng.randn(u).astype(np.float32)
    np.testing.assert_array_equal(
        TS.broadcast_lanes(torch.from_numpy(uniq), tp).numpy(),
        np.asarray(JS.broadcast_lanes(jnp.asarray(uniq), jp)))

    col = rng.randn(N).astype(np.float32)
    cols = rng.randn(N, 3).astype(np.float32)
    cols[:, -1] = (rng.rand(N) < 0.6)  # a 0/1 count column
    for c in (col, cols):
        got = TS.staged_segment_totals(tp, torch.from_numpy(c)).numpy()
        want = np.asarray(JS.staged_segment_totals(jp, jnp.asarray(c)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    counts_t = TS.staged_segment_totals(tp, torch.from_numpy(cols))[:, -1]
    counts_j = JS.staged_segment_totals(jp, jnp.asarray(cols))[:, -1]
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))

    sums = TS.staged_segment_totals(tp, torch.from_numpy(col))
    sums_j = JS.staged_segment_totals(jp, jnp.asarray(col))
    for denom_t, denom_j in ((None, None), (counts_t, counts_j)):
        got = TS.staged_scatter_add(torch.from_numpy(table.copy()), tp,
                                    sums, denom_t, live)
        want = JS.staged_scatter_add(jnp.asarray(table), jp, sums_j, denom_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    vals = rng.randn(u).astype(np.float32)
    keep = np.asarray(counts_j) > 0
    got = TS.staged_scatter_set(torch.from_numpy(table.copy()), tp,
                                torch.from_numpy(vals),
                                torch.from_numpy(keep), live)
    want = JS.staged_scatter_set(jnp.asarray(table), jp, jnp.asarray(vals),
                                 jnp.asarray(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    touched = (rng.rand(DIMS) < 0.3).astype(np.int8)
    got = TS.staged_touch_max(torch.from_numpy(touched.copy()), tp,
                              counts_t, live)
    want = JS.staged_touch_max(jnp.asarray(touched), jp, counts_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_staged_scatter_add_bf16_casts_before_the_add():
    """On a bf16 table the sums are cast to bf16 and then added (the JAX
    batch backend's order), equal to JAX's result bit for bit."""
    rng = np.random.RandomState(8)
    plan_np = TS.build_staged_plan(ids(9), DIMS)
    table = bf16_values(rng.randn(DIMS))
    sums = rng.randn(plan_np.rep.shape[0]).astype(np.float32) * 1e-2
    denom = rng.randint(0, 4, size=sums.shape).astype(np.float32)
    got = TS.staged_scatter_add(
        torch.from_numpy(table).to(torch.bfloat16), to_dev(plan_np),
        torch.from_numpy(sums), torch.from_numpy(denom))
    want = JS.staged_scatter_add(jnp.asarray(table, jnp.bfloat16),
                                 to_jax(plan_np), jnp.asarray(sums),
                                 jnp.asarray(denom))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_staged_plan_reduces_like_numpy_and_all_pad_is_noop():
    """The reference's numpy-reduction pin, and a chunk of pad lanes only
    writes nothing (no live slot)."""
    rng = np.random.RandomState(7)
    d = 100
    idx = rng.randint(0, d, size=400).astype(np.int32)
    idx[::7] = d
    upd = rng.randn(400).astype(np.float32)
    tp = to_dev(TS.build_staged_plan(idx, d))
    out = TS.staged_scatter_add(torch.zeros(d), tp, TS.staged_segment_totals(
        tp, torch.from_numpy(upd)))
    expect = np.zeros(d, np.float32)
    np.add.at(expect, idx[idx < d], upd[idx < d])
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-5)

    pads = to_dev(TS.build_staged_plan(np.full(64, d, np.int32), d))
    sums = TS.staged_segment_totals(pads, torch.ones(64))
    table = torch.arange(d, dtype=torch.float32)
    TS.staged_scatter_add(table, pads, sums)
    TS.staged_scatter_set(table, pads, sums, sums > 0)
    np.testing.assert_array_equal(table.numpy(), np.arange(d))
    assert TS.staged_gather(table, pads, fill=1.0).eq(1.0).all()


def test_staged_segment_totals_f64_prefix_keeps_large_columns_exact():
    """A same-signed column whose chunk prefix dwarfs each slot's sum
    (AdaGrad's squared gradients at scale 100: up to 1e4 a lane, a prefix
    of ~2e8): the port's totals hold the exact per-slot sums to 1e-6
    (the f64 prefix's own rounding), where the JAX package's f32 prefix
    is off by whole units."""
    rng = np.random.RandomState(11)
    idx = rng.randint(0, 1 << 20, size=65536).astype(np.int32)
    col = (1e4 * rng.rand(65536) ** 2).astype(np.float32)
    plan = TS.build_staged_plan(idx, 1 << 20)
    got = TS.staged_segment_totals(to_dev(plan), torch.from_numpy(col))
    exact = np.zeros(plan.rep.shape[0])
    np.add.at(exact, plan.lane_seg, col.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6, atol=1e-6)
    f32 = np.asarray(JS.staged_segment_totals(to_jax(plan), jnp.asarray(col)))
    assert np.abs(f32 - exact).max() > 1.0


# ------------------------------------------------- jit-built plan (dedup_*)

def dedup_case(seed, pad_frac=0.1):
    idx = ids(seed, pad_frac=pad_frac)
    upd = np.random.RandomState(seed + 100).randn(N).astype(np.float32)
    return idx, upd


def both_plans(idx):
    tplan = TS.make_dedup_plan(torch.from_numpy(idx), DIMS)
    jplan = JS.make_dedup_plan(jnp.asarray(idx), DIMS)
    return tplan, jplan


def test_dedup_plan_equals_reference():
    tplan, jplan = both_plans(ids(10))
    for f in ("order", "seg", "rep"):
        np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                      np.asarray(getattr(jplan, f)),
                                      err_msg=f)
    rep = tplan.rep.numpy().astype(np.int64)
    assert (np.diff(rep) > 0).all()  # strictly ascending


@pytest.mark.parametrize("lanes", [1, 5])
def test_dedup_scatter_add_matches_jax(lanes):
    idx, _ = dedup_case(1)
    rng = np.random.RandomState(7)
    upd = rng.randn(N, lanes).astype(np.float32).squeeze(-1) if lanes == 1 \
        else rng.randn(N, lanes).astype(np.float32)
    shape = (DIMS,) + upd.shape[1:]
    tplan, jplan = both_plans(idx)
    got = TS.dedup_scatter_add(torch.zeros(shape), tplan,
                               torch.from_numpy(upd))
    want = JS.dedup_scatter_add(jnp.zeros(shape, jnp.float32), jplan,
                                jnp.asarray(upd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    direct = np.zeros(shape, np.float32)
    np.add.at(direct, idx[idx < DIMS], upd[idx < DIMS])
    np.testing.assert_allclose(got.numpy(), direct, rtol=1e-5, atol=1e-5)


def test_dedup_counts_exact_and_averaged_match_jax():
    idx, upd = dedup_case(2)
    fired = (np.random.RandomState(3).rand(N) < 0.7).astype(np.float32)
    tplan, jplan = both_plans(idx)
    counts_t = TS.dedup_counts(tplan, torch.from_numpy(fired))
    counts_j = JS.dedup_counts(jplan, jnp.asarray(fired))
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    upd_f = upd * fired
    got = TS.dedup_scatter_add(torch.zeros(DIMS), tplan,
                               torch.from_numpy(upd_f), denom=counts_t)
    want = JS.dedup_scatter_add(jnp.zeros((DIMS,), jnp.float32), jplan,
                                jnp.asarray(upd_f), denom=counts_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_dedup_touch_max_matches_jax():
    idx, _ = dedup_case(4)
    fired = (np.random.RandomState(5).rand(N) < 0.3).astype(np.float32)
    tplan, jplan = both_plans(idx)
    start = (np.random.RandomState(6).rand(DIMS) < 0.2).astype(np.int8)
    got = TS.dedup_touch_max(torch.from_numpy(start.copy()), tplan,
                             torch.from_numpy(fired))
    want = JS.dedup_touch_max(jnp.asarray(start), jplan, jnp.asarray(fired))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dedup_scatter_set_uniform_matches_jax():
    idx, _ = dedup_case(6)
    per_feature = np.random.RandomState(8).randn(DIMS + 1).astype(np.float32)
    vals = per_feature[np.minimum(idx, DIMS)]
    keep = idx % 3 != 0  # some features not fired
    table0 = np.random.RandomState(9).randn(DIMS).astype(np.float32)
    tplan, jplan = both_plans(idx)
    got = TS.dedup_scatter_set_uniform(torch.from_numpy(table0.copy()),
                                       tplan, torch.from_numpy(vals),
                                       torch.from_numpy(keep))
    want = JS.dedup_scatter_set_uniform(jnp.asarray(table0), jplan,
                                        jnp.asarray(vals), jnp.asarray(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dedup_all_padding_is_noop():
    idx = np.full(N, DIMS, np.int32)
    tplan, _ = both_plans(idx)
    out = TS.dedup_scatter_add(torch.zeros(DIMS), tplan, torch.ones(N))
    assert float(out.abs().sum()) == 0.0
