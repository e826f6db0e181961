"""The port's sorted-id gather / scatter-add (hivemall_tpu_torch/ops/
mxu_scatter.py) and the `-mxu_scatter` backends built on it (core/engine.py
update_backend="mxu", models/fm.py, models/ffm.py, fit_linear) against the
JAX package's (hivemall_tpu/ops/mxu_scatter.py and its backends), on the
CPU, case for case of tests/test_mxu_scatter.py.

Tolerances, the reference's own: plans array-equal; gather exact (each
output is one table entry); scatter-add atol 1e-4 (2e-4 in the random
sweep), duplicate sums reassociating (the port sums each run of equal ids
in float64 and rounds once, XLA in f32 in its own order); the engine
backend atol 2e-5, FM and FFM atol 3e-6, fit_linear atol 1e-5; touched
and step exact. numpy's assert_allclose adds rtol 1e-7 of the expected
value to each atol, under one float32 ulp; where an accumulator reaches
~1e4 (AdaGradRDA's sum_sqgrad at scale 100) two differently ordered f32
sums part by one or two ulps, so the engine case states rtol 2^-22 (two
ulps) beside its atol. The JAX package's own xla and mxu steps part by
one ulp there on the same block.

Invalid ids deviate from wraparound indexing ON PURPOSE in both packages:
negative ids are treated like >= E (gather 0.0, scatter drop)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.ops import mxu_scatter as JM
from hivemall_tpu_torch.ops import mxu_scatter as TM

from pallas_cases import generic_rules
from torch_cases import (PORT_RULES, assert_ffm_match, assert_fm_match,
                         ffm_hypers, fm_hypers, jax_ffm_numpy, jax_ffm_state,
                         jax_fm_numpy, jax_fm_state, jax_state_numpy,
                         warm_ffm_numpy, warm_fm_numpy, warm_numpy)


def _mask_ref_ids(ids: np.ndarray, e: int) -> jnp.ndarray:
    return jnp.asarray(np.where((ids >= 0) & (ids < e), ids, e))


def _plans(ids, e, chunk):
    jp = JM.make_plan(jnp.asarray(ids), e, chunk=chunk)
    tp = TM.make_plan(torch.from_numpy(ids), e, chunk=chunk)
    assert tp.sid.dtype == tp.spos.dtype == torch.int32
    np.testing.assert_array_equal(tp.sid.numpy(), np.asarray(jp.sid))
    np.testing.assert_array_equal(tp.spos.numpy(), np.asarray(jp.spos))
    assert (tp.n, tp.n_entries, tp.chunk) == (jp.n, jp.n_entries, jp.chunk)
    return jp, tp


def _both(t, ids, upd, jp, tp, wr, atol):
    """Port gather / scatter_add against the plain `.at[]` reference and
    against the JAX module, on one table."""
    e = t.shape[0]
    ref_ids = _mask_ref_ids(ids, e)
    jt = jnp.asarray(t)
    g = TM.gather(torch.from_numpy(t), tp, window_rows=wr).numpy()
    np.testing.assert_array_equal(
        g, np.asarray(jt.at[ref_ids].get(mode="fill", fill_value=0.0)))
    np.testing.assert_array_equal(
        g, np.asarray(JM.gather(jt, jp, window_rows=wr)))
    s = TM.scatter_add(torch.from_numpy(t), torch.from_numpy(ids),
                       torch.from_numpy(upd), tp, window_rows=wr).numpy()
    np.testing.assert_allclose(
        s, np.asarray(jt.at[ref_ids].add(jnp.asarray(upd), mode="drop")),
        atol=atol)
    np.testing.assert_allclose(
        s, np.asarray(JM.scatter_add(jt, jnp.asarray(ids), jnp.asarray(upd),
                                     jp, window_rows=wr)), atol=atol)
    return g, s


@pytest.mark.parametrize("n,c,chunk,wr", [
    (4096, 1, 256, 64),
    (4096, 2, 256, None),      # auto window
    (5000, 4, 256, None),      # N not a chunk multiple
    (64, 8, 256, 16),          # N < chunk
])
def test_gather_scatter_parity(n, c, chunk, wr):
    rng = np.random.RandomState(0)
    e = 1 << 14
    ids = rng.randint(0, e, size=n).astype(np.int32)
    ids[::17] = e + rng.randint(0, 5, size=ids[::17].shape)  # oob
    ids[::23] = -1                                           # negative
    table = rng.randn(e, c).astype(np.float32)
    upd = rng.randn(n, c).astype(np.float32)
    t = table if c > 1 else table[:, 0]
    u = upd if c > 1 else upd[:, 0]
    jp, tp = _plans(ids, e, chunk)
    g, s = _both(t, ids, u, jp, tp, wr, 1e-4)
    assert g.dtype == s.dtype == np.float32 and g.shape == u.shape


def test_scatter_fewer_update_columns():
    """kl < c scatters only the leading lanes (scatter_rows_flat protocol —
    FM's pad lanes stay untouched)."""
    rng = np.random.RandomState(1)
    e, n, c, kl = 1 << 10, 512, 8, 6
    ids = rng.randint(0, e, size=n).astype(np.int32)
    table = rng.randn(e, c).astype(np.float32)
    upd = rng.randn(n, kl).astype(np.float32)
    jp, tp = _plans(ids, e, 128)
    s = TM.scatter_add(torch.from_numpy(table), torch.from_numpy(ids),
                       torch.from_numpy(upd), tp).numpy()
    flat_idx = jnp.asarray(ids)[:, None] * c + jnp.arange(kl)
    ref = np.asarray(jnp.asarray(table).reshape(-1)
                     .at[flat_idx].add(jnp.asarray(upd), mode="drop")
                     .reshape(e, c))
    np.testing.assert_allclose(s, ref, atol=1e-4)
    np.testing.assert_array_equal(s[:, kl:], table[:, kl:])
    js = np.asarray(JM.scatter_add(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(upd), jp))
    np.testing.assert_allclose(s, js, atol=1e-4)


def test_residual_path_adversarial_spans():
    """Clustered ids whose chunk span exceeds the JAX window (its residual
    pass): the port has no window, so the same ids give the same answers
    at any window_rows."""
    rng = np.random.RandomState(2)
    e = 1 << 14
    ids = np.concatenate([
        np.zeros(100, np.int32), np.full(100, e - 1, np.int32),
        rng.randint(0, e, 56).astype(np.int32)])
    table = rng.randn(e).astype(np.float32)
    upd = rng.randn(ids.size).astype(np.float32)
    jp, tp = _plans(ids, e, 256)
    g, s = _both(table, ids, upd, jp, tp, 128, 1e-4)
    g2, s2 = _both(table, ids, upd, jp, tp, None, 1e-4)
    assert np.array_equal(g, g2) and np.array_equal(s, s2)


def test_all_invalid_block():
    e = 1 << 10
    table = np.random.RandomState(3).randn(e).astype(np.float32)
    ids = np.full(128, e, np.int32)
    jp, tp = _plans(ids, e, 64)
    assert (TM.gather(torch.from_numpy(table), tp).numpy() == 0).all()
    s = TM.scatter_add(torch.from_numpy(table), torch.from_numpy(ids),
                       torch.ones(128), tp).numpy()
    np.testing.assert_array_equal(s, table)


def test_duplicate_heavy_ids():
    """Zipf-ish duplication (the CTR regime the engine actually sees):
    integer counts sum exactly."""
    rng = np.random.RandomState(4)
    e, n = 1 << 12, 1 << 14
    ids = (rng.zipf(1.3, size=n) % e).astype(np.int32)
    jp, tp = _plans(ids, e, 512)
    s = TM.scatter_add(torch.zeros(e), torch.from_numpy(ids), torch.ones(n),
                       tp).numpy()
    np.testing.assert_array_equal(s, np.bincount(ids, minlength=e)
                                  .astype(np.float32))


def test_random_shape_sweep():
    """Seeded sweep over (E, c, N, chunk, window) combinations and id
    regimes (uniform, duplicate-heavy, clustered), with oob sprinkled in:
    plans equal, gather exact, scatter atol 2e-4."""
    rng = np.random.RandomState(42)
    for trial in range(10):
        e = int(2 ** rng.randint(8, 15))
        c = int(2 ** rng.randint(0, 4))
        n = int(rng.randint(50, 5000))
        chunk = int(2 ** rng.randint(5, 10))
        wr = [None, 64, 256][rng.randint(3)]
        regime = trial % 3
        if regime == 0:
            ids = rng.randint(0, e, size=n)
        elif regime == 1:
            ids = (rng.zipf(1.5, size=n) % e)
        else:  # clustered
            ids = np.concatenate([
                rng.randint(0, max(2, e // 64), size=n // 2),
                rng.randint(max(1, e - 64), e, size=n - n // 2)])
        ids = ids.astype(np.int32)
        ids[:: 13] = e + 1  # oob
        table = rng.randn(e, c).astype(np.float32)
        upd = rng.randn(n, c).astype(np.float32)
        jp, tp = _plans(ids, e, chunk)
        _both(table, ids, upd, jp, tp, wr, 2e-4)


def test_two_runs_bit_equal_and_bf16_tables():
    """The scatter has no float atomics: two runs are bit-equal (on the
    card as here). A bf16 table is read exactly and written once per id,
    rounded to bf16 once, as the JAX module casts back."""
    rng = np.random.RandomState(6)
    e, n = 1 << 10, 4096
    ids = (rng.zipf(1.2, size=n) % e).astype(np.int32)
    upd = rng.randn(n, 2).astype(np.float32)
    table = rng.randn(e, 2).astype(np.float32)
    _, tp = _plans(ids, e, 1024)
    a = TM.scatter_add(torch.from_numpy(table), torch.from_numpy(ids),
                       torch.from_numpy(upd), tp)
    b = TM.scatter_add(torch.from_numpy(table), torch.from_numpy(ids),
                       torch.from_numpy(upd), tp)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    tb = torch.from_numpy(table).bfloat16()
    g = TM.gather(tb, tp)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), tb.float()[torch.from_numpy(
        ids).long()].numpy())
    s = TM.scatter_add(tb, torch.from_numpy(ids), torch.from_numpy(upd), tp)
    assert s.dtype == torch.bfloat16
    js = JM.scatter_add(jnp.asarray(tb.float().numpy(), jnp.bfloat16),
                        jnp.asarray(ids), jnp.asarray(upd),
                        JM.make_plan(jnp.asarray(ids), e))
    np.testing.assert_allclose(s.float().numpy(),
                               np.asarray(js, np.float32), rtol=2 ** -7,
                               atol=1e-2)


def test_module_refusals_match_jax():
    """The lane protocol's ValueError, the plan's E, and the argument
    checks of the JAX signature."""
    ids = np.arange(16, dtype=np.int32)
    jp, tp = _plans(ids, 64, 8)
    for mod, plan, mk in ((TM, tp, torch.zeros), (JM, jp, jnp.zeros)):
        with pytest.raises(ValueError, match="power of two"):
            mod.gather(mk((64, 3)), plan)
        with pytest.raises(ValueError, match="power of two"):
            mod.gather(mk((64, 256)), plan)
        with pytest.raises(ValueError, match="plan built for E=64"):
            mod.gather(mk((32,)), plan)
        with pytest.raises(ValueError, match="power of two"):
            mod.scatter_add(mk((64, 6)), ids, mk((16, 6)), plan)
    assert TM.pad_cols(5) == JM.pad_cols(5) == 8
    assert [TM.pad_cols(n) for n in range(1, 18)] == \
        [JM.pad_cols(n) for n in range(1, 18)]
    t = torch.zeros(64)
    for p in (None, "high", "highest"):
        TM.gather(t, tp, precision=p)
    with pytest.raises(ValueError, match="precision"):
        TM.gather(t, tp, precision="fast")
    with pytest.raises(ValueError, match="window_rows"):
        TM.gather(t, tp, window_rows=-1)
    with pytest.raises(ValueError, match="update columns"):
        TM.scatter_add(torch.zeros(64, 2), ids, torch.zeros(16, 4), tp)
    with pytest.raises(ValueError, match="plan built for 16 ids"):
        TM.scatter_add(t, ids[:8], torch.zeros(8), tp)


# --- the backends ------------------------------------------------------------

ENGINE_RTOL = 2.0 ** -22  # two float32 ulps (module docstring)


def _engine_states(rule, d, track, seed):
    from hivemall_tpu.core.engine import DELTA_SLOT
    from hivemall_tpu.core.state import init_linear_state as jinit
    from hivemall_tpu_torch.core.state import linear_state_from_numpy

    st = jinit(d, use_covariance=rule.use_covariance,
               slot_names=rule.slot_names, global_names=rule.global_names)
    rng = np.random.RandomState(seed)
    st = st.replace(weights=jnp.asarray(0.1 * rng.randn(d), jnp.float32))
    if rule.use_covariance:
        st = st.replace(covars=jnp.asarray(rng.uniform(0.5, 1.5, d),
                                           jnp.float32))
    if track:
        st = st.replace(slots={**st.slots,
                               DELTA_SLOT: jnp.zeros((d,), jnp.float32)})
    return st, jax_state_numpy(st)


@pytest.mark.parametrize("i", range(len(generic_rules())),
                         ids=[r[0].name for r in generic_rules()])
def test_engine_minibatch_backend_parity(i):
    """The port's mxu minibatch step against the JAX mxu step and against
    the port's xla step, for each rule family of the engine tests (derive_w
    and Welford globals included), averaged or summed, with and without
    the MIX delta clock: weights / covars / slots / touched / step / loss,
    at atol 2e-5 and rtol ENGINE_RTOL (the module docstring)."""
    from hivemall_tpu.core.engine import make_train_fn as jmake
    from hivemall_tpu_torch.core.engine import make_train_fn
    from hivemall_tpu_torch.core.state import (linear_state_from_numpy,
                                               linear_state_to_numpy)

    jrule, hyper, binary = generic_rules()[i]
    rule = PORT_RULES[jrule.name]
    rng = np.random.RandomState(0)
    d, b, k = 1 << 12, 512, 8
    idx = rng.randint(0, d, size=(b, k)).astype(np.int32)
    idx[0, -2:] = d  # pad lanes
    idx[1::7, 1] = idx[1::7, 0]  # a feature repeated inside rows
    val = rng.rand(b, k).astype(np.float32)
    lab = np.sign(rng.randn(b)).astype(np.float32)
    if not binary:
        lab = (lab * 0.3 + 0.1 * rng.randn(b)).astype(np.float32)
    for avg in (True, False):
        for track in (False, True):
            jst, host = _engine_states(jrule, d, track, i)
            kw = dict(mode="minibatch", mini_batch_average=avg,
                      track_deltas=track)
            sj, lj = jax.jit(jmake(jrule, hyper, **kw,
                                   update_backend="mxu"))(
                jst, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(lab))
            sm, lm = make_train_fn(rule, hyper, **kw, update_backend="mxu",
                                   device="cpu")(
                linear_state_from_numpy(host, "cpu"), idx, val, lab)
            sx, lx = make_train_fn(rule, hyper, **kw, device="cpu")(
                linear_state_from_numpy(host, "cpu"), idx, val, lab)
            label = (rule.name, avg, track)
            got, want = linear_state_to_numpy(sm), jax_state_numpy(sj)
            other = linear_state_to_numpy(sx)  # the port's xla step

            def close(x, y, what):
                np.testing.assert_allclose(x, y, atol=2e-5, rtol=ENGINE_RTOL,
                                           err_msg=f"{label} {what}")

            assert np.allclose(float(lm), float(lj), rtol=1e-5), label
            assert np.allclose(float(lm), float(lx), rtol=1e-5), label
            for ref in (want, other):
                close(got["weights"], ref["weights"], "weights")
                if rule.use_covariance:
                    close(got["covars"], ref["covars"], "covars")
                for s in want["slots"]:
                    close(got["slots"][s], ref["slots"][s], s)
                for g in want["globals"]:
                    np.testing.assert_allclose(got["globals"][g],
                                               ref["globals"][g], rtol=1e-5,
                                               err_msg=f"{label} {g}")
                np.testing.assert_array_equal(got["touched"], ref["touched"])
                assert int(got["step"]) == int(ref["step"]) == b


def test_arow_backends_fire_the_same_rows_from_a_common_state():
    """One AROW minibatch step of each backend from a common state gives
    the same `touched` and `step`, exactly: both score a row from the same
    gathered weights (the engine's row context and the mxu step's packed
    gather), so the same rows fire. chip_smoke.py's phase mxu holds the
    card to this on each of main's blocks. Here: 8 seeded head-heavy
    blocks (benchmark ids) from a warm state with nothing touched and
    weights large enough that some rows clear the margin; the mxu step's
    state carries on to the next block."""
    from hivemall_tpu_torch.core.engine import make_train_fn
    from hivemall_tpu_torch.core.state import (linear_state_from_numpy,
                                               linear_state_to_numpy)
    from hivemall_tpu_torch.runtime.benchmark import make_workload_ids

    rule, hyper = PORT_RULES["arow"], {"r": 0.1}
    d, b, k = 1 << 12, 512, 32
    host = warm_numpy(rule, d, seed=3)
    host["weights"] *= 5.0
    host["touched"][:] = 0
    steps = {be: make_train_fn(rule, hyper, mode="minibatch",
                               update_backend=be, device="cpu")
             for be in ("mxu", "xla")}
    st = linear_state_from_numpy(host, "cpu")
    touched = 0
    for seed in range(8):
        rng = np.random.RandomState(seed)
        idx = make_workload_ids(rng, (b, k), d).astype(np.int32)
        val = (2.0 * rng.rand(b, k)).astype(np.float32)
        lab = np.where(rng.rand(b) < 0.5, -1.0, 1.0).astype(np.float32)
        got = {be: linear_state_to_numpy(
                   fn(linear_state_from_numpy(linear_state_to_numpy(st),
                                              "cpu"), idx, val, lab)[0])
               for be, fn in steps.items()}
        np.testing.assert_array_equal(got["mxu"]["touched"],
                                      got["xla"]["touched"],
                                      err_msg=f"block {seed}")
        assert int(got["mxu"]["step"]) == int(got["xla"]["step"]) \
            == 500 + (seed + 1) * b
        new = int(got["mxu"]["touched"].sum())
        assert new > touched, f"block {seed} fired no new feature"
        touched = new
        st = linear_state_from_numpy(got["mxu"], "cpu")
    assert touched < d  # some features never fired


def test_engine_backend_validation():
    from hivemall_tpu_torch.core.engine import make_train_fn
    from hivemall_tpu_torch.models.classifier import AROW

    with pytest.raises(ValueError, match="minibatch"):
        make_train_fn(AROW, {"r": 0.1}, mode="scan", update_backend="mxu",
                      device="cpu")
    with pytest.raises(ValueError, match="feature_shard"):
        make_train_fn(AROW, {"r": 0.1}, feature_shard=("x", "y", 4),
                      update_backend="mxu", device="cpu")
    with pytest.raises(ValueError, match="update_backend"):
        make_train_fn(AROW, {"r": 0.1}, update_backend="cuda", device="cpu")


@pytest.mark.parametrize("k_f,avg,adareg", [
    (5, True, False), (5, False, False), (5, True, True),
    (7, True, False),  # k=7: the counts lane does not fit -> apart
    (7, False, True), (6, True, False)])
def test_fm_backend_parity(k_f, avg, adareg):
    """FM minibatch mxu in both packages, and against the port's xla step:
    averaged / summed x plain / adareg, validation rows masked, the
    pad-lane-zero invariant, and the no-counts-lane (k=7) split."""
    from hivemall_tpu.models.fm import make_fm_step as jmake
    from hivemall_tpu_torch.models import fm as TF

    rng = np.random.RandomState(1)
    d, b, k = 1 << 12, 256, 8
    idx = rng.randint(0, d, size=(b, k)).astype(np.int32)
    idx[0, -2:] = d
    idx[3::5, 2] = idx[3::5, 0]
    val = rng.rand(b, k).astype(np.float32)
    lab = np.sign(rng.randn(b)).astype(np.float32)
    va = (rng.rand(b) < 0.1).astype(np.float32)
    jh, th = fm_hypers(factors=k_f, adareg=adareg)
    warm = warm_fm_numpy(d, th, seed=2)
    sj, lj = jmake(jh, mode="minibatch", mini_batch_average=avg,
                   update_backend="mxu")(jax_fm_state(warm), idx, val, lab,
                                         va)
    sm, lm = TF.make_fm_step(th, mode="minibatch", mini_batch_average=avg,
                             update_backend="mxu", device="cpu")(
        TF.fm_state_from_numpy(warm, "cpu"), idx, val, lab, va)
    assert_fm_match(sm, jax_fm_numpy(sj), rtol=0, atol=3e-6)
    assert np.allclose(float(lm), float(lj), rtol=1e-5)
    assert (sm.v.numpy()[:, th.factors:] == 0).all(), "pad lanes stay zero"
    sx, lx = TF.make_fm_step(th, mode="minibatch", mini_batch_average=avg,
                             device="cpu")(
        TF.fm_state_from_numpy(warm, "cpu"), idx, val, lab, va)
    assert_fm_match(sm, TF.fm_state_to_numpy(sx), rtol=0, atol=3e-6)


def test_fm_backend_validation():
    from hivemall_tpu.models.fm import make_fm_step as jmake
    from hivemall_tpu_torch.models import fm as TF

    for factors, mode, kw, match in (
            (8, "minibatch", {}, "pad lane"),
            (5, "scan", {}, "minibatch"),
            (5, "minibatch", {"pack_w": False}, "pack_w=True"),
            (17, "minibatch", {}, "power-of-two padded_factors")):
        jh, th = fm_hypers(factors=factors)
        with pytest.raises(ValueError, match=match):
            jmake(jh, mode=mode, update_backend="mxu", **kw)
        with pytest.raises(ValueError, match=match):
            TF.make_fm_step(th, mode=mode, update_backend="mxu",
                            device="cpu", **kw)


def _ffm_block(hyper, b, k, seed, zero_lanes=True):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, hyper.num_features, size=(b, k)).astype(np.int32)
    val = ((rng.rand(b, k) > 0.2).astype(np.float32) if zero_lanes
           else np.ones((b, k), np.float32))
    fld = rng.randint(0, hyper.num_fields, size=(b, k)).astype(np.int32)
    lab = np.sign(rng.randn(b)).astype(np.float32)
    return idx, val, fld, lab


@pytest.mark.parametrize("rc", [None, 32])
@pytest.mark.parametrize("kw", [{}, {"global_bias": True,
                                     "use_ftrl": False}])
def test_ffm_backend_parity(rc, kw):
    """FFM minibatch mxu in both packages, unchunked and row_chunk-tiled:
    the packed V+gg table pads to 8 lanes, one plan a row group serves its
    pairwise gather and scatter; and against the port's xla step."""
    from hivemall_tpu.models.ffm import make_ffm_step as jmake
    from hivemall_tpu_torch.models import ffm as TFF

    jh, th = ffm_hypers(num_fields=16, **kw)
    warm = warm_ffm_numpy(th, seed=9)
    blk = _ffm_block(th, 128, 8, 0)
    sj, lj = jmake(jh, "minibatch", row_chunk=rc, update_backend="mxu")(
        jax_ffm_state(warm), *blk)
    sm, lm = TFF.make_ffm_step(th, "minibatch", row_chunk=rc,
                               update_backend="mxu", device="cpu")(
        TFF.ffm_state_from_numpy(warm, "cpu"), *blk)
    assert_ffm_match(sm, jax_ffm_numpy(sj), rtol=0, atol=3e-6)
    assert np.allclose(float(lm), float(lj), rtol=1e-5)
    sx, _ = TFF.make_ffm_step(th, "minibatch", row_chunk=rc, pack_v=True,
                              device="cpu")(
        TFF.ffm_state_from_numpy(warm, "cpu"), *blk)
    assert_ffm_match(sm, TFF.ffm_state_to_numpy(sx), rtol=0, atol=3e-6)


def test_ffm_backend_production_shape():
    """FFM mxu at a realistic (if shrunken) shape — hashed pair keys over a
    2^16 table, 24 lanes a row, a 256-row block — in both packages."""
    from hivemall_tpu.models.ffm import make_ffm_step as jmake
    from hivemall_tpu_torch.models import ffm as TFF

    jh, th = ffm_hypers(num_features=1 << 14, v_dims=1 << 16,
                        num_fields=32)
    warm = warm_ffm_numpy(th, seed=3)
    blk = _ffm_block(th, 256, 24, 3, zero_lanes=False)
    sj, lj = jmake(jh, "minibatch", update_backend="mxu")(
        jax_ffm_state(warm), *blk)
    sm, lm = TFF.make_ffm_step(th, "minibatch", update_backend="mxu",
                               device="cpu")(
        TFF.ffm_state_from_numpy(warm, "cpu"), *blk)
    assert np.allclose(float(lj), float(lm), rtol=1e-5)
    assert_ffm_match(sm, jax_ffm_numpy(sj), rtol=0, atol=1e-5)


def test_ffm_backend_validation():
    from hivemall_tpu.models.ffm import make_ffm_step as jmake
    from hivemall_tpu_torch.models import ffm as TFF

    jh, th = ffm_hypers()
    for mode, kw, match in (("scan", {}, "minibatch"),
                            ("minibatch", {"pack_v": False}, "pack_v")):
        with pytest.raises(ValueError, match=match):
            jmake(jh, mode, update_backend="mxu", **kw)
        with pytest.raises(ValueError, match=match):
            TFF.make_ffm_step(th, mode, update_backend="mxu", device="cpu",
                              **kw)


def test_fit_linear_mxu_option():
    """-mxu_scatter trains end to end through fit_linear, equal to the JAX
    package's -mxu_scatter model and to the port's default backend."""
    from hivemall_tpu.models.classifier import train_arow as jtrain
    from hivemall_tpu_torch.models.classifier import train_arow

    rng = np.random.RandomState(5)
    n, dim = 256, 64
    rows = [[f"{rng.randint(dim)}:{rng.rand():.3f}" for _ in range(6)]
            for _ in range(n)]
    labels = np.sign(rng.randn(n))
    m_m = train_arow(rows, labels, "-mini_batch 64 -mxu_scatter",
                     device="cpu")
    m_x = train_arow(rows, labels, "-mini_batch 64", device="cpu")
    j_m = jtrain(rows, labels, options="-mini_batch 64 -mxu_scatter")
    np.testing.assert_allclose(m_m.state.weights.numpy(),
                               np.asarray(j_m.state.weights), atol=1e-5)
    np.testing.assert_allclose(m_m.state.weights.numpy(),
                               m_x.state.weights.numpy(), atol=1e-5)
    np.testing.assert_array_equal(m_m.state.touched.numpy(),
                                  np.asarray(j_m.state.touched))


def test_train_fm_and_ffm_mxu_option():
    """train_fm / train_ffm -mini_batch B -mxu_scatter end to end in both
    packages, at fit_linear's atol 1e-5 (several blocks carry the
    reassociated sums forward; one block is held at 3e-6 above)."""
    from hivemall_tpu.models.ffm import train_ffm as jffm
    from hivemall_tpu.models.fm import train_fm as jfm
    from hivemall_tpu_torch.models.ffm import train_ffm
    from hivemall_tpu_torch.models.fm import train_fm

    from torch_cases import ffm_rows

    rng = np.random.RandomState(8)
    feats = ([rng.randint(0, 256, 6) for _ in range(300)],
             [rng.rand(6).astype(np.float32) for _ in range(300)])
    y = np.sign(rng.randn(300))
    opts = "-c -dims 256 -factor 5 -mini_batch 64 -mxu_scatter"
    t = train_fm(feats, y, opts, device="cpu")
    j = jfm(feats, y, opts)
    np.testing.assert_allclose(t.state.w.numpy(), np.asarray(j.state.w),
                               atol=1e-5)
    np.testing.assert_allclose(t.state.v.numpy(), np.asarray(j.state.v),
                               atol=1e-5)
    rows, lab = ffm_rows(n=200)
    opts = ("-mini_batch 32 -mxu_scatter -feature_hashing 10 -v_bits 12 "
            "-row_chunk 16")
    t = train_ffm(rows, lab, opts, device="cpu")
    j = jffm(rows, lab, opts)
    for f in ("w", "v", "v_gg", "z", "n"):
        np.testing.assert_allclose(getattr(t.state, f).numpy(),
                                   np.asarray(getattr(j.state, f)),
                                   atol=1e-5, err_msg=f)
