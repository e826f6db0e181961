"""The port's matrix factorization (hivemall_tpu_torch/models/mf.py) against
the JAX package's (hivemall_tpu/models/mf.py) on the CPU (`device="cpu"`).

The same numpy inputs go to both packages. Step tests start both from one
state carried across with `mf_state_from_numpy`; trainer comparisons start
both packages from the seed, since the port's `init_mf_state` draws JAX's
P and Q (utils/jax_prng.py: uniform bit for bit, gaussian within 1 ulp).
Tolerances: the scan at rtol 1e-5 / atol 1e-6,
the minibatch at rtol 2e-5 / atol 1e-6 (the reference's minibatch
tolerance, tests/test_batch_update.py:177-183); `touched` and `step` exact.
None of the JAX functions used here is red on this tree (tests/test_mf.py
is green in the driver's last run)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.models import mf as JM
from hivemall_tpu.ops import eta as JEta
from hivemall_tpu_torch.models import mf as TM
from hivemall_tpu_torch.ops import eta as TEta

from torch_cases import (ATOL, RTOL, assert_mf_match, carried_mf_models,
                         jax_mf_numpy, jax_mf_state, warm_mf_numpy)

MB_RTOL = 2e-5
TOL = {"scan": (RTOL, ATOL), "minibatch": (MB_RTOL, ATOL)}
N_USERS, N_ITEMS, K = 16, 24, 4


def etas(kind):
    """(JAX, port) EtaEstimator of one schedule."""
    args = {"invscaling": ("invscaling", 0.2, {"power_t": 0.1}),
            "fixed": ("fixed", 0.05, {}),
            "simple": ("simple", 0.1, {"total_steps": 520.0})}[kind]
    return (JEta.EtaEstimator(args[0], args[1], **args[2]),
            TEta.EtaEstimator(args[0], args[1], **args[2]))


def colliding_block(b, seed, n_users=N_USERS, n_items=N_ITEMS):
    """Users and items from small ranges, so ids repeat within a block
    (duplicate adds) and across its rows (the scan's carry)."""
    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_users // 2, b).astype(np.int32)
    i = rng.randint(0, n_items // 3, b).astype(np.int32)
    j = rng.randint(0, n_items, b).astype(np.int32)
    r = (1.0 + 4.0 * rng.rand(b)).astype(np.float32)
    return u, i, j, r


MF_CASES = [
    # (adagrad, use_bias, update_mean, eta kind)
    (False, True, False, "invscaling"),
    (False, True, True, "fixed"),
    (False, False, False, "simple"),
    (True, True, False, "invscaling"),
    (True, False, False, "fixed"),
    (True, True, True, "invscaling"),
]


@pytest.mark.parametrize("mode", ["scan", "minibatch"])
@pytest.mark.parametrize("adagrad,use_bias,update_mean,eta", MF_CASES)
def test_mf_step_matches_jax(mode, adagrad, use_bias, update_mean, eta):
    je, te = etas(eta)
    common = dict(factor=K, lambda_=0.03, mu=0.4, update_mean=update_mean,
                  use_bias=use_bias, adagrad=adagrad, eps=1.0,
                  scaling=100.0)
    jh, th = JM.MFHyper(eta=je, **common), TM.MFHyper(eta=te, **common)
    d = warm_mf_numpy(N_USERS, N_ITEMS, K, adagrad=adagrad, seed=3)
    u, i, _, r = colliding_block(40, seed=5)
    js, jl = JM.make_mf_step(jh, mode)(jax_mf_state(d), jnp.asarray(u),
                                       jnp.asarray(i), jnp.asarray(r))
    ts, tl = TM.make_mf_step(th, mode, device="cpu")(
        TM.mf_state_from_numpy(d, "cpu"), u, i, r)
    rtol, atol = TOL[mode]
    assert_mf_match(ts, jax_mf_numpy(js), rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol, atol=atol)
    if update_mean and use_bias:
        assert float(ts.mu) != 0.4  # the mean moved
    else:
        assert float(ts.mu) == np.float32(0.4)


BPR_CASES = [("lnLogistic", True), ("logistic", True), ("sigmoid", True),
             ("lnLogistic", False)]


@pytest.mark.parametrize("mode", ["scan", "minibatch"])
@pytest.mark.parametrize("loss,use_bias", BPR_CASES)
def test_bpr_step_matches_jax(mode, loss, use_bias):
    je, te = etas("invscaling")
    common = dict(factor=K, loss=loss, reg_u=0.0025, reg_i=0.003,
                  reg_j=0.0015, reg_bias=0.01, use_bias=use_bias)
    jh, th = JM.BPRHyper(eta=je, **common), TM.BPRHyper(eta=te, **common)
    d = warm_mf_numpy(N_USERS, N_ITEMS, K, seed=4)
    u, i, j, _ = colliding_block(40, seed=6)
    js, jl = JM.make_bpr_step(jh, mode)(jax_mf_state(d), jnp.asarray(u),
                                        jnp.asarray(i), jnp.asarray(j))
    ts, tl = TM.make_bpr_step(th, mode, device="cpu")(
        TM.mf_state_from_numpy(d, "cpu"), u, i, j)
    rtol, atol = TOL[mode]
    assert_mf_match(ts, jax_mf_numpy(js), rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol, atol=atol)


@pytest.mark.parametrize("bpr", [False, True])
def test_minibatch_of_one_row_equals_the_scan(bpr):
    """B one-row minibatch steps replay the scan of the B rows (the scan
    runs each row through the minibatch step's row math): tables at the
    scan tolerance (eta is computed on a vector in one and a [1] tensor in
    the other), touched and step exact."""
    d = warm_mf_numpy(N_USERS, N_ITEMS, K, adagrad=not bpr, seed=7)
    u, i, j, r = colliding_block(30, seed=8)
    if bpr:
        hyper, make, third = TM.BPRHyper(factor=K), TM.make_bpr_step, j
    else:
        hyper = TM.MFHyper(factor=K, adagrad=True, update_mean=True)
        make, third = TM.make_mf_step, r
    scan, s_loss = make(hyper, "scan", device="cpu")(
        TM.mf_state_from_numpy(d, "cpu"), u, i, third)
    step = make(hyper, "minibatch", device="cpu")
    st, losses = TM.mf_state_from_numpy(d, "cpu"), []
    for row in range(len(u)):
        sl = slice(row, row + 1)
        st, loss = step(st, u[sl], i[sl], third[sl])
        losses.append(float(loss))
    assert_mf_match(st, TM.mf_state_to_numpy(scan))
    np.testing.assert_allclose(sum(losses), float(s_loss), rtol=RTOL,
                               atol=ATOL)


def rating_rows(n=400, n_users=30, n_items=90, seed=0):
    """The reference retrieval tests' MF fixture shape: ids over the full
    ranges, the last row pinning both table sizes."""
    rng = np.random.RandomState(seed)
    u = rng.randint(0, n_users, n)
    i = rng.randint(0, n_items, n)
    r = rng.rand(n) * 4 + 1
    u[-1], i[-1] = n_users - 1, n_items - 1
    j = rng.randint(0, n_items, n)
    return u, i, j, r


TRAIN_CASES = [
    ("sgd", "-factor 4 -iter 3 -disable_cv"),
    ("sgd", "-factor 4 -mini_batch 64 -iter 3 -disable_cv"),
    ("sgd", "-factor 4 -mini_batch 20 -iter 2 -disable_cv -update_mean "
            "-mu 3.0 -eta 0.005"),
    ("sgd", "-factor 4 -mini_batch 32 -iter 6 -disable_bias "
            "-rankinit gaussian -seed 5"),
    ("adagrad", "-factor 4 -iter 2 -disable_cv -eta0 0.1"),
    ("adagrad", "-factor 4 -mini_batch 64 -iter 30 -eta0 0.1 -cv_rate 0.05"),
    ("bpr", "-factor 4 -iter 3 -disable_cv"),
    ("bpr", "-factor 4 -mini_batch 64 -iter 5"),
    ("bpr", "-factor 4 -mini_batch 64 -iter 2 -disable_cv -loss sigmoid "
            "-disable_bias"),
]


@pytest.mark.parametrize("kind,opts", TRAIN_CASES)
def test_trainers_match_jax(kind, opts):
    u, i, j, r = rating_rows()
    if kind == "bpr":
        jm = JM.train_bprmf(u, i, j, opts)
        tm = TM.train_bprmf(u, i, j, opts, device="cpu")
    else:
        jfn = {"sgd": JM.train_mf_sgd, "adagrad": JM.train_mf_adagrad}[kind]
        tfn = {"sgd": TM.train_mf_sgd, "adagrad": TM.train_mf_adagrad}[kind]
        jm = jfn(u, i, r, opts)
        tm = tfn(u, i, r, opts, device="cpu")
    rtol, atol = TOL["minibatch" if "-mini_batch" in opts else "scan"]
    assert_mf_match(tm.state, jax_mf_numpy(jm.state), rtol=rtol, atol=atol)
    assert tm.use_bias == jm.use_bias


def test_convergence_stop_matches_jax():
    """With the convergence check on, both packages stop after the same
    epoch (step counts the rows of every epoch run)."""
    u, i, j, r = rating_rows()
    opts = "-factor 4 -mini_batch 64 -iter 30 -cv_rate 0.05"
    jm = JM.train_mf_sgd(u, i, r, opts)
    tm = TM.train_mf_sgd(u, i, r, opts, device="cpu")
    assert int(jm.state.step) < 30 * len(u)  # stopped early
    assert tm.state.step == int(jm.state.step)


def test_predict_and_model_rows_equal_jax():
    jm, tm = carried_mf_models()
    rng = np.random.RandomState(2)
    users, items = rng.randint(0, 30, 50), rng.randint(0, 90, 50)
    users[0], items[0] = -1, -90  # numpy's negative indexing, as in JAX
    np.testing.assert_array_equal(tm.predict(users, items),
                                  jm.predict(users, items))
    np.testing.assert_array_equal(tm.predict_bpr(users, items),
                                  jm.predict_bpr(users, items))
    for m in (tm, jm):  # out of range raises in both
        with pytest.raises(IndexError):
            m.predict([30], [0])
    a, b = tm.model_rows(), jm.model_rows()
    assert a["mu"] == b["mu"]
    for side in ("users", "items"):
        for x, y in zip(a[side], b[side]):
            np.testing.assert_array_equal(x, y)
    _, nb = carried_mf_models(use_bias=False)
    jb, _ = carried_mf_models(use_bias=False)
    np.testing.assert_array_equal(nb.predict(users, items),
                                  jb.predict(users, items))


def test_udfs_equal_jax():
    rng = np.random.RandomState(1)
    pu, qi = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)
    assert TM.mf_predict(pu, qi, 0.1, -0.2, 3.0) \
        == JM.mf_predict(pu, qi, 0.1, -0.2, 3.0)
    assert TM.mf_predict(pu, qi) == JM.mf_predict(pu, qi)
    assert TM.bprmf_predict(pu, qi, 0.5) == JM.bprmf_predict(pu, qi, 0.5)


@pytest.mark.parametrize("rankinit", ["random", "gaussian"])
def test_init_layout_and_seed(rankinit):
    hyper = TM.MFHyper(factor=6, rankinit=rankinit, maxval=0.5, mu=2.5,
                       adagrad=True, seed=9)
    st = TM.init_mf_state(40, 70, hyper, device="cpu")
    assert st.P.shape == (40, 6) and st.Q.shape == (70, 6)
    assert st.P.dtype == st.Q.dtype == torch.float32
    assert st.P_gg.shape == (40, 6) and st.Q_gg.shape == (70, 6)
    assert not st.P_gg.any() and not st.Bu.any() and not st.Bi.any()
    assert st.touched_u.dtype == torch.int8 and not st.touched_i.any()
    assert float(st.mu) == 2.5 and st.step == 0
    # P and Q are JAX's draw from the two halves of split(PRNGKey(9))
    js = jax_mf_numpy(JM.init_mf_state(40, 70, JM.MFHyper(
        factor=6, rankinit=rankinit, maxval=0.5, seed=9)))
    for got, want in ((st.P, js["P"]), (st.Q, js["Q"])):
        if rankinit == "random":  # the uniform is bit-exact
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23,
                                       atol=0)
    if rankinit == "random":
        assert float(st.P.min()) >= 0.0 and float(st.P.max()) < 0.5
    again = TM.init_mf_state(40, 70, hyper, device="cpu")
    assert torch.equal(again.P, st.P) and torch.equal(again.Q, st.Q)
    other = TM.init_mf_state(40, 70, TM.MFHyper(factor=6, seed=10), "cpu")
    assert not torch.equal(other.P, st.P)
    assert other.P_gg is None and other.Q_gg is None
    assert TM.init_mf_state(3, 4, TM.BPRHyper(factor=2), "cpu").P_gg is None


def test_state_numpy_round_trip():
    for adagrad in (False, True):
        d = warm_mf_numpy(12, 20, 3, adagrad=adagrad, seed=1)
        st = TM.mf_state_from_numpy(d, "cpu")
        back = TM.mf_state_to_numpy(st)
        for k, v in d.items():
            if v is None:
                assert back[k] is None
            else:
                np.testing.assert_array_equal(back[k], v, err_msg=k)
                assert np.asarray(back[k]).dtype == np.asarray(v).dtype, k
        st.P[0, 0] = 99.0  # a fresh copy, not a view of the input
        assert d["P"][0, 0] != 99.0
    # a JAX init carried across equals itself back
    js = JM.init_mf_state(5, 7, JM.MFHyper(factor=3, adagrad=True))
    jn = jax_mf_numpy(js)
    assert_mf_match(TM.mf_state_from_numpy(jn, "cpu"), jn, rtol=0, atol=0)


def test_mf_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    u, i, j, r = rating_rows(n=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.train_mf_sgd(u, i, r, "-factor 2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.train_mf_adagrad(u, i, r, "-factor 2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.train_bprmf(u, i, j, "-factor 2 -iter 1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_mf_state(4, 4, TM.MFHyper(factor=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.make_mf_step(TM.MFHyper(factor=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.make_bpr_step(TM.BPRHyper(factor=2), "scan")


# --- MF artifacts and /predict pairs (serving/artifact.py, engine.py) -------

def _pairs(n=37, seed=3):
    rng = np.random.RandomState(seed)
    return [[int(u), int(i)] for u, i in zip(rng.randint(0, 30, n),
                                             rng.randint(0, 90, n))]


@pytest.mark.parametrize("quantize", [None, "bf16", "int8"])
def test_mf_artifacts_equal_and_cross_serve(tmp_path, quantize):
    """One carried state frozen by both packages: the same arrays, dtypes
    and meta; each artifact served by both engines to the same bits (the
    MF servables are host numpy gather-dots in both)."""
    from hivemall_tpu.serving import ServingEngine as JEngine
    from hivemall_tpu.serving import freeze as jax_freeze
    from hivemall_tpu.serving import load as jax_load
    from hivemall_tpu_torch.serving import ServingEngine, freeze, load

    jm, tm = carried_mf_models()
    qb = 16 if quantize else None
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    freeze(tm, pdir, quantize=quantize, quant_block_rows=qb)
    jax_freeze(jm, jdir, quantize=quantize, quant_block_rows=qb)
    pa, ja = load(pdir), jax_load(jdir)
    assert sorted(pa.arrays) == sorted(ja.arrays)
    for k in pa.arrays:
        assert pa.arrays[k].dtype == ja.arrays[k].dtype, k
        assert pa.arrays[k].tobytes() == ja.arrays[k].tobytes(), k
    assert pa.meta == ja.meta and pa.family == ja.family == "mf"
    pairs = _pairs()
    for path in (pdir, jdir):
        got = ServingEngine(path, name=f"mf_{quantize}_{path[-3:]}",
                            max_batch=16, device="cpu")
        assert got.warmup() == 0
        assert got.warmed_buckets == [(8, None), (16, None)]
        want = JEngine(jax_load(path), name=f"jmf_{quantize}_{path[-3:]}",
                       max_batch=16)
        np.testing.assert_array_equal(got.predict(pairs),
                                      np.asarray(want.predict(pairs)))
        assert got.weights_dtype == {None: "float32", "bf16": "bfloat16",
                                     "int8": "int8"}[quantize]
        assert got.table_bytes == want.table_bytes


def test_mf_served_equals_model_predict_and_rebuilds(tmp_path):
    from hivemall_tpu.serving import load as jax_load
    from hivemall_tpu.serving.artifact import rebuild_model as jax_rebuild
    from hivemall_tpu_torch.serving import ServingEngine, freeze, load
    from hivemall_tpu_torch.serving.artifact import family_of, rebuild_model

    _, tm = carried_mf_models()
    assert family_of(tm) == "mf"
    pairs = _pairs()
    u, i = np.asarray(pairs).T
    live = ServingEngine(tm, name="mf_live", max_batch=16)
    np.testing.assert_array_equal(live.predict(pairs), tm.predict(u, i))
    path = str(tmp_path / "a")
    freeze(tm, path)
    rebuilt = rebuild_model(load(path), device="cpu")
    np.testing.assert_array_equal(rebuilt.predict(u, i), tm.predict(u, i))
    np.testing.assert_array_equal(
        rebuilt.predict(u, i), np.asarray(jax_rebuild(jax_load(path))
                                          .predict(u, i)))
    assert rebuilt.state.touched_u.all() and rebuilt.state.P_gg is None
    with pytest.raises(IndexError):
        ServingEngine(path, name="mf_oob", device="cpu").predict([[30, 0]])
    freeze(tm, str(tmp_path / "q"), quantize="int8")
    with pytest.raises(ValueError, match="quantized"):
        rebuild_model(load(str(tmp_path / "q")), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(path, name="mf_nocuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rebuild_model(load(path))
