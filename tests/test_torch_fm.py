"""The port's factorization machine (hivemall_tpu_torch/models/fm.py and
ops/scatter.py) against the JAX package's (hivemall_tpu/models/fm.py,
hivemall_tpu/ops/scatter.py) on the CPU (`device="cpu"`).

The same numpy inputs go to both packages, and each run starts from one
state carried across with `fm_state_from_numpy`. The port's `init_fm_state`
draws JAX's initial V (tests/test_torch_jax_prng.py holds the draw); a
`train_fm` comparison still replaces it with one that returns JAX's own
initial state, so both runs start from one array. Tolerance rtol 1e-5 / atol 1e-6 (the port's
parity tolerance, tests/torch_cases.py); `touched` and `step` exact. None
of the JAX functions used here is red on this tree (tests/test_fm.py is
green in the driver's last run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.models import fm as JF
from hivemall_tpu.ops.scatter import scatter_rows_flat as jax_scatter_rows
from hivemall_tpu_torch.models import fm as TF
from hivemall_tpu_torch.ops.scatter import scatter_rows_flat

from torch_cases import (ATOL, RTOL, assert_fm_match, carried_fm_models,
                         fm_hypers as hypers,
                         jax_fm_numpy as jax_numpy, jax_fm_state as jax_state,
                         warm_fm_numpy as warm_numpy)


def block(b, k, dims, seed, classification=True):
    """A block with pad lanes (every 3rd row ends in two), repeated ids in
    a row (every 4th row) and ids repeated across rows (a small id range
    for the first half of the lanes)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, dims, (b, k)).astype(np.int32)
    idx[:, : k // 2] = rng.randint(0, 16, (b, k // 2))
    idx[::4, 1] = idx[::4, 0]
    val = rng.randn(b, k).astype(np.float32)
    idx[::3, -2:] = dims
    val[::3, -2:] = 0.0
    y = (np.sign(rng.randn(b)) if classification
         else 0.8 * rng.randn(b)).astype(np.float32)
    y[y == 0] = 1.0
    return idx, val, y


# --- ops/scatter.scatter_rows_flat ------------------------------------------

@pytest.mark.parametrize("k,kl", [(8, 8), (8, 5), (5, 5), (16, 9)])
def test_scatter_rows_flat_matches_jax(k, kl):
    rng = np.random.RandomState(k + kl)
    e = 64
    table = rng.randn(e, k).astype(np.float32)
    keys = rng.randint(0, e, (30, 6)).astype(np.int64)
    keys[:, 0] = 3  # repeats accumulate
    keys[::5, -1] = e  # dropped: the pad key
    keys[1::7, -2] = e + 11  # dropped: past the pad key
    upd = rng.randn(30, 6, kl).astype(np.float32)
    want = np.asarray(jax_scatter_rows(jnp.asarray(table),
                                       jnp.asarray(keys, jnp.int32),
                                       jnp.asarray(upd)))
    got = scatter_rows_flat(torch.from_numpy(table.copy()),
                            torch.from_numpy(keys), torch.from_numpy(upd))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # lanes past kl are untouched bit for bit, signed zeros included
    table[0, kl:] = -0.0
    got = scatter_rows_flat(torch.from_numpy(table.copy()),
                            torch.from_numpy(keys), torch.from_numpy(upd))
    assert got[:, kl:].numpy().tobytes() == table[:, kl:].tobytes()


def test_scatter_rows_flat_dropped_keys_write_nothing():
    table = torch.tensor([[-0.0, 1.0], [2.0, -3.0]])
    before = table.numpy().tobytes()
    scatter_rows_flat(table, torch.tensor([2, 5, -1]),
                      torch.tensor([[1.0, 1.0], [4.0, 4.0], [9.0, 9.0]]))
    assert table.numpy().tobytes() == before


# --- ops/eta on per-row t tensors ------------------------------------------

@pytest.mark.parametrize("eta", [("fixed", 0.1, None),
                                 ("simple", 0.1, 700),
                                 ("invscaling", 0.05, 0.1)])
def test_eta_schedules_on_row_tensors(eta):
    (jh, th) = hypers(eta=eta)
    t = (500 + 1 + np.arange(512)).astype(np.float32)
    np.testing.assert_allclose(th.eta.eta(torch.from_numpy(t)).numpy(),
                               np.asarray(jh.eta.eta(jnp.asarray(t))),
                               rtol=1e-6, atol=0)


# --- make_fm_step: one block, scan and minibatch ----------------------------

STEP_CASES = [
    # (mode, average, pack_w, factors, classification, adareg, eta)
    ("scan", True, True, 5, True, False, ("invscaling", 0.05, 0.1)),
    ("scan", True, True, 5, False, False, ("fixed", 0.02, None)),
    ("scan", True, True, 8, True, False, ("simple", 0.1, 600)),
    ("scan", True, True, 5, True, True, ("invscaling", 0.05, 0.1)),
    ("minibatch", True, True, 5, True, False, ("invscaling", 0.05, 0.1)),
    ("minibatch", True, False, 5, True, False, ("invscaling", 0.05, 0.1)),
    ("minibatch", False, True, 5, True, False, ("invscaling", 0.05, 0.1)),
    ("minibatch", False, False, 5, True, False, ("invscaling", 0.05, 0.1)),
    ("minibatch", True, True, 5, False, False, ("fixed", 0.02, None)),
    ("minibatch", False, False, 5, False, False, ("fixed", 0.02, None)),
    ("minibatch", True, True, 8, True, False, ("simple", 0.1, 600)),
    ("minibatch", True, True, 5, True, True, ("invscaling", 0.05, 0.1)),
    ("minibatch", False, True, 5, True, True, ("invscaling", 0.05, 0.1)),
]


@pytest.mark.parametrize("mode,avg,pack,factors,cls,adareg,eta", STEP_CASES,
                         ids=["-".join(map(str, c[:6])) for c in STEP_CASES])
def test_make_fm_step_matches_jax(mode, avg, pack, factors, cls, adareg, eta):
    dims, b, k = 512, 96, 12
    extra = {} if cls else {"min_target": -1.0, "max_target": 1.0}
    jh, th = hypers(factors, cls, eta, adareg=adareg, **extra)
    d = warm_numpy(dims, th, seed=factors)
    idx, val, y = block(b, k, dims, seed=7, classification=cls)
    va = (np.random.RandomState(3).rand(b) < 0.25).astype(np.float32) \
        if adareg else np.zeros(b, np.float32)
    js, jl = JF.make_fm_step(jh, mode, mini_batch_average=avg, pack_w=pack)(
        jax_state(d), jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y),
        jnp.asarray(va))
    step = TF.make_fm_step(th, mode, mini_batch_average=avg, pack_w=pack,
                           device="cpu")
    ts, tl = step(TF.fm_state_from_numpy(d, device="cpu"), idx, val, y, va)
    want = jax_numpy(js)
    assert_fm_match(ts, want)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    # pad lanes stay 0; adareg moved the lambdas off their start
    assert not ts.v[:, factors:].any()
    if adareg:
        assert not np.allclose(TF.fm_state_to_numpy(ts)["lambda_v"],
                               d["lambda_v"])


def test_minibatch_of_one_row_equals_scan():
    jh, th = hypers()
    d = warm_numpy(256, th, seed=1)
    idx, val, y = block(1, 8, 256, seed=2)
    va = np.zeros(1, np.float32)
    a, la = TF.make_fm_step(th, "scan", device="cpu")(
        TF.fm_state_from_numpy(d, "cpu"), idx, val, y, va)
    b, lb = TF.make_fm_step(th, "minibatch", mini_batch_average=False,
                            device="cpu")(
        TF.fm_state_from_numpy(d, "cpu"), idx, val, y, va)
    assert_fm_match(a, TF.fm_state_to_numpy(b), rtol=1e-6, atol=1e-7)
    assert float(la) == pytest.approx(float(lb), rel=1e-6)


# --- scoring, model rows, fm_predict ----------------------------------------

def ragged_rows(n, dims, seed=5):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 14, size=n)
    return ([rng.randint(0, 2 * dims, m).astype(np.int64) for m in lens],
            [rng.randn(m).astype(np.float32) for m in lens])


@pytest.mark.parametrize("factors", [5, 8])
def test_predict_and_scores_match_jax(factors):
    jm, tm = carried_fm_models(factors=factors)
    feats = ragged_rows(4500, tm.dims)  # two 4096-row blocks
    np.testing.assert_allclose(tm.predict(feats), jm.predict(feats),
                               rtol=RTOL, atol=ATOL)
    idx, val, _ = block(64, 16, tm.dims, seed=9)
    np.testing.assert_allclose(
        TF._fm_scores(tm.state, idx, val).numpy(),
        np.asarray(JF._fm_scores(jm.state, jnp.asarray(idx),
                                 jnp.asarray(val))), rtol=RTOL, atol=ATOL)


def test_model_rows_and_fm_predict_match_jax():
    jm, tm = carried_fm_models()
    tw0, tf_, tw, tv = tm.model_rows()
    jw0, jf, jw, jv = jm.model_rows()
    assert tw0 == jw0
    np.testing.assert_array_equal(tf_, jf)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tv, jv)
    assert tv.shape[1] == 5 and tf_.dtype == np.int64
    rng = np.random.RandomState(0)
    for _ in range(5):
        sel = rng.choice(len(tf_), 7, replace=False)
        xs = rng.randn(7)
        assert TF.fm_predict(tw0, tw[sel], tv[sel], tf_[sel], xs) == \
            JF.fm_predict(jw0, jw[sel], jv[sel], jf[sel], xs)
    # fm_predict over the model rows == predict for a row of touched ids
    idx = tf_[sel]
    p = tm.predict(([idx], [xs.astype(np.float32)]))[0]
    assert TF.fm_predict(tw0, tw[sel], tv[sel], idx, xs) == \
        pytest.approx(float(p), rel=1e-5, abs=1e-5)


# --- train_fm end to end ----------------------------------------------------

def interaction_rows(n=600, d=48, k=2, seed=11, classification=True):
    """Rows labelled by a ground-truth FM (tests/test_fm.py's generator,
    with random values)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d) * 0.3
    v = rng.randn(d, k) * 0.4
    idx_rows, val_rows, ys = [], [], []
    for _ in range(n):
        nnz = rng.randint(3, 9)
        idx = rng.choice(d, size=nnz, replace=False).astype(np.int64)
        val = rng.uniform(0.5, 1.5, nnz).astype(np.float32)
        vx = v[idx] * val[:, None]
        s = (w[idx] * val).sum() + 0.5 * float(
            (vx.sum(0) ** 2 - (vx ** 2).sum(0)).sum())
        idx_rows.append(idx)
        val_rows.append(val)
        ys.append(np.sign(s) if classification else s)
    return (idx_rows, val_rows), np.asarray(ys, np.float32)


@pytest.fixture
def jax_init(monkeypatch):
    """Make the port's train_fm start from JAX's initial state."""
    def init(dims, hyper, device=None):
        jh = JF.FMHyper(factors=hyper.factors, sigma=hyper.sigma,
                        lambda0=hyper.lambda0, seed=hyper.seed)
        return TF.fm_state_from_numpy(
            jax_numpy(JF.init_fm_state(dims, jh)), device)

    monkeypatch.setattr(TF, "init_fm_state", init)


TRAIN_OPTIONS = [
    "-c -dims 64 -factor 5 -block_size 256",
    "-c -dims 64 -factor 5 -mini_batch 128",
    "-c -dims 64 -factor 8 -mini_batch 100 -eta 0.1 -lambda0 0.0",
    "-dims 64 -factor 5 -mini_batch 128 -min -2 -max 2 -t 400",
    "-dims 64 -factor 5 -min -2 -max 2 -eta 0.01",
    "-c -dims 64 -factor 5 -mini_batch 128 -iters 3 -shuffle -disable_cv",
    "-c -dims 64 -factor 5 -iters 3 -shuffle -disable_cv -sigma 0.2 "
    "-seed 7",
    "-c -dims 64 -factor 5 -adareg -va_ratio 0.2 -block_size 256",
    "-c -dims 64 -factor 5 -adareg -mini_batch 128 -iters 2 -disable_cv",
]


@pytest.mark.parametrize("opts", TRAIN_OPTIONS)
def test_train_fm_matches_jax(opts, jax_init):
    """Several blocks (and epochs) carry the port's last-bit differences
    forward, so w/V are held at rtol 1e-4 / atol 1e-5 here (the tolerance
    chip_smoke.py holds the card to); one block is held at rtol 1e-5 /
    atol 1e-6 above."""
    feats, y = interaction_rows(classification="-c" in opts)
    jm = JF.train_fm(feats, y, opts)
    tm = TF.train_fm(feats, y, opts, device="cpu")
    assert_fm_match(tm.state, jax_numpy(jm.state), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.predict(feats), jm.predict(feats),
                               rtol=1e-4, atol=1e-5)


def test_train_fm_convergence_stop_matches_jax(jax_init):
    feats, y = interaction_rows(n=300)
    opts = "-c -dims 64 -factor 5 -iters 100 -cv_rate 0.05"
    jm = JF.train_fm(feats, y, opts)
    tm = TF.train_fm(feats, y, opts, device="cpu")
    assert tm.state.step < 100 * 300  # stopped early ...
    assert tm.state.step == int(jm.state.step)  # ... at JAX's epoch


def test_train_fm_learns_from_its_own_init():
    """Without the carried state: the port's own V init trains to the
    quality tests/test_fm.py pins for the JAX package."""
    feats, y = interaction_rows(n=1500, d=30)
    m = TF.train_fm(feats, y, "-dims 64 -classification -factor 5 -iters 30 "
                    "-eta 0.2 -mini_batch 128 -disable_cv", device="cpu")
    acc = float(np.mean(np.sign(m.predict(feats)) == y))
    assert acc >= 0.9, acc


# --- state, init, carry-over ------------------------------------------------

def test_init_fm_state_layout_and_seed():
    _, th = hypers(5, lambda0=0.03, sigma=0.2, seed=9)
    a = TF.init_fm_state(4096, th, device="cpu")
    b = TF.init_fm_state(4096, th, device="cpu")
    assert a.v.shape == (4096, 8) and a.w.shape == (4096,)
    assert torch.equal(a.v, b.v)  # one seed, one V
    assert not a.v[:, 5:].any() and not a.w.any() and float(a.w0) == 0.0
    assert abs(float(a.v[:, :5].std()) - 0.2) < 0.01
    np.testing.assert_array_equal(a.lambda_v.numpy(),
                                  np.float32([0.03] * 5 + [0.0] * 3))
    assert a.touched.dtype == torch.int8 and a.step == 0
    _, other = hypers(5, seed=10)
    assert not torch.equal(TF.init_fm_state(64, other, "cpu").v[:, :5],
                           TF.init_fm_state(64, th, "cpu").v[:, :5])


def test_carry_over_round_trip():
    _, th = hypers()
    d = warm_numpy(128, th)
    back = TF.fm_state_to_numpy(TF.fm_state_from_numpy(d, device="cpu"))
    for k, x in d.items():
        assert back[k].dtype == np.asarray(x).dtype, k
        assert back[k].tobytes() == np.asarray(x).tobytes(), k
    assert isinstance(back["step"], np.int32)
    # and through the JAX state, both ways
    again = jax_numpy(jax_state(back))
    for k in d:
        assert again[k].tobytes() == np.asarray(d[k]).tobytes(), k


# --- refusals and the device default ----------------------------------------

@pytest.mark.parametrize("flag,match", [
    ("-native_scan", "per-row scan mode"), ("-mxu_scatter", "later slice")])
def test_train_fm_refuses_later_slice_flags(flag, match):
    feats, y = interaction_rows(n=20)
    with pytest.raises(ValueError, match=match):
        TF.train_fm(feats, y, f"-c -dims 64 {flag} -mini_batch 8",
                    device="cpu")


def test_make_fm_step_refuses_sharding_and_mxu():
    _, th = hypers()
    # feature_shard runs since parallel/sharded_train.py landed (held
    # against JAX in tests/test_torch_parallel_families.py); with adareg it
    # is refused, as in JAX
    import dataclasses

    from torch_cases import one_rank_mesh

    with one_rank_mesh() as mesh:
        TF.make_fm_step(th, feature_shard=(mesh, "workers", 64),
                        device="cpu")
        with pytest.raises(ValueError, match="adareg"):
            TF.make_fm_step(dataclasses.replace(th, adareg=True),
                            feature_shard=(mesh, "workers", 64),
                            device="cpu")
    with pytest.raises(ValueError, match="later slice.*Queue 2 #3"):
        TF.make_fm_step(th, update_backend="mxu", device="cpu")
    with pytest.raises(ValueError, match="unknown update_backend"):
        TF.make_fm_step(th, update_backend="fast", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        TF.make_fm_step(th, mode="batch", device="cpu")


def test_fm_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    feats, y = interaction_rows(n=20)
    _, th = hypers()
    for call in (lambda: TF.train_fm(feats, y, "-c -dims 64"),
                 lambda: TF.make_fm_step(th),
                 lambda: TF.init_fm_state(64, th)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
