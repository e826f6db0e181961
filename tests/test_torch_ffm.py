"""The port's field-aware FM (hivemall_tpu_torch/models/ffm.py) against the
JAX package's (hivemall_tpu/models/ffm.py) on the CPU (`device="cpu"`).

The same numpy inputs go to both packages. One-block tests start both from
one warm state carried across (`ffm_state_from_numpy`); `train_ffm` runs
start each package from its own `init_ffm_state`, which are the same draw
(utils/jax_prng.py). Tolerance rtol 1e-5 / atol 1e-6 for one block;
`touched` and `step` exact. None of the JAX functions used here is red on
this tree (tests/test_ffm.py is green in the driver's last run)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.models import ffm as JFF
from hivemall_tpu_torch.models import ffm as TFF

from torch_cases import (ATOL, RTOL, assert_ffm_match, ffm_hypers, ffm_rows,
                         jax_ffm_numpy, jax_ffm_state, warm_ffm_numpy)


def ffm_block(hyper, b=64, k=8, seed=0):
    """A block with pad lanes (every 3rd row ends in two), a live lane of
    value 0 (every 5th row), a feature repeated within every 4th row and
    features repeated across rows (a small id range for the first lanes);
    fields over num_fields."""
    rng = np.random.RandomState(seed)
    d = hyper.num_features
    idx = rng.randint(0, d, (b, k)).astype(np.int32)
    idx[:, :3] = rng.randint(0, 12, (b, 3))
    idx[::4, 1] = idx[::4, 4]
    val = rng.rand(b, k).astype(np.float32) + 0.25
    val[::5, 2] = 0.0
    fld = rng.randint(0, hyper.num_fields, (b, k)).astype(np.int32)
    idx[::3, -2:] = d
    val[::3, -2:] = 0.0
    fld[::3, -2:] = 0
    y = np.where(rng.rand(b) < 0.5, -1.0, 1.0).astype(np.float32)
    return idx, val, fld, y


def test_pair_hash_bit_exact():
    rng = np.random.RandomState(0)
    top = (1 << 31) - 1
    ids = np.concatenate([[0, 1, 2, top, top - 1],
                          rng.randint(0, top, 4000, dtype=np.int64)])
    flds = np.concatenate([[0, top, 5, 1, top],
                           rng.randint(0, top, 4000, dtype=np.int64)])
    for dv in (1 << 12, 1 << 22, 12345, top):
        want = np.asarray(JFF.pair_hash(jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(flds, jnp.int32), dv))
        got = TFF.pair_hash(torch.from_numpy(ids), torch.from_numpy(flds),
                            dv)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        # numpy int64 arrays hash the same
        np.testing.assert_array_equal(TFF.pair_hash(ids, flds, dv), got)


# (mode, row_chunk, pack_v, hyper overrides)
STEP_CASES = [
    ("scan", None, None, {}),
    ("scan", None, None, {"global_bias": True, "use_ftrl": False,
                          "use_adagrad": False}),
    ("scan", None, None, {"linear_coeff": False,
                          "eta": ("simple", 0.1, 520)}),
    ("minibatch", None, False, {}),
    ("minibatch", None, True, {}),
    ("minibatch", 16, False, {}),
    ("minibatch", 16, True, {}),
    ("minibatch", None, True, {"global_bias": True}),
    ("minibatch", None, False, {"use_ftrl": False}),
    ("minibatch", None, True, {"use_adagrad": False,
                               "eta": ("fixed", 0.05, None)}),
    ("minibatch", None, True, {"linear_coeff": False}),
    ("minibatch", 16, True, {"global_bias": True, "use_ftrl": False,
                             "use_adagrad": False}),
    ("minibatch", 32, False, {"global_bias": True}),
]


@pytest.mark.parametrize(
    "mode,chunk,pack,kw", STEP_CASES,
    ids=[f"{m}-chunk{c}-pack{p}-" + "-".join(sorted(kw)) for m, c, p, kw
         in STEP_CASES])
def test_make_ffm_step_matches_jax(mode, chunk, pack, kw):
    jh, th = ffm_hypers(**kw)
    d = warm_ffm_numpy(th, seed=1)
    blk = ffm_block(th, seed=2)
    js, jl = JFF.make_ffm_step(jh, mode, row_chunk=chunk, pack_v=pack)(
        jax_ffm_state(d), *blk)
    ts, tl = TFF.make_ffm_step(th, mode, row_chunk=chunk, pack_v=pack,
                               device="cpu")(
        TFF.ffm_state_from_numpy(d, "cpu"), *blk)
    assert_ffm_match(ts, jax_ffm_numpy(js))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pack", [False, True])
def test_row_chunk_equals_unchunked(pack):
    _, th = ffm_hypers(global_bias=True)
    d = warm_ffm_numpy(th, seed=4)
    blk = ffm_block(th, b=96, seed=5)
    outs = [TFF.make_ffm_step(th, "minibatch", row_chunk=c, pack_v=pack,
                              device="cpu")(
        TFF.ffm_state_from_numpy(d, "cpu"), *blk) for c in (None, 32)]
    want = TFF.ffm_state_to_numpy(outs[0][0])
    assert_ffm_match(outs[1][0], want)
    np.testing.assert_allclose(float(outs[1][1]), float(outs[0][1]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_ftrl", [True, False])
def test_repeated_features_last_lane_wins(use_ftrl):
    """Every lane of a block draws from 6 features: each feature's new w
    comes from many lanes that disagree, and the last lane in row-major
    order wins in both packages (a wrong winner is off by far more than
    the tolerance)."""
    jh, th = ffm_hypers(use_ftrl=use_ftrl)
    d = warm_ffm_numpy(th, seed=6)
    rng = np.random.RandomState(7)
    b, k = 128, 16
    idx = rng.randint(0, 6, (b, k)).astype(np.int32)
    val = (rng.rand(b, k) * 3 - 1.5).astype(np.float32)
    fld = rng.randint(0, 8, (b, k)).astype(np.int32)
    y = np.where(rng.rand(b) < 0.5, -1.0, 1.0).astype(np.float32)
    js, _ = JFF.make_ffm_step(jh, "minibatch")(jax_ffm_state(d), idx, val,
                                               fld, y)
    ts, _ = TFF.make_ffm_step(th, "minibatch", device="cpu")(
        TFF.ffm_state_from_numpy(d, "cpu"), idx, val, fld, y)
    assert_ffm_match(ts, jax_ffm_numpy(js))


TRAIN_OPTIONS = [
    "-factor 4 -feature_hashing 12 -v_bits 14 -num_fields 8",
    "-factor 4 -feature_hashing 12 -v_bits 14 -num_fields 8 -mini_batch 64",
    "-factor 4 -feature_hashing 12 -v_bits 14 -num_fields 8 -mini_batch 64 "
    "-row_chunk 16 -w0",
    "-factor 3 -feature_hashing 12 -v_bits 13 -num_fields 8 -mini_batch 50 "
    "-iters 3 -disable_cv -disable_ftrl -seed 9",
    "-factor 4 -feature_hashing 12 -v_bits 14 -num_fields 8 -w0 "
    "-disable_adagrad -eta 0.05 -block_size 128",
]


@pytest.mark.parametrize("opts", TRAIN_OPTIONS)
def test_train_ffm_matches_jax(opts):
    """Each package starts from its own init_ffm_state (the same draw);
    several blocks carry last-bit differences forward, so the tables are
    held at rtol 1e-4 / atol 1e-5 (chip_smoke.py's tolerance)."""
    rows, y = ffm_rows(n=300, extra=3)
    jm = JFF.train_ffm(rows, y, opts)
    tm = TFF.train_ffm(rows, y, opts, device="cpu")
    assert_ffm_match(tm.state, jax_ffm_numpy(jm.state), rtol=1e-4,
                     atol=1e-5)
    np.testing.assert_allclose(TFF.ffm_predict(tm, rows), jm.predict(rows),
                               rtol=1e-4, atol=1e-5)
    tf, tw, tw0 = tm.model_rows()
    jf, jw, jw0 = jm.model_rows()
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-5)
    assert tw0 == pytest.approx(jw0, rel=1e-4, abs=1e-5)


def test_train_ffm_learns_interactions():
    rows, y = ffm_rows(n=1200)
    m = TFF.train_ffm(rows, y, "-factor 4 -iters 15 -feature_hashing 18 "
                      "-v_bits 18 -lambda0 0.0 -disable_cv -seed 2",
                      device="cpu")
    acc = float(np.mean(np.sign(m.predict(rows)) == y))
    assert acc > 0.85, acc


def test_ffm_refusals():
    _, th = ffm_hypers()
    rows, y = ffm_rows(n=8)
    # feature_shard runs since parallel/sharded_train.py landed; held
    # against JAX in tests/test_torch_parallel_families.py
    from torch_cases import one_rank_mesh

    with one_rank_mesh() as mesh:
        TFF.make_ffm_step(th, "minibatch", device="cpu",
                          feature_shard=(mesh, "workers", th.num_features,
                                         th.v_dims))
    # mxu runs since ops/mxu_scatter.py landed (held against JAX in
    # tests/test_torch_mxu_scatter.py); the reference's refusals stay
    TFF.make_ffm_step(th, "minibatch", update_backend="mxu", device="cpu")
    with pytest.raises(ValueError, match="mxu.*pack_v=False"):
        TFF.make_ffm_step(th, "minibatch", update_backend="mxu",
                          pack_v=False, device="cpu")
    TFF.train_ffm(rows, y, "-mini_batch 4 -mxu_scatter "
                  "-feature_hashing 10 -v_bits 10", device="cpu")
    with pytest.raises(ValueError, match="row_chunk requires"):
        TFF.train_ffm(rows, y, "-row_chunk 2 -feature_hashing 10 "
                      "-v_bits 10", device="cpu")
    with pytest.raises(ValueError, match="row_chunk applies"):
        TFF.make_ffm_step(th, "scan", row_chunk=4, device="cpu")
    # in scan mode -mxu_scatter is ignored, as in the JAX package
    TFF.train_ffm(rows, y, "-mxu_scatter -feature_hashing 10 -v_bits 10",
                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TFF.train_ffm(rows, y, "-feature_hashing 10 -v_bits 10")


def test_default_eta_v_runs_away_in_both():
    """Head-heavy ids (log-uniform) and the default -eta0_V 1.0: a block
    sums every duplicate pair key's first AdaGrad step, so V runs away
    from its 0.1-scale draw within one block — in both packages, equally
    (the reference's semantics, not a port fault)."""
    rng = np.random.RandomState(8)
    d, b, k = 1 << 14, 2048, 16
    perm = rng.permutation(d)
    ids = perm[np.exp(rng.random_sample((b, k)) * np.log(float(d)))
               .astype(np.int64) % d]
    field_of = rng.randint(0, 16, d)
    rows = [[f"{field_of[i]}:{i}:1" for i in r] for r in ids.tolist()]
    y = np.where(rng.rand(b) < 0.5, -1.0, 1.0).astype(np.float32)
    opts = ("-factor 4 -feature_hashing 14 -v_bits 16 -num_fields 16 "
            f"-mini_batch {b}")
    jm = JFF.train_ffm(rows, y, opts)
    tm = TFF.train_ffm(rows, y, opts, device="cpu")
    want = jax_ffm_numpy(jm.state)
    assert np.abs(want["v"]).max() > 10.0
    assert_ffm_match(tm.state, want)
