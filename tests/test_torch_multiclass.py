"""The port's multiclass classifiers (hivemall_tpu_torch/models/multiclass.py)
against the JAX package's (hivemall_tpu/models/multiclass.py) on the CPU
(`device="cpu"`).

The same numpy inputs go to both packages; one-block tests start both from
one warm state carried across (`mc_state_from_numpy`). All nine rules, at
L in {1, 3, 7} labels, D = 2^12, K = 16 lanes with pad lanes and ids
repeated within and across rows; the L = 7 states plant a tie between
label rows 1 and 2, and the fresh states of `train_multiclass_*` tie every
score at 0.0, so the missed label's tie-break (the first maximal index) is
exercised. Tolerance rtol 1e-5 / atol 1e-6; `touched` and `step` exact.
None of the JAX functions used here is red on this tree
(tests/test_multiclass.py is green in the driver's last run)."""

import numpy as np
import pytest

from hivemall_tpu.models import multiclass as JMC
from hivemall_tpu_torch.models import multiclass as TMC

from torch_cases import (ATOL, RTOL, MC_HYPER, MC_RULES, assert_mc_match,
                         jax_mc_numpy, jax_mc_state, mc_rules, warm_mc_numpy)

DIMS, K, B = 1 << 12, 16, 96


def mc_block(num_labels, seed, b=B, k=K, dims=DIMS):
    """A block with pad lanes (every 3rd row ends in three), an id repeated
    within every 4th row, ids repeated across rows (a small id range for
    the first lanes) and labels over all L."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, dims, (b, k)).astype(np.int32)
    idx[:, :4] = rng.randint(0, 24, (b, 4))
    idx[::4, 2] = idx[::4, 5]
    val = rng.randn(b, k).astype(np.float32)
    idx[::3, -3:] = dims
    val[::3, -3:] = 0.0
    labels = rng.randint(0, num_labels, b).astype(np.int32)
    return idx, val, labels


STEP_CASES = [(r, L, mode) for r in MC_RULES for L in (1, 3, 7)
              for mode in ("scan", "minibatch")]


@pytest.mark.parametrize("name,L,mode", STEP_CASES,
                         ids=[f"{r}-L{L}-{m}" for r, L, m in STEP_CASES])
def test_make_mc_train_step_matches_jax(name, L, mode):
    jr, tr = mc_rules(name)
    hyper = MC_HYPER.get(name, {})
    d = warm_mc_numpy(L, DIMS, tr.use_covariance, seed=L, tie=True)
    idx, val, lab = mc_block(L, seed=L + 10)
    js, jl = JMC.make_mc_train_step(jr, hyper, mode)(jax_mc_state(d), idx,
                                                     val, lab)
    step = TMC.make_mc_train_step(tr, hyper, mode, device="cpu")
    ts, tl = step(TMC.mc_state_from_numpy(d, "cpu"), idx, val, lab)
    assert_mc_match(ts, jax_mc_numpy(js))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)


def test_missed_label_tie_takes_the_first_index():
    """Scores tied at 0.0 (a fresh state) and planted equal rows: the
    missed label is the first maximal index, in both packages."""
    tr = mc_rules("mc_perceptron")[1]
    d = warm_mc_numpy(5, 64, False, tie=True)
    d["weights"][3:] = d["weights"][1]  # labels 1..4 tie
    st = TMC.mc_state_from_numpy(d, "cpu")
    idx = np.array([[3, 9, 64, 64]], np.int32)  # two pad lanes
    val = np.array([[1.0, -2.0, 0.0, 0.0]], np.float32)
    lab = np.array([0], np.int32)
    w_before = d["weights"].copy()
    st, _ = TMC.make_mc_train_step(tr, {}, "scan", device="cpu")(st, idx,
                                                                 val, lab)
    w = st.weights.numpy()
    scores = w_before[:, [3, 9]] @ val[0, :2]
    if scores[0] - scores[1] <= 0.0:  # the perceptron fired: row 1 missed
        np.testing.assert_allclose(w[1, [3, 9]],
                                   w_before[1, [3, 9]] - val[0, :2])
        np.testing.assert_array_equal(w[2:], w_before[2:])
    jd = dict(d, step=np.int32(0))
    js, _ = JMC.make_mc_train_step(mc_rules("mc_perceptron")[0], {},
                                   "scan")(jax_mc_state(jd), idx, val, lab)
    np.testing.assert_array_equal(w, np.asarray(js.weights))


def train_rows(n=400, num_labels=4, dims=200, seed=3):
    """Ragged (idx, val) rows from a planted teacher, labels as strings
    (one label an int, so the vocabulary sorts by str)."""
    rng = np.random.RandomState(seed)
    teacher = rng.randn(num_labels, dims)
    idx_rows, val_rows, ys = [], [], []
    names = [f"L{i}" for i in range(num_labels - 1)] + [11]
    for _ in range(n):
        m = rng.randint(3, 12)
        idx = rng.randint(0, dims, m)
        idx[0] = idx[-1]  # a repeated id
        val = rng.rand(m).astype(np.float32)
        idx_rows.append(idx.astype(np.int64))
        val_rows.append(val)
        ys.append(names[int(np.argmax(teacher[:, idx] @ val))])
    return (idx_rows, val_rows), ys


TRAIN_CASES = [
    ("train_multiclass_perceptron", "-dims 256"),
    ("train_multiclass_pa", "-dims 256 -mini_batch 64"),
    ("train_multiclass_pa1", "-dims 256 -c 0.5"),
    ("train_multiclass_pa2", "-dims 256 -mini_batch 50 -iters 2"),
    ("train_multiclass_cw", "-dims 256 -eta 0.85"),
    ("train_multiclass_arow", "-dims 256 -block_size 128"),
    ("train_multiclass_arow", "-dims 256 -mini_batch 64 -iters 3"),
    ("train_multiclass_arowh", "-dims 256 -c 2.0"),
    ("train_multiclass_scw", "-dims 256 -phi 0.5 -mini_batch 32"),
    ("train_multiclass_scw2", "-dims 256 -iters 2"),
]


@pytest.mark.parametrize("name,opts", TRAIN_CASES,
                         ids=[f"{n[17:]}:{o}" for n, o in TRAIN_CASES])
def test_train_multiclass_matches_jax(name, opts):
    """Every block carries the port's last-bit differences forward, so the
    trained tables are held at rtol 1e-4 / atol 1e-5 (chip_smoke.py's
    tolerance); labels, vocabulary and model_rows' keys exactly."""
    feats, y = train_rows()
    jm = getattr(JMC, name)(feats, y, opts, num_classes=5)
    tm = getattr(TMC, name)(feats, y, opts, num_classes=5, device="cpu")
    assert tm.label_vocab == jm.label_vocab
    assert_mc_match(tm.state, jax_mc_numpy(jm.state), rtol=1e-4, atol=1e-5)
    assert tm.predict(feats) == jm.predict(feats)
    np.testing.assert_allclose(tm.scores(feats), np.asarray(jm.scores(feats)),
                               rtol=1e-4, atol=1e-5)
    trows, jrows = tm.model_rows(), jm.model_rows()
    assert len(trows) == len(jrows)
    assert trows[0] == jrows[0]
    np.testing.assert_array_equal(trows[1], np.asarray(jrows[1]))
    for a, b in zip(trows[2:], jrows[2:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_single_label_updates_only_its_row():
    feats, _ = train_rows(n=60)
    y = ["only"] * 60
    jm = JMC.train_multiclass_arow(feats, y, "-dims 256")
    tm = TMC.train_multiclass_arow(feats, y, "-dims 256", device="cpu")
    assert tm.label_vocab == ["only"]
    assert_mc_match(tm.state, jax_mc_numpy(jm.state))


def test_multiclass_refusals_and_device():
    tr = mc_rules("mc_arow")[1]
    # feature_shard runs since parallel/sharded_train.py landed; held
    # against JAX in tests/test_torch_parallel_families.py
    from torch_cases import one_rank_mesh

    with one_rank_mesh() as mesh:
        TMC.make_mc_train_step(tr, {"r": 0.1}, "minibatch",
                               feature_shard=(mesh, "workers", 8),
                               device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        TMC.make_mc_train_step(tr, {"r": 0.1}, "batch", device="cpu")
    import torch

    if not torch.cuda.is_available():
        feats, y = train_rows(n=10)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TMC.train_multiclass_arow(feats, y, "-dims 64")


def test_minibatch_covariance_divergence_matches_jax():
    """On head-heavy ids (log-uniform over the space, as the repo's CTR
    benchmark draws them) one AROW -mini_batch block sums so many
    covariance deltas on the head features that their covariances go
    negative — in both packages, equally: the reference's semantics, not
    a port fault."""
    rng = np.random.RandomState(5)
    dims, L, b, k = 1 << 16, 8, 4096, 64
    perm = rng.permutation(dims)
    idx = perm[np.exp(rng.random_sample((b, k)) * np.log(float(dims)))
               .astype(np.int64) % dims].astype(np.int32)
    val = np.ones((b, k), np.float32)
    lab = rng.randint(0, L, b).astype(np.int32)
    jr, tr = mc_rules("mc_arow")
    d = {"weights": np.zeros((L, dims), np.float32),
         "covars": np.ones((L, dims), np.float32),
         "touched": np.zeros((L, dims), np.int8), "step": np.int32(0)}
    js, _ = JMC.make_mc_train_step(jr, {"r": 0.1}, "minibatch")(
        jax_mc_state(d), idx, val, lab)
    ts, _ = TMC.make_mc_train_step(tr, {"r": 0.1}, "minibatch",
                                   device="cpu")(
        TMC.mc_state_from_numpy(d, "cpu"), idx, val, lab)
    want = jax_mc_numpy(js)
    assert want["covars"].min() < 0
    assert_mc_match(ts, want)
