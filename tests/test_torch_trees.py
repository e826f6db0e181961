"""The port's trees (hivemall_tpu_torch/models/trees/) against the JAX
package's (hivemall_tpu/models/trees/) on the CPU (`device="cpu"`).

The same numpy inputs go to both packages; the JAX functions are plain XLA
(no Pallas). Tolerances: binning, histograms on integer weights and
targets, routing, the walk, gini split gains and every tree's structure
(feature, threshold_bin, nominal, left, right, leaf_dist) are exact;
entropy gains, regression gains, leaf values and importances at rtol
1e-6; GBT decision scores at rtol 1e-5 / atol 1e-6. The port sums in the
JAX package's CPU order (grow.py's docstring), so float targets and GBT
residuals grow the same trees too. None of the JAX functions used here is
red on this tree (tests/test_trees.py passes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.adapters.model_rows import iter_model_rows as jax_iter
from hivemall_tpu.models.trees import binning as JB
from hivemall_tpu.models.trees import forest as JF
from hivemall_tpu.models.trees import grow as JG
from hivemall_tpu.models.trees import predict as JP
from hivemall_tpu.models.trees import vm as JV
from hivemall_tpu_torch import native as TN
from hivemall_tpu_torch.adapters.model_rows import iter_model_rows
from hivemall_tpu_torch.models.trees import binning as TB
from hivemall_tpu_torch.models.trees import forest as TF
from hivemall_tpu_torch.models.trees import grow as TG
from hivemall_tpu_torch.models.trees import predict as TP
from hivemall_tpu_torch.models.trees import vm as TV

from torch_cases import assert_trees_equal, tree_data

GAIN_RTOL = 1e-6
GBT_RTOL, GBT_ATOL = 1e-5, 1e-6
CPU = "cpu"


def _binned(X, attrs=None):
    attrs = attrs or ["Q"] * X.shape[1]
    bins = JB.make_bins(X, attrs)
    return bins, JB.bin_data(X, bins), max(b.n_bins for b in bins)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mixed_data(n=500, seed=3):
    """Two quantitative columns, one nominal (4 codes), a label over both
    kinds and an integer-valued target."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4)
    X[:, 2] = rng.randint(0, 4, n)
    y = ((X[:, 0] > 0.5) | (X[:, 2] == 1)).astype(int)
    yr = (np.floor(3 * X[:, 1]) + (X[:, 2] == 2)).astype(np.float32)
    return X, y, yr, ["Q", "Q", "C", "Q"]


def _assign(n, S, seed=0):
    """Frontier slots with a third of the rows settled (-1)."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, S, n).astype(np.int32)
    a[rng.rand(n) < 0.3] = -1
    return a


# ---- binning ----------------------------------------------------------------

def test_binning_matches_jax():
    X, _, _, attrs = _mixed_data()
    X[:7, 1] = X[0, 1]  # repeated values collapse quantile edges
    jb, tb = JB.make_bins(X, attrs), TB.make_bins(X, attrs)
    assert TB.MAX_BINS == JB.MAX_BINS == 64
    for a, b in zip(tb, jb):
        assert (a.nominal, a.n_bins) == (b.nominal, b.n_bins)
        assert a.edges.dtype == b.edges.dtype == np.float64
        np.testing.assert_array_equal(a.edges, b.edges)
    Xt = np.random.RandomState(9).rand(200, 4) * 1.2 - 0.1  # outside too
    Xt[:, 2] = np.arange(200) % 6
    got, want = TB.bin_data(Xt, tb), JB.bin_data(Xt, jb)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for f in range(4):
        for b in (0, 3, 500):
            assert TB.threshold_of(tb, f, b) == JB.threshold_of(jb, f, b)


# ---- histograms -------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 4])
def test_hist_classification_matches_jax(S):
    X, y, _ = tree_data()
    _, Xb, B = _binned(X)
    w = np.random.RandomState(1).randint(0, 4, len(y)).astype(np.float32)
    a = _assign(len(y), S)
    want = np.asarray(JG._hist_classification(
        jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w), jnp.asarray(a),
        S, B, 2))
    got = TG._hist_classification(_t(Xb), _t(y), _t(w), _t(a), S, B, 2)
    assert got.shape == (S, X.shape[1], B, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S", [1, 4])
def test_hist_regression_matches_jax(S):
    X, _, yr = tree_data()
    _, Xb, B = _binned(X)
    w = np.random.RandomState(2).randint(0, 3, len(yr)).astype(np.float32)
    a = _assign(len(yr), S, seed=1)
    want = np.asarray(JG._hist_regression(
        jnp.asarray(Xb), jnp.asarray(yr), jnp.asarray(w), S, B,
        jnp.asarray(a)))
    got = TG._hist_regression(_t(Xb), _t(yr), _t(w), S, B, _t(a))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["cls", "reg"])
def test_hist_forest_matches_jax(kind):
    X, y, yr = tree_data()
    _, Xb, B = _binned(X)
    G, S, n = 3, 2, len(y)
    rng = np.random.RandomState(4)
    W = rng.randint(0, 3, (G, n)).astype(np.float32)
    A = np.stack([_assign(n, S, seed=s) for s in range(G)])
    if kind == "cls":
        want = JG._hist_classification_forest(
            jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(W), jnp.asarray(A),
            S, B, 2)
        got = TG._hist_classification_forest(_t(Xb), _t(y), _t(W), _t(A), S,
                                             B, 2)
    else:
        Y = np.stack([yr, 2 * yr, -yr])  # per-tree targets
        want = JG._hist_regression_forest(
            jnp.asarray(Xb), jnp.asarray(Y), jnp.asarray(W), jnp.asarray(A),
            S, B)
        got = TG._hist_regression_forest(_t(Xb), _t(Y), _t(W), _t(A), S, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- split search -----------------------------------------------------------

@pytest.mark.parametrize("rule", ["gini", "entropy"])
@pytest.mark.parametrize("nominal", [False, True])
def test_best_split_classification_matches_jax(rule, nominal):
    X, y, _, attrs = _mixed_data()
    _, Xb, B = _binned(X, attrs)
    mask = np.array([a == "C" for a in attrs]) if nominal \
        else np.zeros(4, bool)
    S = 4
    a = _assign(len(y), S, seed=5)
    hist = np.asarray(JG._hist_classification(
        jnp.asarray(Xb), jnp.asarray(y), jnp.ones(len(y), jnp.float32),
        jnp.asarray(a), S, B, 2))
    feat_ok = np.random.RandomState(6).rand(S, 4) < 0.7
    feat_ok[:, 2] = True
    want = jax.device_get(JG._best_split_classification(
        jnp.asarray(hist), jnp.asarray(mask), jnp.asarray(feat_ok), rule,
        1.0))
    got = [t.numpy() for t in TG._best_split_classification(
        _t(hist), _t(mask), _t(feat_ok), rule, 1.0)]
    np.testing.assert_array_equal(got[1], want[1])  # feature
    np.testing.assert_array_equal(got[2], want[2])  # bin
    if rule == "gini":  # XLA's rounding, fused multiply-adds included
        np.testing.assert_array_equal(got[0], want[0])
    else:  # torch's log2 is not XLA's approximation
        np.testing.assert_allclose(got[0], want[0], rtol=GAIN_RTOL)
    np.testing.assert_array_equal(got[3], want[3])  # node counts


@pytest.mark.parametrize("targets", ["integer", "float"])
def test_best_split_regression_matches_jax(targets):
    X, _, yr, attrs = _mixed_data()
    if targets == "float":
        yr = (np.sin(5 * X[:, 0]) + 0.3 * X[:, 1]).astype(np.float32)
    _, Xb, B = _binned(X, attrs)
    mask = np.array([a == "C" for a in attrs])
    S = 2
    a = _assign(len(yr), S, seed=7)
    stats = np.asarray(JG._hist_regression(
        jnp.asarray(Xb), jnp.asarray(yr), jnp.ones(len(yr), jnp.float32), S,
        B, jnp.asarray(a)))
    feat_ok = np.ones((S, 4), bool)
    want = jax.device_get(JG._best_split_regression(
        jnp.asarray(stats), jnp.asarray(mask), jnp.asarray(feat_ok), 1.0))
    got = [t.numpy() for t in TG._best_split_regression(
        _t(stats), _t(mask), _t(feat_ok), 1.0)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for k in (0, 3, 4):  # gain, node count, node mean
        np.testing.assert_allclose(got[k], want[k], rtol=GAIN_RTOL)


def test_split_tie_takes_the_first_maximum():
    """Empty bins give exactly equal gains for neighbouring bins: the first
    wins in both packages."""
    hist = np.zeros((1, 2, 8, 2), np.float32)
    hist[0, :, 1, 0] = 5.0  # class 0 in bin 1, class 1 in bin 6: bins 1..5
    hist[0, :, 6, 1] = 5.0  # tie on both features
    ok = np.ones((1, 2), bool)
    nom = np.zeros(2, bool)
    want = jax.device_get(JG._best_split_classification(
        jnp.asarray(hist), jnp.asarray(nom), jnp.asarray(ok), "gini", 1.0))
    got = TG._best_split_classification(_t(hist), _t(nom), _t(ok), "gini",
                                        1.0)
    assert (int(got[1][0]), int(got[2][0])) == (0, 1) == \
        (int(want[1][0]), int(want[2][0]))


@pytest.mark.parametrize("n", [5, 33, 64, 100, 300])
def test_ordered_sums_match_xla_order(n):
    """The split search's sums and cumulative sums round as XLA's do on the
    CPU, bit for bit, for bin axes below, at and past its split sizes."""
    x = (np.random.RandomState(n).randn(3, 5, n, 2) * 100).astype(np.float32)
    np.testing.assert_array_equal(
        TG._ordered_sum(_t(x), 2).numpy(), np.asarray(jnp.sum(x, axis=2)))
    np.testing.assert_array_equal(
        TG._ordered_cumsum(_t(x), 2).numpy(),
        np.asarray(jnp.cumsum(x, axis=2)))


# ---- routing and the walk ---------------------------------------------------

def _route_tables(rng, S, F, B):
    return (rng.randint(0, F, S).astype(np.int32),
            rng.randint(0, B, S).astype(np.int32), rng.rand(S) < 0.3,
            rng.randint(0, 2 * S, S).astype(np.int32),
            rng.randint(0, 2 * S, S).astype(np.int32), rng.rand(S) < 0.25)


@pytest.mark.parametrize("group", [False, True])
def test_route_matches_jax(group):
    X, _, _ = tree_data()
    _, Xb, B = _binned(X)
    rng = np.random.RandomState(8)
    S, n = 4, len(X)
    if group:
        tabs = [np.stack(t) for t in zip(*[_route_tables(rng, S, 5, B)
                                           for _ in range(3)])]
        a = np.stack([_assign(n, S, seed=s) for s in range(3)])
        want = JG._update_assign_forest(jnp.asarray(Xb), jnp.asarray(a),
                                        *map(jnp.asarray, tabs))
    else:
        tabs = _route_tables(rng, S, 5, B)
        a = _assign(n, S)
        want = JG._update_assign(jnp.asarray(Xb), jnp.asarray(a),
                                 *map(jnp.asarray, tabs))
    got = TG._route(_t(Xb), _t(a), *map(_t, tabs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_depth", [64, 2])
def test_predict_forest_binned_matches_jax(max_depth):
    """Leaf values of every tree exact — also when the walk stops at an
    internal node (max_depth below the trees' depth)."""
    X, y, _ = tree_data()
    jf = JF.train_randomforest_classifier(X, y, "-trees 4 -seed 2")
    trees = [t.tree for t in jf.trees]
    Xb = JB.bin_data(X, jf.bins)
    assert max(t.max_depth_used for t in trees) > 2
    want = np.asarray(JG.predict_forest_binned(JG.stack_trees(trees), Xb,
                                               max_depth))
    got = TG.predict_forest_binned(TG.stack_trees(trees, CPU), Xb, max_depth)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TG.predict_binned(trees[1], Xb, max_depth, device=CPU),
        JG.predict_binned(trees[1], Xb, max_depth))


# ---- growth -----------------------------------------------------------------

GROW_CASES = {
    # name: (classification, rule, num_vars, nominal columns)
    "gini": (True, "gini", None, False),
    "entropy": (True, "entropy", None, False),
    "subspace": (True, "gini", 2, False),
    "nominal": (True, "gini", 2, True),
    "regression": (False, "gini", None, False),
    "regression_subspace": (False, "gini", 2, True),
}


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_tree_matches_jax(case):
    classification, rule, num_vars, nominal = GROW_CASES[case]
    X, y, yr, attrs = _mixed_data(n=600)
    if not nominal:
        attrs = ["Q"] * 4
    bins, Xb, B = _binned(X, attrs)
    mask = np.array([a == "C" for a in attrs])
    w = np.bincount(np.random.RandomState(3).randint(0, 600, 600),
                    minlength=600).astype(np.float32)
    kw = dict(classification=classification, n_classes=2, rule=rule,
              max_depth=6, min_split=2, min_leaf=1, max_leaf_nodes=40,
              num_vars=num_vars)
    target = y if classification else yr
    want = JG.grow_tree(Xb, target, w, mask, B,
                        rng=np.random.RandomState(11), **kw)
    before = TG.SYNCS["grow"]
    got = TG.grow_tree(Xb, target, w, mask, B,
                       rng=np.random.RandomState(11), device=CPU, **kw)
    assert_trees_equal(got, want)
    assert got.n_nodes > 7
    # one device-to-host copy per level grown (the last level may end it)
    assert TG.SYNCS["grow"] - before <= want.max_depth_used + 1


@pytest.mark.parametrize("classification", [True, False])
def test_grow_forest_batched_equals_per_tree_and_jax(classification):
    """tests/test_trees.py::TestForestBatchedGrowth, across the packages."""
    X, y, yr = tree_data()
    _, Xb, B = _binned(X)
    W = np.stack([np.bincount(np.random.RandomState(100 + t).randint(
        0, 400, 400), minlength=400).astype(np.float32) for t in range(5)])
    kw = dict(n_bins=B, classification=classification, n_classes=2,
              max_depth=6, min_split=2, min_leaf=1, max_leaf_nodes=64,
              num_vars=3)
    target = y if classification else yr

    def rngs():
        return [np.random.RandomState(200 + t) for t in range(5)]

    want = JG.grow_forest(Xb, target, W, np.zeros(5, bool), rngs=rngs(),
                          strategy="batched", **kw)
    batched = TG.grow_forest(Xb, target, W, np.zeros(5, bool), rngs=rngs(),
                             strategy="batched", device=CPU, **kw)
    per_tree = TG.grow_forest(Xb, target, W, np.zeros(5, bool), rngs=rngs(),
                              strategy="per_tree", device=CPU, **kw)
    for a, b, c in zip(batched, per_tree, want):
        assert_trees_equal(a, c)
        assert_trees_equal(b, c)


def test_grow_forest_small_hist_budget_chunks_groups():
    X, y, _ = tree_data(n=200, f=4, seed=3)
    _, Xb, B = _binned(X)
    W = np.ones((6, 200), np.float32)
    kw = dict(n_bins=B, classification=True, n_classes=2, max_depth=4,
              min_split=2, min_leaf=1, max_leaf_nodes=32, num_vars=None,
              strategy="batched")

    def rngs():
        return [np.random.RandomState(t) for t in range(6)]

    want = JG.grow_forest(Xb, y, W, np.zeros(4, bool), rngs=rngs(), **kw)
    big = TG.grow_forest(Xb, y, W, np.zeros(4, bool), rngs=rngs(),
                         device=CPU, **kw)
    before = TG.SYNCS["grow"]
    small = TG.grow_forest(Xb, y, W, np.zeros(4, bool), rngs=rngs(),
                           hist_budget_bytes=1, device=CPU, **kw)
    assert TG.SYNCS["grow"] - before > 6  # G = 1: one pass per tree
    for a, b, c in zip(big, small, want):
        assert_trees_equal(a, c)
        assert_trees_equal(b, c)


@pytest.mark.parametrize("strategy", ["batched", "per_tree"])
def test_grow_forest_per_tree_targets(strategy):
    rng = np.random.RandomState(11)
    X = rng.rand(300, 4)
    Y = np.stack([
        np.floor(3 * X[:, 0]), np.floor(5 * X[:, 2]),
        np.floor(2 * X[:, 1]) - np.floor(2 * X[:, 3])]).astype(np.float32)
    _, Xb, B = _binned(X)
    W = np.ones((3, 300), np.float32)
    kw = dict(n_bins=B, classification=False, max_depth=5, min_split=2,
              min_leaf=1, max_leaf_nodes=64, num_vars=None)
    got = TG.grow_forest(Xb, Y, W, np.zeros(4, bool),
                         rngs=[np.random.RandomState(t) for t in range(3)],
                         strategy=strategy, device=CPU, **kw)
    for t in range(3):
        want = JG.grow_tree(Xb, Y[t], W[t], np.zeros(4, bool),
                            rng=np.random.RandomState(t), **kw)
        assert_trees_equal(got[t], want)


def test_row_shard_and_strategy_are_refused_by_name():
    X, y, _ = tree_data(n=50)
    _, Xb, B = _binned(X)
    w = np.ones(50, np.float32)
    with pytest.raises(ValueError, match="later slice"):
        TG.grow_tree(Xb, y, w, np.zeros(5, bool), B, classification=True,
                     n_classes=2, row_shard=("mesh", "data"), device=CPU)
    with pytest.raises(ValueError, match="later slice"):
        TG.grow_forest(Xb, y, w[None], np.zeros(5, bool), B,
                       classification=True, n_classes=2,
                       row_shard=("mesh", "data"), device=CPU)
    with pytest.raises(ValueError, match="later slice"):
        TF.train_gradient_tree_boosting_classifier(
            X, y, "-trees 1", row_shard=("mesh", "data"), device=CPU)
    with pytest.raises(ValueError, match="unknown strategy"):
        TG.grow_forest(Xb, y, w[None], np.zeros(5, bool), B,
                       classification=True, n_classes=2, strategy="x",
                       device=CPU)


# ---- trainers ---------------------------------------------------------------

def _assert_forests_equal(tf, jf):
    assert (tf.classification, tf.n_classes, tf.attrs) == \
        (jf.classification, jf.n_classes, jf.attrs)
    assert len(tf.trees) == len(jf.trees)
    for a, b in zip(tf.trees, jf.trees):
        assert_trees_equal(a.tree, b.tree)
        assert (a.model_id, a.model_type, a.model) == \
            (b.model_id, b.model_type, b.model)
        assert (a.oob_errors, a.oob_tests) == (b.oob_errors, b.oob_tests)
        np.testing.assert_allclose(a.var_importance, b.var_importance,
                                   rtol=GAIN_RTOL)
    tc, trows = iter_model_rows(tf)
    jc, jrows = jax_iter(jf)
    assert tc == jc
    for a, b in zip(trows, jrows):
        assert a[:3] == b[:3] and a[4:] == b[4:]
        np.testing.assert_allclose(a[3], b[3], rtol=GAIN_RTOL)


@pytest.mark.parametrize("output", ["opscode", "json", "javascript"])
def test_rf_classifier_matches_jax(output):
    X, y, _, attrs = _mixed_data(n=400, seed=4)
    opts = f"-trees 4 -seed 5 -output {output} -attrs {','.join(attrs)}"
    jf = JF.train_randomforest_classifier(X, y, opts)
    tf = TF.train_randomforest_classifier(X, y, opts, device=CPU)
    _assert_forests_equal(tf, jf)
    np.testing.assert_array_equal(tf.predict(X), jf.predict(X))


@pytest.mark.parametrize("opts", ["-trees 4 -rule ENTROPY -seed 9",
                                  "-trees 5 -grow batched -seed 1",
                                  "-trees 3 -depth 3 -vars 0.5 -seed 2"])
def test_rf_classifier_options_match_jax(opts):
    X, y, _ = tree_data(n=300, f=6, seed=0)
    y = y + (X[:, 5] > 0.8)  # three classes
    jf = JF.train_randomforest_classifier(X, y, opts)
    tf = TF.train_randomforest_classifier(X, y, opts, device=CPU)
    _assert_forests_equal(tf, jf)


def test_rf_classifier_global_classes():
    X, y, _ = tree_data(n=200)
    labels = np.where(y == 1, "b", "c")
    opts = "-trees 2 -seed 4"
    jf = JF.train_randomforest_classifier(X, labels, opts,
                                          classes=["a", "b", "c"])
    tf = TF.train_randomforest_classifier(X, labels, opts,
                                          classes=["a", "b", "c"],
                                          device=CPU)
    assert tf.n_classes == 3
    _assert_forests_equal(tf, jf)
    with pytest.raises(ValueError, match="not in `classes`"):
        TF.train_randomforest_classifier(X, labels, opts, classes=["a"],
                                         device=CPU)


@pytest.mark.parametrize("targets", ["integer", "float"])
def test_rf_regr_matches_jax(targets):
    X, _, yr = tree_data(n=400, seed=2)
    if targets == "float":
        yr = 3.0 * X[:, 0] + np.sin(4 * X[:, 1])
    opts = "-trees 4 -seed 5"
    jf = JF.train_randomforest_regr(X, yr, opts)
    tf = TF.train_randomforest_regr(X, yr, opts, device=CPU)
    _assert_forests_equal(tf, jf)
    np.testing.assert_allclose(tf.predict(X), jf.predict(X), rtol=1e-6)


def _xor(n=500, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4)
    return X, ((X[:, 0] > 0.5) ^ (X[:, 1] > 0.5)).astype(int)


def _three_class(n=600):
    rng = np.random.RandomState(0)
    X = rng.rand(n, 4)
    return X, (X[:, 0] * 3).astype(int)


GBT_CASES = {  # tests/test_trees.py::TestGBT's data and options
    "binary": (_xor, "-trees 30 -eta 0.2 -depth 4 -seed 11"),
    "three_class": (_three_class, "-trees 20 -eta 0.2 -depth 3 -seed 12"),
}


@pytest.mark.parametrize("case", sorted(GBT_CASES))
def test_gbt_matches_jax(case):
    data, opts = GBT_CASES[case]
    X, y = data()
    jg = JF.train_gradient_tree_boosting_classifier(X, y, opts)
    tg = TF.train_gradient_tree_boosting_classifier(X, y, opts, device=CPU)
    assert len(tg.trees) == len(jg.trees)
    for a, b in zip(tg.trees, jg.trees):
        assert len(a) == len(b)
        for ta, tb in zip(a, b):
            assert_trees_equal(ta, tb)
    assert tg.intercept.dtype == np.float64
    np.testing.assert_array_equal(tg.intercept, jg.intercept)
    np.testing.assert_array_equal(tg.classes, jg.classes)
    np.testing.assert_allclose(tg.decision_function(X),
                               jg.decision_function(X), rtol=GBT_RTOL,
                               atol=GBT_ATOL)
    np.testing.assert_array_equal(tg.predict(X), jg.predict(X))
    assert tg.model_rows("json") == jg.model_rows("json")
    tc, trows = iter_model_rows(tg)
    jc, jrows = jax_iter(jg)
    assert tc == jc and list(trows) == list(jrows)


# ---- carrying models across -------------------------------------------------

def test_forest_and_gbt_from_numpy_carry_jax_models():
    X, y, _, attrs = _mixed_data(n=300)
    jf = JF.train_randomforest_classifier(
        X, y, f"-trees 3 -seed 1 -attrs {','.join(attrs)}")
    tf = TF.forest_from_numpy(jf.trees, jf.bins, jf.classification,
                              jf.n_classes, jf.attrs, device=CPU)
    assert isinstance(tf, TF.TrainedForest)
    _assert_forests_equal(tf, jf)
    np.testing.assert_array_equal(tf.predict(X), jf.predict(X))
    Xg, yg = _three_class(300)
    jg = JF.train_gradient_tree_boosting_classifier(
        Xg, yg, "-trees 4 -depth 3 -seed 2")
    tg = TF.gbt_from_numpy(jg.trees, jg.intercept, jg.shrinkage, jg.classes,
                           jg.bins, device=CPU)
    assert isinstance(tg, TF.TrainedGBT)
    np.testing.assert_allclose(tg.decision_function(Xg),
                               jg.decision_function(Xg), rtol=GBT_RTOL,
                               atol=GBT_ATOL)
    np.testing.assert_array_equal(tg.predict(Xg), jg.predict(Xg))
    assert tg.model_rows() == jg.model_rows()


# ---- export, VM and predict copies ------------------------------------------

def test_export_vm_and_tree_predict_match_jax():
    X, y, _, attrs = _mixed_data(n=300)
    jf = JF.train_randomforest_classifier(
        X, y, f"-trees 2 -seed 3 -attrs {','.join(attrs)}")
    from hivemall_tpu.models.trees import export as JE
    from hivemall_tpu_torch.models.trees import export as TE

    assert TE.MODEL_TYPE_IDS == JE.MODEL_TYPE_IDS
    for t in jf.trees:
        for fmt in ("to_opscode", "to_json", "to_javascript"):
            text = getattr(TE, fmt)(t.tree, jf.bins)
            assert text == getattr(JE, fmt)(t.tree, jf.bins)
        ops = TE.to_opscode(t.tree, jf.bins)
        for got, want in zip(TV.compile_script_arrays(ops),
                             JV.compile_script_arrays(ops)):
            np.testing.assert_array_equal(got, want)
        for x in X[:25]:
            for mt, text in (("opscode", ops),
                             ("json", TE.to_json(t.tree, jf.bins)),
                             ("javascript", TE.to_javascript(t.tree,
                                                             jf.bins))):
                assert TP.tree_predict(mt, text, x, True) == \
                    JP.tree_predict(mt, text, x, True)
    assert TP.guess_attrs([1.5, "tokyo", 3, True]) == \
        JP.guess_attrs([1.5, "tokyo", 3, True])
    with pytest.raises(ValueError, match="javascript tree"):
        TP.tree_predict("javascript", "alert('hi');", [0.0])
    with pytest.raises(TV.VMRuntimeError):
        TV.StackMachine().run("goto 0", [0.0])


def test_native_forest_eval_matches_stack_machine():
    """hm_forest_eval through the port's binding == StackMachine on every
    (tree, row), numeric and nominal splits, class and regression leaves;
    each call counts in native.CALLS."""
    X, y, yr, attrs = _mixed_data(n=300)
    opts = f"-trees 4 -depth 6 -seed 1 -attrs {','.join(attrs)}"
    for forest in (TF.train_randomforest_classifier(X, y, opts, device=CPU),
                   TF.train_randomforest_regr(X, yr, opts, device=CPU)):
        scripts = [t.model for t in forest.trees]
        before = TN.CALLS["forest_eval"]
        out = TN.forest_eval([TV.compile_script_arrays(s) for s in scripts],
                             X)
        assert TN.CALLS["forest_eval"] == before + 1
        assert out.shape == (4, 300) and out.dtype == np.float64
        sm = TV.StackMachine()
        for t, s in enumerate(scripts):
            sm.compile(s)
            for r in range(0, 300, 7):
                assert out[t, r] == sm.eval(X[r]), (t, r)
    bad = (np.array([3], np.int8), np.zeros(1, np.int32), np.zeros(1))
    with pytest.raises(ValueError, match="malformed"):
        TN.forest_eval([bad], np.zeros((2, 2)))
