"""The port's row-sharded trees and multi-process forests
(hivemall_tpu_torch/parallel/forest_shard.py, models/trees/grow.py's
row_shard) against the JAX package's.

Row-sharded growth runs in n gloo ranks on the CPU (tests/torch_cases.py
run_ranks) against JAX's on make_mesh(n): the row-sharded forest equals
the unsharded one node for node (class-count histograms are integer
sums, exact in any order); GBT is held as JAX holds its own data-parallel
GBT, decision function within rtol 1e-3 / atol 1e-3
(tests/test_forest_shard.py), its residual histograms being float sums in
gloo's order. Forest sharding by trees needs no collective: each rank's
shard equals JAX's shard of the same process index, model row for model
row.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hivemall_tpu.models.trees import grow as JG
from hivemall_tpu.models.trees.binning import bin_data, make_bins
from hivemall_tpu.parallel import forest_shard as JFS
from hivemall_tpu.parallel import make_mesh as jmake_mesh
from hivemall_tpu_torch.models.trees import grow as TG
from hivemall_tpu_torch.parallel import forest_shard as TFS
from hivemall_tpu_torch.parallel import make_mesh
from torch_cases import (assert_trees_equal, one_rank_mesh, run_ranks,
                         scenario)

GBT_TOL = dict(rtol=1e-3, atol=1e-3)
TREE_FIELDS = ("feature", "threshold_bin", "nominal", "left", "right",
               "leaf_dist", "leaf_value")


def _gen(n=1200, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 6)
    y = ((X[:, 0] > 0.5) ^ (X[:, 2] > 0.5)).astype(int)
    return X, y


def _multiclass(n=600):
    rng = np.random.RandomState(7)
    X = rng.rand(n, 5)
    return X, (X[:, 0] > 0.6).astype(int) + (X[:, 1] > 0.5).astype(int)


def _binned(n=500, seed=3):
    X, y = _gen(n, seed)
    bins = make_bins(X, ["Q"] * X.shape[1])
    return np.asarray(bin_data(X, bins)), y, max(b.n_bins for b in bins)


def _tree_dict(trees):
    return {f"t{i}": {k: getattr(t, k) for k in TREE_FIELDS}
            for i, t in enumerate(trees)}


GBT_OPTS = "-trees 12 -iters 12 -depth 4 -seed 5"
MC_OPTS = "-trees 8 -iters 8 -depth 4 -seed 2"
FOREST_KW = dict(classification=True, n_classes=2, max_depth=5)


# ---- the port's side (spawned ranks) ---------------------------------------

def sc_gbt_binary(rank, n):
    X, y = _gen(999)  # 999 rows: the row slices pad
    m = TFS.train_gbt_data_parallel(X, y, GBT_OPTS, make_mesh(device="cpu"))
    return {"decision": m.decision_function(X), "pred": m.predict(X)}


def sc_gbt_multiclass(rank, n):
    X, y = _multiclass()
    m = TFS.train_gbt_data_parallel(X, y, MC_OPTS, make_mesh(device="cpu"))
    return {"decision": m.decision_function(X), "pred": m.predict(X)}


def sc_gbt_unseeded(rank, n):
    """Without -seed the ranks draw one seed together: every rank grows
    the same trees."""
    from hivemall_tpu_torch.parallel.mesh import all_gather_host

    mesh = make_mesh(device="cpu")
    X, y = _gen(400)
    m = TFS.train_gbt_data_parallel(X, y, "-trees 3 -iters 3 -depth 3",
                                    mesh)
    d = all_gather_host(torch.from_numpy(m.decision_function(X)), mesh,
                        "workers")
    return {"agree": bool((d == d[0]).all())}


def sc_forest_rows(rank, n):
    Xb, y, n_bins = _binned()
    W = np.ones((4, len(y)), np.float32)
    mesh = make_mesh(device="cpu")
    got = TG.grow_forest(Xb, y, W, np.zeros(6, bool), n_bins,
                         rngs=[np.random.RandomState(t) for t in range(4)],
                         row_shard=(mesh, "workers"), device="cpu",
                         **FOREST_KW)
    return _tree_dict(got)


def sc_rf_by_trees(rank, n):
    """Each rank grows its share of a 12-tree forest on its own row stripe
    (rank and world size from torch.distributed)."""
    X, y = _gen()
    f = TFS.train_randomforest_sharded(X[rank::n], y[rank::n],
                                       "-trees 12 -depth 8 -seed 5",
                                       classes=[0, 1], device="cpu")
    rows = [None] * n
    dist.all_gather_object(rows, f.model_rows())
    merged = [r for part in rows for r in part]
    return {"ids": np.array([r[0] for r in merged]),
            "pred": TFS.ensemble_predict_rows(merged, X[:300],
                                              classes=[0, 1])}


SCENARIOS = ["sc_gbt_binary", "sc_gbt_multiclass", "sc_gbt_unseeded",
             "sc_forest_rows", "sc_rf_by_trees"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("forest")
    return {n: run_ranks("test_torch_forest_shard", SCENARIOS, n, tmp)
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_gbt_data_parallel_binary_matches_jax(worlds, n):
    got = scenario(worlds[n], "sc_gbt_binary")
    X, y = _gen(999)
    want = JFS.train_gbt_data_parallel(X, y, GBT_OPTS, jmake_mesh(n))
    np.testing.assert_allclose(got["decision"], want.decision_function(X),
                               **GBT_TOL)
    assert np.mean(got["pred"] == want.predict(X)) > 0.98


@pytest.mark.parametrize("n", [2, 4])
def test_gbt_data_parallel_multiclass_matches_jax(worlds, n):
    got = scenario(worlds[n], "sc_gbt_multiclass")
    X, y = _multiclass()
    want = JFS.train_gbt_data_parallel(X, y, MC_OPTS, jmake_mesh(n))
    np.testing.assert_allclose(got["decision"], want.decision_function(X),
                               **GBT_TOL)
    assert np.mean(got["pred"] == y) > 0.8


@pytest.mark.parametrize("n", [2, 4])
def test_gbt_unseeded_ranks_grow_the_same_trees(worlds, n):
    assert bool(scenario(worlds[n], "sc_gbt_unseeded")["agree"])


@pytest.mark.parametrize("n", [2, 4])
def test_row_sharded_forest_matches_unsharded(worlds, n):
    """grow_forest(row_shard=...) over n ranks == the port's unsharded
    forest == JAX's row-sharded forest on n devices, node for node."""
    got = scenario(worlds[n], "sc_forest_rows")
    Xb, y, n_bins = _binned()
    W = np.ones((4, len(y)), np.float32)
    ref = TG.grow_forest(Xb, y, W, np.zeros(6, bool), n_bins,
                         rngs=[np.random.RandomState(t) for t in range(4)],
                         device="cpu", **FOREST_KW)
    mesh = jmake_mesh(n)
    jax_trees = JG.grow_forest(
        Xb, y, W, np.zeros(6, bool), n_bins,
        rngs=[np.random.RandomState(t) for t in range(4)],
        row_shard=(mesh, mesh.axis_names[0]), **FOREST_KW)
    for t in range(4):
        tree = TG.TreeArrays(n_nodes=len(got[f"t{t}"]["feature"]),
                             **got[f"t{t}"])
        assert_trees_equal(tree, ref[t])
        assert_trees_equal(tree, jax_trees[t])


@pytest.mark.parametrize("n", [2, 4])
def test_forest_sharded_by_trees_matches_jax(worlds, n):
    """Disjoint model ids 0..11 over the ranks, and the merged rows vote
    as JAX's merged shards do."""
    got = scenario(worlds[n], "sc_rf_by_trees")
    X, y = _gen()
    rows = []
    for p in range(n):
        rows += JFS.train_randomforest_sharded(
            X[p::n], y[p::n], "-trees 12 -depth 8 -seed 5", classes=[0, 1],
            process_index=p, process_count=n).model_rows()
    np.testing.assert_array_equal(np.sort(got["ids"]), np.arange(12))
    np.testing.assert_array_equal(
        got["pred"], JFS.ensemble_predict_rows(rows, X[:300],
                                               classes=[0, 1]))
    assert np.mean(got["pred"] == y[:300]) > 0.9


# ---- no collective ---------------------------------------------------------

def test_shard_tree_counts_and_option_split_match_jax():
    for total, p in ((50, 4), (7, 3), (2, 4), (12, 1)):
        assert TFS.shard_tree_counts(total, p) == \
            JFS.shard_tree_counts(total, p)
    for opt in ("-trees 8 -depth 4 -seed 9", "-num_trees 100",
                "--trees 64", "--num_trees 9 --seed 4",
                '-trees 4 -attrs "Q, Q"'):
        assert TFS._split_opt(opt) == JFS._split_opt(opt)
    with pytest.raises(ValueError):
        TFS._split_opt("-depth 4 -trees")


@pytest.mark.parametrize("classification", [True, False])
def test_sharded_shards_equal_jax_row_for_row(classification):
    """train_randomforest_sharded with an explicit process index grows the
    JAX shard's trees: the same model rows (ids, opcode text), and
    ensemble_predict_rows (native forest_eval) votes the same."""
    rng = np.random.RandomState(2)
    X = rng.rand(600, 5)
    y = (X[:, 0] > 0.5).astype(int) if classification \
        else (np.floor(4 * X[:, 1])).astype(np.float32)
    opts = "-trees 5 -depth 6 -seed 9"
    got, want = [], []
    for p in range(2):
        kw = dict(classification=classification, process_index=p,
                  process_count=2)
        got += TFS.train_randomforest_sharded(X[p::2], y[p::2], opts,
                                              device="cpu", **kw).model_rows()
        want += JFS.train_randomforest_sharded(X[p::2], y[p::2], opts,
                                               **kw).model_rows()
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose(
        TFS.ensemble_predict_rows(got, X[:100], classification),
        JFS.ensemble_predict_rows(want, X[:100], classification))


def test_zero_tree_shard_and_refusals():
    X, y = _gen(300)
    f = TFS.train_randomforest_sharded(X, y, "-trees 2 -depth 4 -seed 1",
                                       process_index=3, process_count=4,
                                       device="cpu")
    assert f.model_rows() == []
    with pytest.raises(ValueError):
        TFS.train_randomforest_sharded(X, y.astype(float),
                                       classification=False, classes=[0, 1],
                                       process_index=0, process_count=1,
                                       device="cpu")
    with pytest.raises(ValueError):
        TFS.ensemble_predict_rows([], np.zeros((3, 2)))


def test_row_shard_at_world_one_is_the_unsharded_growth():
    """One rank's partial histogram is the whole one: grow_tree,
    grow_forest and the GBT trainer with row_shard at world size 1 equal
    the unsharded growth node for node."""
    from hivemall_tpu_torch.models.trees import forest as TF

    Xb, y, n_bins = _binned(300)
    w = np.ones(len(y), np.float32)
    X, yg = _gen(300)
    with one_rank_mesh() as mesh:
        rs = (mesh, "workers")
        assert_trees_equal(
            TG.grow_tree(Xb, y, w, np.zeros(6, bool), n_bins, row_shard=rs,
                         device="cpu", **FOREST_KW),
            TG.grow_tree(Xb, y, w, np.zeros(6, bool), n_bins, device="cpu",
                         **FOREST_KW))
        got = TF.train_gradient_tree_boosting_classifier(
            X, yg, "-trees 3 -iters 3 -depth 3 -seed 1", row_shard=rs,
            device="cpu")
    want = TF.train_gradient_tree_boosting_classifier(
        X, yg, "-trees 3 -iters 3 -depth 3 -seed 1", device="cpu")
    np.testing.assert_array_equal(got.decision_function(X),
                                  want.decision_function(X))


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_rank_histogram_builds_only_its_rows(monkeypatch, group, n):
    """_sharded_hist hands _scatter_hist only this rank's rows [r * ceil(N /
    n), (r + 1) * ceil(N / n)): each rank's partial equals the unsharded
    build with every other row settled, bit for bit, the ranks' row counts
    add up to N, and the partials (integer weights, so exact) sum to the
    unsharded histogram (one tree, and a batched group of trees)."""
    from hivemall_tpu_torch.core.collectives import Mesh

    Xb, y, n_bins = _binned(301)
    N, F = Xb.shape
    G = 3 if group else 1
    offsets = TG._lane_offsets(torch.as_tensor(Xb), n_bins, 2,
                               torch.as_tensor(y))
    rng = np.random.RandomState(n)
    slot = torch.as_tensor(rng.randint(-1, 4, (G, N)), dtype=torch.int64)
    slot = slot + 4 * torch.arange(G)[:, None] * (slot >= 0)
    w = torch.as_tensor(rng.randint(1, 4, (G, N)).astype(np.float32))
    if not group:
        slot, w = slot[0], w[0]
    values = (TG._lanes(w, F),)
    n_slots, block = 4 * G, F * n_bins * 2
    scatter, rows = TG._scatter_hist, []

    def counted(o, s_, *a):
        rows.append(s_.shape[-1])
        return scatter(o, s_, *a)

    monkeypatch.setattr(TG, "_scatter_hist", counted)
    monkeypatch.setattr(TG, "psum", lambda x, mesh, axis: x)
    per = -(-N // n)
    total = torch.zeros(1, n_slots * block)
    for r in range(n):
        mesh = Mesh(axis_names=("workers",), shape={"workers": n},
                    coords={"workers": r}, groups={"workers": None},
                    device=torch.device("cpu"))
        part = TG._sharded_hist(offsets, slot, n_slots, block, values,
                                (mesh, "workers"))
        row = torch.arange(N)
        mine = (row >= r * per) & (row < (r + 1) * per)
        torch.testing.assert_close(
            part, scatter(offsets, torch.where(mine, slot, -1), n_slots,
                          block, values), rtol=0, atol=0)
        total += part
    assert rows == [min(per, N - r * per) for r in range(n)]
    assert sum(rows) == N
    torch.testing.assert_close(
        total, scatter(offsets, slot, n_slots, block, values),
        rtol=0, atol=0)
