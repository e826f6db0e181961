"""The port's SQLite binding (hivemall_tpu_torch/adapters/sqlite.py) against
the JAX package's (hivemall_tpu/adapters/sqlite.py): the same SQL over the
same seeded rows in two connections, one per package, must give the same
model tables (rtol 2e-5 / atol 1e-6, integer and text columns exact) and
the same pure-SQL scores. The port trains with device="cpu" here; without
a device it raises where there is no CUDA device."""

import json

import numpy as np
import pytest
import torch

from hivemall_tpu.adapters import sqlite as jsql
from hivemall_tpu_torch.adapters import sqlite as tsql

RTOL, ATOL = 2e-5, 1e-6
FFM_TOL = (1e-4, 1e-5)
SRC = "SELECT features, label FROM train"


@pytest.fixture()
def conns():
    cj, ct = jsql.connect(), tsql.connect(device="cpu")
    yield cj, ct
    cj.close()
    ct.close()


def _both(conns, sql, params=()):
    return [c.execute(sql, params).fetchall() for c in conns]


def _make_dataset(conns, n=400, d=32, seed=11):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d)
    rows = []
    for i in range(n):
        idx = rng.choice(d, size=6, replace=False)
        y = 1.0 if w_true[idx].sum() > 0 else -1.0
        rows.append((i, " ".join(f"{j}:1" for j in idx), y))
    for c in conns:
        c.execute("CREATE TABLE train (id INTEGER, features TEXT, label REAL)")
        c.executemany("INSERT INTO train VALUES (?,?,?)", rows)
    return rows


def _cell_close(a, b, where, tol):
    if isinstance(b, float) or isinstance(a, float):
        np.testing.assert_allclose(a, b, *tol, err_msg=where)
    elif isinstance(b, str) and b.startswith("[") and b.endswith("]"):
        np.testing.assert_allclose(np.asarray(json.loads(a), np.float64),
                                   np.asarray(json.loads(b), np.float64),
                                   *tol, err_msg=where)
    else:
        assert a == b, (where, a, b)


def assert_rows_match(got, want, what="", tol=(RTOL, ATOL)):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (rg, rw) in enumerate(zip(got, want)):
        assert len(rg) == len(rw), (what, i)
        for j, (a, b) in enumerate(zip(rg, rw)):
            _cell_close(a, b, f"{what} row {i} col {j}", tol)


def assert_tables_match(conns, table, order="1, 2", tol=(RTOL, ATOL)):
    cj, ct = conns
    cols = [[r[1:3] for r in c.execute(f"PRAGMA table_info({table})")]
            for c in (ct, cj)]
    assert cols[0] == cols[1], cols
    got, want = (c.execute(f"SELECT * FROM {table} ORDER BY {order}")
                 .fetchall() for c in (ct, cj))
    assert_rows_match(got, want, table, tol)


def _train_both(conns, trainer, opts, table="model", src=SRC, **kw):
    cj, ct = conns
    mj = jsql.train(cj, trainer, src, options=opts, model_table=table, **kw)
    mt = tsql.train(ct, trainer, src, options=opts, model_table=table,
                    device="cpu", **kw)
    return mj, mt


# ------------------------------------------------------------- the library

SCALAR_SQL = [
    "SELECT sigmoid(0.3)", "SELECT sigmoid(-30.0)", "SELECT mhash('hello')",
    "SELECT idf(3.0, 100.0)", "SELECT tfidf(0.5, 3.0, 100.0)",
    "SELECT max2(3, 7)", "SELECT min2(3, 7)", "SELECT rescale(3.0, 1.0, 9.0)",
    "SELECT zscore(3.0, 1.0, 2.0)", "SELECT extract_feature('height:1.8')",
    "SELECT extract_weight('height:1.8')", "SELECT feature('a', 2.5)",
    "SELECT add_bias('1:2.0 5:1.0')", "SELECT l2_normalize('1:3 2:4')",
    "SELECT sort_by_feature('9:1 2:1 5:1')",
    "SELECT cosine_similarity('1:1 2:1', '1:1 3:2')",
    "SELECT jaccard_similarity('1:1 2:1', '1:1 3:2')",
    "SELECT angular_similarity('1:1 2:1', '1:1 3:2')",
    "SELECT euclid_similarity('1:1 2:1', '1:1 3:2')",
    "SELECT cosine_distance('1:1 2:1', '1:1 3:2')",
    "SELECT euclid_distance('1:1 2:1', '1:1 3:2')",
    "SELECT manhattan_distance('1:1 2:1', '1:1 3:2')",
    "SELECT jaccard_distance('1:1 2:1', '1:1 3:2')",
    "SELECT hamming_distance(12, 10)", "SELECT popcnt(255)",
    "SELECT tokenize('Hello, SQL world')",
    "SELECT tokenize_ja('関西国際空港に行きました')",
    "SELECT mf_predict('[1, 2]', '[0.5, 0.25]', 0.1, 0.2, 3.0)",
    "SELECT bprmf_predict('[1, 0]', '[0.5, 2]', 0.25)",
    "SELECT mf_predict(NULL, '[1, 2]')",
]


@pytest.mark.parametrize("sql", SCALAR_SQL)
def test_scalar_functions_match(conns, sql):
    got, want = _both(conns[::-1], sql)
    assert_rows_match(got, want, sql)


def test_features_text_json_and_space_forms():
    for text in ('["1:2", "3:4"]', "1:2 3:4", None, "  ", "[]"):
        assert tsql.parse_features(text) == jsql.parse_features(text)
    assert tsql.parse_dense("[1, 2.5]") == jsql.parse_dense("1 2.5") \
        == [1.0, 2.5]


@pytest.mark.parametrize("agg", ["logloss", "mae", "mse", "rmse", "r2", "auc"])
def test_streaming_aggregates_match(conns, agg):
    rng = np.random.RandomState(3)
    p = rng.rand(64)
    y = (rng.rand(64) < p).astype(float)
    for c in conns:
        c.execute("CREATE TABLE t (p REAL, y REAL)")
        c.executemany("INSERT INTO t VALUES (?,?)",
                      [(float(a), float(b)) for a, b in zip(p, y)])
    got, want = _both(conns[::-1], f"SELECT {agg}(p, y) FROM t")
    assert_rows_match(got, want, agg)
    from hivemall_tpu_torch import evaluation

    if agg != "auc":
        assert got[0][0] == pytest.approx(
            float(getattr(evaluation, agg)(p, y)), rel=1e-6)


def test_ensemble_and_f1_aggregates_match(conns):
    for c in conns:
        c.execute("CREATE TABLE m (g INTEGER, v REAL, c REAL, lab TEXT, "
                  "vote INTEGER, a TEXT, b TEXT)")
        c.executemany("INSERT INTO m VALUES (?,?,?,?,?,?,?)", [
            (1, 0.5, 1.0, "x", 1, "1 2", "2 3"),
            (1, -0.7, 0.5, "y", 0, "4", "4"),
            (1, 0.9, 0.2, "z", 1, "5 6", "6"),
            (2, -0.2, 2.0, "x", 2, "7", "8"),
            (2, -0.4, 1.0, "y", 2, "9 10", "9")])
    for sql in ("SELECT g, voted_avg(v) FROM m GROUP BY g",
                "SELECT g, weight_voted_avg(v) FROM m GROUP BY g",
                "SELECT g, argmin_kld(v, c) FROM m GROUP BY g",
                "SELECT g, max_label(v, lab) FROM m GROUP BY g",
                "SELECT g, rf_ensemble(vote) FROM m GROUP BY g",
                "SELECT f1score(a, b) FROM m"):
        got, want = _both(conns[::-1], sql)
        assert_rows_match(got, want, sql)


# ------------------------------------------------------------ linear family

LINEAR_CASES = [
    ("train_arow", "-dims 32"),
    ("train_arow", "-dims 32 -pallas"),
    ("train_arow", "-dims 32 -mini_batch 16"),
    ("train_perceptron", "-dims 32"),
    ("train_pa1", "-dims 32"),
    ("train_scw", "-dims 32"),
    ("train_adagrad_rda", "-dims 32"),
    ("train_arow_regr", "-dims 32"),
]


@pytest.mark.parametrize("trainer,opts", LINEAR_CASES,
                         ids=[f"{t}{o.replace('-dims 32', '')}"
                              for t, o in LINEAR_CASES])
def test_linear_tables_and_pure_sql_scores(conns, trainer, opts):
    rows = _make_dataset(conns)
    _, mt = _train_both(conns, trainer, opts)
    assert_tables_match(conns, "model")
    for c, mod in zip(conns, (jsql, tsql)):
        mod.explode_features(c, "SELECT id, features FROM train",
                             out_table="ex", num_features=32)
    assert_tables_match(conns, "ex", order="1, 2, 3")
    plan = """SELECT ex.rowid, sigmoid(SUM(m.weight * ex.value))
              FROM ex JOIN model m ON m.feature = ex.feature
              GROUP BY ex.rowid ORDER BY ex.rowid"""
    got, want = _both(conns[::-1], plan)
    assert_rows_match(got, want, "scores")
    # the SQL scores are the port's own predict
    fw = np.asarray(mt.predict([r[1].split() for r in rows]))
    np.testing.assert_allclose([p for _, p in got], 1 / (1 + np.exp(-fw)),
                               rtol=1e-5, atol=1e-6)


def test_sql_evaluation_of_sql_scores(conns):
    _make_dataset(conns)
    _train_both(conns, "train_logistic_regr", "-dims 32",
                src="SELECT features, (label + 1) / 2.0 FROM train")
    assert_tables_match(conns, "model")
    for c, mod in zip(conns, (jsql, tsql)):
        mod.explode_features(c, "SELECT id, features FROM train",
                             out_table="ex", num_features=32)
    got, want = _both(conns[::-1], """
        WITH scores AS (
          SELECT ex.rowid AS id, sigmoid(SUM(m.weight * ex.value)) AS prob
          FROM ex JOIN model m ON m.feature = ex.feature GROUP BY ex.rowid)
        SELECT logloss(s.prob, (t.label + 1) / 2.0), auc(s.prob, t.label)
        FROM scores s JOIN train t ON t.id = s.id""")
    assert_rows_match(got, want, "logloss/auc")
    assert 0.0 < got[0][0] < 0.55


def test_string_features_hash_like_the_jax_package(conns):
    rng = np.random.RandomState(0)
    names = [f"word{i}" for i in range(50)]
    rows = [(i, " ".join(f"{n}:1" for n in rng.choice(names, 5, False)),
             float(rng.choice([-1.0, 1.0]))) for i in range(200)]
    for c in conns:
        c.execute("CREATE TABLE train (id INTEGER, features TEXT, label REAL)")
        c.executemany("INSERT INTO train VALUES (?,?,?)", rows)
    _train_both(conns, "train_arow", "-dims 1024")
    assert_tables_match(conns, "model")
    for c, mod in zip(conns, (jsql, tsql)):
        mod.explode_features(c, "SELECT id, features FROM train", "ex",
                             num_features=1024)
    assert_tables_match(conns, "ex", order="1, 2, 3")
    with pytest.raises(ValueError, match="num_features"):
        tsql.explode_features(conns[1], "SELECT id, features FROM train",
                              "ex2")


def test_int_ids_floor_mod_like_the_trainer(conns):
    for c in conns:
        c.execute("CREATE TABLE oor (id INTEGER, features TEXT, label REAL)")
        c.execute("INSERT INTO oor VALUES (0, '70:1 -7:1', 1.0)")
    _train_both(conns, "train_perceptron", "-dims 64",
                src="SELECT features, label FROM oor")
    assert_tables_match(conns, "model")
    ct = conns[1]
    tsql.explode_features(ct, "SELECT id, features FROM oor", "oorex",
                          num_features=64)
    exploded = {f for (f,) in ct.execute("SELECT feature FROM oorex")}
    trained = {f for (f,) in ct.execute("SELECT feature FROM model")}
    assert exploded == {70 % 64, -7 % 64} and exploded <= trained
    with pytest.raises(ValueError, match="negative"):
        tsql.explode_features(ct, "SELECT id, features FROM oor", "oorex2")


# ----------------------------------------------------- FM, FFM, multiclass

def test_fm_table_and_sql_fm_predict(conns):
    rows = _make_dataset(conns)
    _, mt = _train_both(conns, "train_fm",
                        "-dims 32 -factors 4 -classification -iters 2")
    assert_tables_match(conns, "model")
    for c, mod in zip(conns, (jsql, tsql)):
        mod.explode_features(c, "SELECT id, features FROM train",
                             out_table="fmex", num_features=32)
        c.execute("INSERT INTO fmex SELECT DISTINCT rowid, -1, 1.0 FROM fmex")
    got, want = _both(conns[::-1], """
        SELECT fmex.rowid, fm_predict(m.wi, m.vif, fmex.value)
        FROM fmex JOIN model m ON m.feature = fmex.feature
        GROUP BY fmex.rowid ORDER BY fmex.rowid""")
    assert_rows_match(got, want, "fm scores")
    fw = np.asarray(mt.predict([r[1].split() for r in rows]))
    np.testing.assert_allclose([s for _, s in got], fw, rtol=2e-4, atol=2e-4)


def test_ffm_table_blob_and_sql_ffm_predict(conns):
    """FFM's blocks carry last-bit differences forward: its tables and
    scores are held at rtol 1e-4 / atol 1e-5, as tests/test_torch_ffm.py
    holds a whole train_ffm run against the JAX package's."""
    rows = _make_dataset(conns)
    _, mt = _train_both(conns, "train_ffm", "-feature_hashing 8 -factors 2")
    assert_tables_match(conns, "model", tol=FFM_TOL)
    assert [c.execute("SELECT COUNT(*) FROM model_blob").fetchone()[0]
            for c in conns] == [1, 1]
    plan = """SELECT t.id, ffm_predict(b.model, t.features)
              FROM train t CROSS JOIN model_blob b ORDER BY t.id LIMIT 64"""
    got, want = _both(conns[::-1], plan)
    # a blob stores half floats: two packages' blobs of models a last bit
    # apart may round a value to neighbouring halves
    assert_rows_match(got, want, "ffm scores", (5e-3, 5e-3))
    fw = np.asarray(mt.predict([r[1].split() for r in rows[:64]]))
    np.testing.assert_allclose([s for _, s in got], fw, rtol=5e-3, atol=5e-3)
    # each package's blob decodes in the other's ffm_predict to the same
    # scores as in its own
    blobs = [c.execute("SELECT model FROM model_blob").fetchone()[0]
             for c in conns]
    for c, blob in zip(conns, blobs[::-1]):
        c.execute("DELETE FROM model_blob")
        c.execute("INSERT INTO model_blob VALUES (?)", (blob,))
    got2, want2 = _both(conns[::-1], plan)
    assert_rows_match(got2, want, "ffm scores of the JAX blob")
    assert_rows_match(want2, got, "ffm scores of the port's blob")


def test_retrain_with_other_family_drops_stale_ffm_blob(conns):
    _make_dataset(conns)
    ct = conns[1]
    tsql.train(ct, "train_ffm", SRC, "-feature_hashing 8 -factors 2",
               model_table="m", device="cpu")
    tsql.train(ct, "train_arow", SRC, "-dims 32", model_table="m",
               device="cpu")
    assert ct.execute("SELECT name FROM sqlite_master WHERE "
                      "name = 'm_blob'").fetchall() == []


def test_multiclass_table_and_sql_plan(conns):
    rng = np.random.RandomState(4)
    d, L = 32, 3
    centers = rng.randn(L, d)
    rows = []
    for i in range(300):
        lab = i % L
        idx = np.argsort(-centers[lab] + 0.5 * rng.randn(d))[:5]
        rows.append((i, " ".join(f"{j}:1" for j in idx), f"class{lab}"))
    for c in conns:
        c.execute("CREATE TABLE mc (id INTEGER, features TEXT, label TEXT)")
        c.executemany("INSERT INTO mc VALUES (?,?,?)", rows)
    _, mt = _train_both(conns, "train_multiclass_arow", "-dims 32",
                        src="SELECT features, label FROM mc")
    assert_tables_match(conns, "model")
    for c, mod in zip(conns, (jsql, tsql)):
        mod.explode_features(c, "SELECT id, features FROM mc",
                             out_table="mcex", num_features=32)
    got, want = _both(conns[::-1], """
        WITH per_label AS (
          SELECT mcex.rowid AS id, m.label AS label,
                 SUM(m.weight * mcex.value) AS score
          FROM mcex JOIN model m ON m.feature = mcex.feature
          GROUP BY mcex.rowid, m.label)
        SELECT id, max_label(score, label) FROM per_label
        GROUP BY id ORDER BY id""")
    assert got == want
    fw = mt.predict([r[1].split() for r in rows])
    assert np.mean([a == b for (_, a), b in zip(got, fw)]) > 0.98


# ------------------------------------------------------------------- trees

def _dense_table(conns, name, X, y):
    for c in conns:
        c.execute(f"CREATE TABLE {name} (id INTEGER, features TEXT, "
                  "label REAL)")
        c.executemany(f"INSERT INTO {name} VALUES (?,?,?)",
                      [(i, " ".join(f"{v:.6f}" for v in X[i]), y[i])
                       for i in range(len(y))])


def test_forest_and_gbt_tables_and_sql_flow(conns):
    rng = np.random.RandomState(9)
    X = rng.rand(300, 6)
    y = ((X[:, 0] > 0.5) ^ (X[:, 1] > 0.5)).astype(int)
    _dense_table(conns, "fx", X, [int(v) for v in y])
    src = "SELECT features, label FROM fx"
    _, rf = _train_both(conns, "train_randomforest_classifier",
                        "-trees 6 -seed 31", table="rf_model", src=src)
    assert_tables_match(conns, "rf_model", order="1")
    got, want = _both(conns[::-1], """
        WITH votes AS (
          SELECT fx.id AS id,
                 tree_predict(m.model_type, m.pred_model, fx.features, 1) AS v
          FROM fx CROSS JOIN rf_model m)
        SELECT id, rf_ensemble(v) FROM votes GROUP BY id ORDER BY id""")
    assert got == want
    np.testing.assert_array_equal(
        [json.loads(r[1])["label"] for r in got], rf.predict(X))

    _, gbt = _train_both(conns, "train_gradient_tree_boosting_classifier",
                         "-trees 4 -iters 4 -seed 3", table="gbt_model", src=src)
    assert_tables_match(conns, "gbt_model")
    got, want = _both(conns[::-1], """
        SELECT fx.id, MAX(m.intercept) + MAX(m.shrinkage) *
                 SUM(tree_predict(m.model_type, m.pred_model, fx.features))
        FROM fx CROSS JOIN gbt_model m WHERE m.cls = 0
        GROUP BY fx.id ORDER BY fx.id""")
    assert_rows_match(got, want, "gbt scores")
    np.testing.assert_allclose([s for _, s in got],
                               gbt.decision_function(X)[:, 0], rtol=1e-5,
                               atol=1e-6)


def test_regression_forest_and_multiclass_gbt_sql_scoring(conns):
    rng = np.random.RandomState(2)
    X = rng.rand(200, 4)
    _dense_table(conns, "rx", X, [float(v) for v in 3.0 * X[:, 0] + X[:, 1]])
    _, rfr = _train_both(conns, "train_randomforest_regr", "-trees 4 -seed 7",
                         table="rfr", src="SELECT features, label FROM rx")
    assert_tables_match(conns, "rfr", order="1")
    got, want = _both(conns[::-1], """
        SELECT rx.id, AVG(tree_predict(m.model_type, m.pred_model,
                                       rx.features))
        FROM rx CROSS JOIN rfr m GROUP BY rx.id ORDER BY rx.id""")
    assert_rows_match(got, want, "regression forest scores")
    np.testing.assert_allclose([p for _, p in got], rfr.predict(X),
                               rtol=1e-6, atol=1e-6)

    y3 = (X[:, 0] > 0.6).astype(int) + (X[:, 1] > 0.5).astype(int)
    _dense_table(conns, "g3", X, [int(v) for v in y3])
    _, gbt = _train_both(conns, "train_gradient_tree_boosting_classifier",
                         "-trees 3 -iters 3 -seed 4", table="gbt3",
                         src="SELECT features, label FROM g3")
    assert_tables_match(conns, "gbt3")
    got, want = _both(conns[::-1], """
        WITH per_cls AS (
          SELECT g3.id AS id, m.cls AS cls,
                 MAX(m.intercept) + MAX(m.shrinkage) *
                   SUM(tree_predict(m.model_type, m.pred_model, g3.features))
                 AS score
          FROM g3 CROSS JOIN gbt3 m GROUP BY g3.id, m.cls)
        SELECT id, max_label(score, cls) FROM per_cls
        GROUP BY id ORDER BY id""")
    assert got == want
    np.testing.assert_array_equal([int(p) for _, p in got], gbt.predict(X))


# ---------------------------------------------------------------------- MF

def test_mf_table_and_sql_mf_predict(conns):
    rng = np.random.RandomState(6)
    P, Q = rng.randn(20, 3), rng.randn(15, 3)
    triples = []
    for _ in range(600):
        u, i = rng.randint(20), rng.randint(15)
        triples.append((u, i, float(P[u] @ Q[i] + 3.0)))
    for c in conns:
        c.execute("CREATE TABLE ratings (user INTEGER, item INTEGER, r REAL)")
        c.executemany("INSERT INTO ratings VALUES (?,?,?)", triples)
    src = "SELECT user, item, r FROM ratings"
    jsql.train_mf(conns[0], "train_mf_sgd", src,
                  options="-factor 3 -iterations 5", model_table="mfm")
    mt = tsql.train_mf(conns[1], "train_mf_sgd", src,
                       options="-factor 3 -iterations 5", model_table="mfm",
                       device="cpu")
    assert_tables_match(conns, "mfm", order="idx, pu IS NULL")
    got, want = _both(conns[::-1], """
        SELECT t.user, t.item, mf_predict(u.pu, i.qi, u.bu, i.bi, u.mu)
        FROM ratings t
        JOIN mfm u ON u.idx = t.user AND u.pu IS NOT NULL
        JOIN mfm i ON i.idx = t.item AND i.qi IS NOT NULL LIMIT 50""")
    assert_rows_match(got, want, "mf scores")
    np.testing.assert_allclose(
        [r[2] for r in got], mt.predict([r[0] for r in got],
                                        [r[1] for r in got]),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="3-column"):
        tsql.train_mf(conns[1], "train_arow", src, device="cpu")


# ------------------------------------------ warm start, refusals, devices

def test_warm_start_from_model_table(conns):
    _make_dataset(conns)
    _train_both(conns, "train_arow", "-dims 32", table="full_model")
    _train_both(conns, "train_arow", "-dims 32", table="warm_model",
                src="SELECT features, label FROM train LIMIT 10",
                warm_start_table="full_model")
    assert_tables_match(conns, "warm_model")
    ct = conns[1]
    tsql.train(ct, "train_fm", SRC, "-dims 32", model_table="fm_m",
               device="cpu")
    for kw, match in (
            (dict(options=None, warm_start_table="full_model"), "-dims"),
            (dict(options="-dims 32", warm_start_table="fm_m"),
             "linear model table"),
            (dict(options="-dims 32", warm_start_table="full_modle"),
             "no such table"),
            (dict(options="-dims 8", warm_start_table="full_model"),
             "feature ids outside")):
        with pytest.raises(ValueError, match=match):
            tsql.train(ct, "train_arow", SRC, device="cpu", **kw)
    with pytest.raises(ValueError, match="linear trainers only"):
        tsql.train(ct, "train_fm", SRC, "-dims 32", device="cpu",
                   warm_start_table="full_model")


def test_refusals_keep_the_table_and_identifiers_are_checked(conns):
    _make_dataset(conns)
    ct = conns[1]
    tsql.train(ct, "train_arow", SRC, "-dims 32", model_table="keep_me",
               device="cpu")
    n_before = ct.execute("SELECT COUNT(*) FROM keep_me").fetchone()[0]
    with pytest.raises(ValueError, match="feature ids outside"):
        tsql.train(ct, "train_arow", SRC, "-dims 8", model_table="keep_me",
                   warm_start_table="keep_me", device="cpu")
    with pytest.raises(ValueError, match="identifier"):
        tsql.train(ct, "train_arow", SRC, "-dims 32",
                   model_table="keep_me; DROP TABLE train", device="cpu")
    with pytest.raises(ValueError, match="identifier"):
        tsql.explode_features(ct, "SELECT id, features FROM train",
                              out_table="ex ex", num_features=32)
    assert ct.execute("SELECT COUNT(*) FROM keep_me").fetchone()[0] \
        == n_before
    assert ct.execute("SELECT COUNT(*) FROM train").fetchone()[0] > 0


def test_train_timings_name_the_parts(conns):
    _make_dataset(conns)
    t = {}
    tsql.train(conns[1], "train_arow", SRC, "-dims 32 -pallas",
               device="cpu", timings=t)
    assert set(t) == {"fetch_parse", "fit", "materialize"}
    assert all(v >= 0 for v in t.values())


def test_train_without_device_raises_without_cuda(conns):
    """No device named means the CUDA device: a RuntimeError here, raised
    before any model table is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    _make_dataset(conns)
    ct = conns[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsql.train(ct, "train_arow", SRC, "-dims 32 -pallas")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsql.train_mf(ct, "train_mf_sgd", "SELECT 1, 2, 3.0", "-factor 2")
    assert ct.execute("SELECT name FROM sqlite_master WHERE "
                      "name = 'model'").fetchall() == []
