"""SQLite engine binding — the in-process SQL host-engine adapter (L6).

The reference's primary surface IS a SQL engine: users register ~120
functions into Hive (ref: resources/ddl/define-all.hive) and train/score
with queries. This module binds the same surface to SQLite, the SQL engine
available in every CPython build — so the reference's canonical workflows
run as actual SQL here, not through a DataFrame DSL:

- `connect(...)` / `register(conn)` — install the scalar function library
  (sigmoid, mhash, feature helpers, scaling, distances/similarities, macro
  functions) and the streaming aggregates (logloss, mae/mse/rmse, r2, auc,
  voted_avg, argmin_kld, max_label, ...) into a sqlite3 connection, the
  define-all.hive analog. Aggregates wrap the evaluation layer's
  iterate/merge/terminate partials (evaluation/metrics.py), exactly the
  UDAF lifecycle Hive runs (ref: evaluation/LogarithmicLossUDAF.java:28).
- `train(conn, "train_arow", src_query, options)` — run any registry
  trainer over the rows a query yields and materialize the model as a
  table `(feature, weight[, covar])`: the UDTF train-then-emit flow
  (ref: BinaryOnlineClassifierUDTF.close():249-298).
- `explode_features(conn, src_query, out)` — test features to
  `(rowid, feature, value)` rows, enabling the reference's pure-SQL
  inference plan — join model on feature, `sigmoid(SUM(weight*value))`
  group by rowid (SURVEY.md §3.5) — with no framework code in the loop.

Feature rows in SQL are TEXT: either space-joined "name:value" items or a
JSON array of them (engines without array types serialize exactly this
way; parse_features accepts both).

The port's copy of `hivemall_tpu/adapters/sqlite.py`: the same functions,
tables and rows over the port's trainers. `train` / `train_mf` take
``device=None`` and hand it to the trainer (None is the CUDA device, and a
RuntimeError where there is none); `connect` / `register` take the device
the `ffm_predict` scalar decodes its blob onto. ``train(...,
timings={})`` fills the dict with the seconds of its parts (SQL fetch and
TEXT parse, fit, materialize).
"""

from __future__ import annotations

import json
import re
import sqlite3
import time
from typing import Callable, List, Optional

import torch

from ..device import DeviceLike
from ..ensemble import (argmin_kld, max_label, rf_ensemble, voted_avg,
                        weight_voted_avg)
from ..evaluation.metrics import AUC, F1Score, LogLossAggregator, MAE, MSE, R2, RMSE
from ..sql import get_function


_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _check_ident(name: str) -> str:
    """Table names are interpolated into DDL/DML (sqlite has no placeholder
    for identifiers) — accept plain identifiers only so a malformed or
    hostile name fails loudly instead of becoming SQL."""
    if not _IDENT.match(name or ""):
        raise ValueError(f"not a plain SQL identifier: {name!r}")
    return name


def _parse_list(cast: Callable) -> Callable:
    def parse(text: Optional[str]) -> List:
        if text is None:
            return []
        s = text.strip()
        if not s:
            return []
        if s.startswith("["):
            return [cast(x) for x in json.loads(s)]
        return [cast(x) for x in s.split()]

    return parse


#: TEXT -> the list-of-"name:value" rows every trainer consumes
#: (JSON array string or whitespace-joined items)
parse_features = _parse_list(str)
#: TEXT -> a dense numeric feature vector (the reference's array<double>
#: forest input): JSON array or whitespace-joined floats
parse_dense = _parse_list(float)


def _wrap_features_in(fn: Callable) -> Callable:
    """Adapt fn(list_of_fv, *rest) to fn(TEXT, *rest)."""

    def g(text, *rest):
        return fn(parse_features(text), *rest)

    return g


def _wrap_features_out(fn: Callable) -> Callable:
    """Adapt a list-returning fn to return space-joined TEXT."""

    def g(*args):
        return " ".join(str(x) for x in fn(*args))

    return g


def _agg(partial_cls, arity: int):
    """sqlite aggregate class around an iterate/merge/terminate partial
    (the Hive GenericUDAF lifecycle, ref: NDCGUDAF.java:113-196)."""

    class A:
        def __init__(self):
            self.p = partial_cls()

        def step(self, *args):
            if any(a is None for a in args):
                return
            self.p.iterate(*args)

        def finalize(self):
            try:
                return float(self.p.terminate())
            except ZeroDivisionError:
                return None

    return A, arity


class _ListAgg:
    """Collect-then-apply aggregate for the ensemble one-shots."""

    fn: Callable = staticmethod(lambda xs: None)
    arity = 1

    def __init__(self):
        self.rows = []

    def step(self, *args):
        if any(a is None for a in args):
            return
        self.rows.append(args[0] if len(args) == 1 else tuple(args))

    def finalize(self):
        if not self.rows:
            return None
        return type(self).fn(self.rows)


def _list_agg(fn: Callable, arity: int):
    return type(f"_Agg_{fn.__name__}", (_ListAgg,),
                {"fn": staticmethod(fn), "arity": arity}), arity


def _rf_ensemble_json(votes) -> str:
    label, prob, post = rf_ensemble(votes)
    return json.dumps({"label": int(label), "probability": prob,
                       "probabilities": post})


class _FMPredict:
    """fm_predict(wi, vif_json, xi): grouped FM scoring over model-joined
    feature rows — ŷ = Σ wi·xi + ½ Σ_f [(Σ vif·xi)² − Σ vif²·xi²]; the
    bias row (feature -1: wi=w0, vif NULL, xi=1) contributes w0 through
    the linear term (ref: fm/FMPredictGenericUDAF.java — identical
    iterate/terminate algebra)."""

    def __init__(self):
        self.linear = 0.0
        self.s = None  # Σ vif·xi per factor
        self.q = None  # Σ vif²·xi² per factor

    def step(self, wi, vif, xi):
        if xi is None:
            return
        x = float(xi)
        if wi is not None:
            self.linear += float(wi) * x
        if vif is not None:
            v = json.loads(vif)
            if self.s is None:
                self.s = [0.0] * len(v)
                self.q = [0.0] * len(v)
            for f, vf in enumerate(v):
                self.s[f] += vf * x
                self.q[f] += vf * vf * x * x
        return

    def finalize(self):
        pair = 0.0
        if self.s is not None:
            pair = 0.5 * sum(sf * sf - qf for sf, qf in zip(self.s, self.q))
        return self.linear + pair


_SCALARS = {
    # (sql_name, arity, registry_name or callable, marshal)
    "sigmoid": (1, "sigmoid", None),
    "mhash": (1, "mhash", None),
    "idf": (2, "idf", None),
    "tfidf": (3, "tfidf", None),
    "max2": (2, "max2", None),
    "min2": (2, "min2", None),
    "rescale": (3, "rescale", None),
    "zscore": (3, "zscore", None),
    "extract_feature": (1, "extract_feature", None),
    "extract_weight": (1, "extract_weight", None),
    "feature": (2, lambda n, v: f"{n}:{v}", None),
    "add_bias": (1, "add_bias", "features_io"),
    "l2_normalize": (1, "l2_normalize", "features_io"),
    "sort_by_feature": (1, "sort_by_feature", "features_io"),
    "cosine_similarity": (2, "cosine_similarity", "features_2in"),
    "jaccard_similarity": (2, "jaccard_similarity", "features_2in"),
    "angular_similarity": (2, "angular_similarity", "features_2in"),
    "euclid_similarity": (2, "euclid_similarity", "features_2in"),
    "cosine_distance": (2, "cosine_distance", "features_2in"),
    "euclid_distance": (2, "euclid_distance", "features_2in"),
    "manhattan_distance": (2, "manhattan_distance", "features_2in"),
    "jaccard_distance": (2, "jaccard_distance", "features_2in"),
    "hamming_distance": (2, "hamming_distance", None),
    "popcnt": (1, "popcnt", None),
    "tokenize": (1, "tokenize", "text_to_features"),
    "tokenize_ja": (1, "tokenize_ja", "text_to_features"),
    # tree_predict(model_type, pred_model, features_dense_text
    #              [, classification]) — the reference's per-row tree
    # evaluator (ref: TreePredictUDF.java:143-166); features are dense
    # array<double> TEXT (JSON or space-joined); classification defaults
    # false like the reference (TreePredictUDF.java:104) — pass 1 for
    # classification forests (int labels)
    "tree_predict": ((3, 4), None, "tree_predict"),
    # mf_predict(Pu, Qi[, Bu, Bi, mu]) / bprmf_predict(Pu, Qi[, Bi]) over
    # factor vectors as TEXT (ref: MFPredictionUDF.java:33,
    # BPRMFPredictionUDF.java); NULL factors (idx never trained) score NULL,
    # like the reference's null-tolerant UDF
    "mf_predict": ((2, 3, 4, 5), "mf_predict", "mf_predict"),
    "bprmf_predict": ((2, 3), "bprmf_predict", "mf_predict"),
    # ffm_predict(model_blob, features_text) — decodes the compressed
    # one-row blob (cached per distinct blob) and scores the FULL pairwise
    # model, the reference's FFMPredictUDF flow (fm/FFMPredictUDF.java over
    # FFMPredictionModel.java:46-200)
    "ffm_predict": (2, None, "ffm_predict"),
}


def register(conn: sqlite3.Connection,
             device: DeviceLike = None) -> sqlite3.Connection:
    """Install the function library into `conn` (the define-all.hive
    analog). `device` is where `ffm_predict` decodes a blob's model (None:
    the CUDA device, resolved at the scalar's first call). Returns the
    connection for chaining."""
    for sql_name, (arity, target, marshal) in _SCALARS.items():
        if marshal == "tree_predict":
            from functools import lru_cache

            from ..models.trees.predict import compile_tree

            # one compile per distinct tree, not per (row x tree): the
            # predict flow CROSS JOINs every row against every model row
            cached_compile = lru_cache(maxsize=4096)(compile_tree)

            def fn(model_type, pred_model, features, classification=0,
                   _c=cached_compile):
                out = _c(model_type, pred_model)(parse_dense(features))
                return int(out) if classification else float(out)
        elif marshal == "ffm_predict":
            from functools import lru_cache, partial

            from ..models.ffm import TrainedFFMModel

            # one decode per distinct blob, not per (row x call); bytes are
            # hashable so the blob itself is the cache key
            cached_from_blob = lru_cache(maxsize=8)(
                partial(TrainedFFMModel.from_blob, device=device))

            def fn(blob, features, _c=cached_from_blob):
                if blob is None or features is None:
                    return None
                m = _c(bytes(blob))
                return float(m.predict([parse_features(features)])[0])
        elif marshal == "mf_predict":
            base_mf = get_function(target)

            def fn(pu, qi, *biases, _f=base_mf):
                if pu is None or qi is None:
                    return None
                return _f(parse_dense(pu), parse_dense(qi),
                          *(0.0 if b is None else float(b) for b in biases))
        else:
            fn = target if callable(target) else get_function(target)
            if marshal == "features_io":
                fn = _wrap_features_out(_wrap_features_in(fn))
            elif marshal == "features_2in":
                base = fn

                def fn(a, b, _f=base):  # noqa: E731 - bind per-iteration
                    return _f(parse_features(a), parse_features(b))
            elif marshal == "text_to_features":
                fn = _wrap_features_out(fn)
        # every registered scalar is pure -> deterministic=True lets SQLite
        # use them in expression indexes and factor repeated calls.
        # Multi-arity names register each fixed form (never narg=-1, which
        # would let a stray extra SQL argument bind a wrapper's internal
        # defaults)
        for n in (arity if isinstance(arity, tuple) else (arity,)):
            conn.create_function(sql_name, n, fn, deterministic=True)

    class _F1TokenLists(F1Score):
        """F1Score.iterate takes label LISTS per row; SQL hands TEXT — split
        whitespace-joined labels so set() is over tokens, not characters."""

        def iterate(self, actual, predicted):  # type: ignore[override]
            super().iterate(str(actual).split(), str(predicted).split())

    for name, (cls, arity) in {
        "logloss": _agg(LogLossAggregator, 2),
        "mae": _agg(MAE, 2),
        "mse": _agg(MSE, 2),
        "rmse": _agg(RMSE, 2),
        "r2": _agg(R2, 2),
        "auc": _agg(AUC, 2),
        "f1score": _agg(_F1TokenLists, 2),
        "voted_avg": _list_agg(voted_avg, 1),
        "weight_voted_avg": _list_agg(weight_voted_avg, 1),
        "max_label": _list_agg(max_label, 2),
        "argmin_kld": _list_agg(argmin_kld, 2),
        "fm_predict": (_FMPredict, 3),
        # rf_ensemble(vote) -> JSON {label, probability, probabilities} (the
        # reference returns a struct, ref: RandomForestEnsembleUDAF.java:34)
        "rf_ensemble": _list_agg(_rf_ensemble_json, 1),
    }.items():
        conn.create_aggregate(name, arity, cls)
    return conn


def connect(database: str = ":memory:", device: DeviceLike = None,
            **kw) -> sqlite3.Connection:
    return register(sqlite3.connect(database, **kw), device=device)


def _materialize_linear(q, model, model_table: str) -> None:
    from ..core.state import model_rows

    out = model_rows(model.state)
    if len(out) == 3 and out[2] is not None:
        q.execute(f"CREATE TABLE {model_table} "
                  "(feature INTEGER PRIMARY KEY, weight REAL, covar REAL)")
        q.executemany(f"INSERT INTO {model_table} VALUES (?,?,?)",
                      zip(map(int, out[0]), map(float, out[1]),
                          map(float, out[2])))
    else:
        q.execute(f"CREATE TABLE {model_table} "
                  "(feature INTEGER PRIMARY KEY, weight REAL)")
        q.executemany(f"INSERT INTO {model_table} VALUES (?,?)",
                      zip(map(int, out[0]), map(float, out[1])))


def _materialize_fm(q, model, model_table: str) -> None:
    """(feature, wi, vif JSON) rows; feature -1 carries w0 with NULL vif.
    The reference emits w0 as feature "0" (forwardAsIntFeature,
    FactorizationMachineUDTF.java:446-519) because its int features are
    1-based; this feature space is 0-based (hashed ids land in [0, dims)),
    so the bias row lives at -1 where it can never alias a real feature."""
    w0, feats, w, v = model.model_rows()
    q.execute(f"CREATE TABLE {model_table} "
              "(feature INTEGER PRIMARY KEY, wi REAL, vif TEXT)")
    q.execute(f"INSERT INTO {model_table} VALUES (-1, ?, NULL)", (float(w0),))
    q.executemany(
        f"INSERT INTO {model_table} VALUES (?,?,?)",
        ((int(f), float(wi), json.dumps([float(x) for x in vi]))
         for f, wi, vi in zip(feats, w, v)))


def _materialize_ffm(q, model, model_table: str) -> None:
    """FFM materializes its LINEAR part as joinable `(feature, wi)` rows
    (+ w0 on feature -1) AND the complete model as a one-row compressed
    blob table `{model_table}_blob` — exactly the reference's shipping
    shape: an opaque Externalizable blob scored by a dedicated UDF
    (ref: FFMPredictionModel.java:46-200 + FFMPredictUDF). Score in SQL
    with `ffm_predict(blob, features)` — full pairwise parity with the
    framework's predict, V included."""
    feats, w, w0 = model.model_rows()
    q.execute(f"CREATE TABLE {model_table} "
              "(feature INTEGER PRIMARY KEY, wi REAL)")
    q.execute(f"INSERT INTO {model_table} VALUES (-1, ?)", (float(w0),))
    q.executemany(f"INSERT INTO {model_table} VALUES (?,?)",
                  zip(map(int, feats), map(float, w)))
    q.execute(f"DROP TABLE IF EXISTS {model_table}_blob")
    q.execute(f"CREATE TABLE {model_table}_blob (model BLOB)")
    q.execute(f"INSERT INTO {model_table}_blob VALUES (?)",
              (model.to_blob(),))


def _materialize_forest(q, model, model_table: str) -> None:
    """Per-tree rows (model_id, model_type, pred_model, var_importance JSON,
    oob_errors, oob_tests) — the reference's forward at close
    (ref: RandomForestClassifierUDTF.java:343-351). Score in SQL with the
    tree_predict scalar + rf_ensemble aggregate (§3.4's predict flow)."""
    q.execute(f"CREATE TABLE {model_table} (model_id INTEGER PRIMARY KEY, "
              "model_type TEXT, pred_model TEXT, var_importance TEXT, "
              "oob_errors INTEGER, oob_tests INTEGER)")
    q.executemany(
        f"INSERT INTO {model_table} VALUES (?,?,?,?,?,?)",
        ((int(mid), str(mtype), model_text if isinstance(model_text, str)
          else json.dumps(model_text), json.dumps(imp), int(oe), int(ot))
         for mid, mtype, model_text, imp, oe, ot in model.model_rows()))


def _materialize_gbt(q, model, model_table: str) -> None:
    """One row per (boosting round, class tree) — the reference's per-round
    forward flattened relationally (GradientTreeBoostingClassifierUDTF
    .java:525-546; the per-class models array becomes a cls column). Score
    binary in SQL with
    `MAX(intercept) + MAX(shrinkage) * SUM(tree_predict(model_type,
    pred_model, features))` per row; multiclass per (row, cls) +
    max_label."""
    q.execute(f"CREATE TABLE {model_table} (iter INTEGER, cls INTEGER, "
              "model_type TEXT, pred_model TEXT, intercept REAL, "
              "shrinkage REAL, var_importance TEXT, oob_error_rate REAL, "
              "classes TEXT, PRIMARY KEY (iter, cls))")
    q.executemany(
        f"INSERT INTO {model_table} VALUES (?,?,?,?,?,?,?,?,?)",
        ((int(m), int(c), str(mt), text, float(ic), float(sh),
          json.dumps(imp), oob, vocab)
         for m, c, mt, text, ic, sh, imp, oob, vocab
         in model.model_rows()))


def _materialize_multiclass(q, model, model_table: str) -> None:
    """(label, feature, weight[, covar]) — the per-label close() emission
    (ref: MulticlassOnlineClassifierUDTF close)."""
    out = model.model_rows()
    if len(out) == 4:
        labels, feats, w, cov = out
        q.execute(f"CREATE TABLE {model_table} (label TEXT, feature INTEGER, "
                  "weight REAL, covar REAL, PRIMARY KEY (label, feature))")
        q.executemany(f"INSERT INTO {model_table} VALUES (?,?,?,?)",
                      zip(map(str, labels), map(int, feats),
                          map(float, w), map(float, cov)))
    else:
        labels, feats, w = out
        q.execute(f"CREATE TABLE {model_table} (label TEXT, feature INTEGER, "
                  "weight REAL, PRIMARY KEY (label, feature))")
        q.executemany(f"INSERT INTO {model_table} VALUES (?,?,?)",
                      zip(map(str, labels), map(int, feats), map(float, w)))


def train(conn: sqlite3.Connection, trainer: str, src_query: str,
          options: Optional[str] = None,
          model_table: Optional[str] = "model",
          warm_start_table: Optional[str] = None,
          device: DeviceLike = None, timings: Optional[dict] = None):
    """Run a registry trainer over `src_query`'s (features TEXT, label)
    rows; materialize the model table and return the model object.

    The SQL-engine flow of `INSERT ... SELECT train_arow(features, label)
    FROM t` (ref: define-all.hive:27-28 + the UDTF emit at close,
    BinaryOnlineClassifierUDTF.java:249-298): SQLite has no table-valued
    UDFs, so the rewrite — pull rows, train, materialize — is explicit.

    The table shape follows the trainer family, exactly the reference's
    per-family emissions: linear `(feature, weight[, covar])`; FM
    `(feature, wi, vif JSON)` with w0 on feature -1 (score in SQL with the
    fm_predict aggregate); FFM linear rows + the complete compressed blob
    (scored by ffm_predict); multiclass `(label, feature, weight[, covar])`
    (score with SUM(weight*value) per (row,label) + max_label); forests
    per-tree rows (tree_predict + rf_ensemble); GBT per-(round, class)
    rows (intercept + shrinkage * SUM(tree_predict)) — the reference
    forwards GBT per round too
    (GradientTreeBoostingClassifierUDTF.java:525-546).

    `device` is the trainer's (None: the CUDA device). A `timings` dict
    receives "fetch_parse", "fit" (to the device's last operation) and
    "materialize" seconds."""
    if model_table is not None:
        _check_ident(model_table)
    if warm_start_table is not None:
        _check_ident(warm_start_table)
    fn = get_function(trainer)
    is_forest = trainer.startswith(("train_randomforest",
                                    "train_gradient_tree"))
    t0 = time.perf_counter()
    rows = conn.execute(src_query).fetchall()
    # forests consume dense array<double> rows (the reference's RF input),
    # every other family consumes "name:value" feature lists
    feats = [parse_dense(r[0]) if is_forest else parse_features(r[0])
             for r in rows]
    labels = [r[1] for r in rows]
    _lap(timings, "fetch_parse", t0)

    kw = {}
    if warm_start_table is not None:
        # `-loadmodel` with the model table living IN the engine instead of
        # a file (ref: LearnerBaseUDTF.loadPredictionModel:215-333 reads the
        # model table from the distributed cache). Linear trainers only —
        # exactly the fit_linear family; FM/FFM/multiclass would silently
        # drop (or reject) the kwargs.
        import numpy as np

        from ..io.checkpoint import dense_from_rows

        if fn.__module__.rsplit(".", 1)[-1] not in ("classifier",
                                                    "regression"):
            raise ValueError(
                f"warm_start_table supports linear trainers only; "
                f"{trainer} is not one")
        m = re.search(r"-(?:dims|feature_dimensions)\s+(\d+)", options or "")
        if m is None:
            raise ValueError(
                "warm_start_table needs an explicit -dims in options so the "
                "model table maps into the right feature space")
        dims = int(m.group(1))
        cols = [r[1] for r in conn.execute(
            f"PRAGMA table_info({warm_start_table})")]
        if not cols:
            raise ValueError(f"no such table: {warm_start_table}")
        if cols not in (["feature", "weight"],
                        ["feature", "weight", "covar"]):
            raise ValueError(
                f"{warm_start_table} is not a linear model table "
                f"(columns {cols}); warm start supports linear trainers only")
        wrows = conn.execute(
            f"SELECT * FROM {warm_start_table}").fetchall()
        f0 = np.array([r[0] for r in wrows], dtype=np.int64)
        if f0.size and (int(f0.max()) >= dims or int(f0.min()) < 0):
            raise ValueError(
                f"{warm_start_table} has feature ids outside [0, {dims}) "
                f"(min {int(f0.min())}, max {int(f0.max())}); pass the "
                "-dims it was trained at")
        w0 = np.array([r[1] for r in wrows], dtype=np.float32)
        c0 = np.array([r[2] for r in wrows], dtype=np.float32) \
            if len(cols) > 2 else None
        iw, ic = dense_from_rows(dims, f0, w0, c0)
        kw = {"initial_weights": iw, "initial_covars": ic}

    t0 = time.perf_counter()
    model = fn(feats, labels, options, device=device, **kw) \
        if options is not None else fn(feats, labels, device=device, **kw)
    if timings is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the fit's seconds hold its device work
    _lap(timings, "fit", t0)

    if model_table is None:  # train-only; serve from the returned object
        return model

    from ..models.ffm import TrainedFFMModel
    from ..models.fm import TrainedFMModel
    from ..models.trees.forest import TrainedForest, TrainedGBT

    # resolve the family's materializer BEFORE dropping anything so a
    # refused call leaves any existing model table intact
    if isinstance(model, TrainedFMModel):
        materialize = _materialize_fm
    elif isinstance(model, TrainedFFMModel):
        materialize = _materialize_ffm
    elif isinstance(model, TrainedGBT):
        materialize = _materialize_gbt
    elif isinstance(model, TrainedForest):
        materialize = _materialize_forest
    elif hasattr(model, "label_vocab"):  # multiclass family
        materialize = _materialize_multiclass
    elif hasattr(model, "state") and hasattr(model.state, "weights"):
        materialize = _materialize_linear
    else:
        raise ValueError(
            f"{trainer} models have no SQL materialization here; pass "
            "model_table=None and predict on the returned model object")
    t0 = time.perf_counter()
    q = conn.cursor()
    q.execute(f"DROP TABLE IF EXISTS {model_table}")
    # a previous train_ffm into this name also left {model_table}_blob;
    # retraining with another family must not leave ffm_predict silently
    # scoring the outdated blob
    q.execute(f"DROP TABLE IF EXISTS {model_table}_blob")
    materialize(q, model, model_table)
    conn.commit()
    _lap(timings, "materialize", t0)
    return model


def _lap(timings: Optional[dict], key: str, t0: float) -> None:
    if timings is not None:
        timings[key] = time.perf_counter() - t0


def train_mf(conn: sqlite3.Connection, trainer: str, src_query: str,
             options: Optional[str] = None,
             model_table: Optional[str] = "mf_model",
             device: DeviceLike = None):
    """Matrix-factorization training over `src_query`'s 3 columns —
    (user, item, rating), or (user, pos_item, neg_item) for train_bprmf —
    materializing the reference's per-index emission as ONE table
    `(idx, pu TEXT, qi TEXT, bu REAL, bi REAL, mu REAL)`: user rows carry
    pu/bu, item rows qi/bi, every row mu
    (ref: OnlineMatrixFactorizationUDTF close/forward). Score in SQL with
    the mf_predict / bprmf_predict scalars:

        SELECT t.user, t.item, mf_predict(u.pu, i.qi, u.bu, i.bi, u.mu)
        FROM test t
        JOIN mf_model u ON u.idx = t.user AND u.pu IS NOT NULL
        JOIN mf_model i ON i.idx = t.item AND i.qi IS NOT NULL

    `device` is the trainer's (None: the CUDA device).
    """
    if model_table is not None:
        _check_ident(model_table)
    if trainer not in ("train_mf_sgd", "train_mf_adagrad", "train_bprmf"):
        raise ValueError(
            f"train_mf drives the 3-column MF trainers only; use train() "
            f"for {trainer}")
    fn = get_function(trainer)
    rows = conn.execute(src_query).fetchall()
    users = [r[0] for r in rows]
    items = [r[1] for r in rows]
    third = [r[2] for r in rows]
    model = fn(users, items, third, options, device=device) \
        if options is not None else fn(users, items, third, device=device)
    if model_table is None:
        return model

    mr = model.model_rows()
    tu, P, Bu = mr["users"]
    ti, Q, Bi = mr["items"]
    mu = mr["mu"]
    q = conn.cursor()
    q.execute(f"DROP TABLE IF EXISTS {model_table}")
    q.execute(f"CREATE TABLE {model_table} (idx INTEGER, pu TEXT, qi TEXT, "
              "bu REAL, bi REAL, mu REAL)")
    q.executemany(
        f"INSERT INTO {model_table} VALUES (?,?,NULL,?,NULL,?)",
        ((int(u), json.dumps([float(x) for x in pv]), float(b), mu)
         for u, pv, b in zip(tu, P, Bu)))
    q.executemany(
        f"INSERT INTO {model_table} VALUES (?,NULL,?,NULL,?,?)",
        ((int(i), json.dumps([float(x) for x in qv]), float(b), mu)
         for i, qv, b in zip(ti, Q, Bi)))
    # idx can't be PRIMARY KEY (a user and an item may share an id); the
    # documented double self-join predict plan needs the index regardless
    q.execute(f"CREATE INDEX {model_table}_idx ON {model_table}(idx)")
    conn.commit()
    return model


def explode_features(conn: sqlite3.Connection, src_query: str,
                     out_table: str = "exploded",
                     num_features: Optional[int] = None) -> None:
    """(id, features TEXT) rows -> `(rowid, feature INTEGER, value REAL)`
    — the explode step of the reference's pure-SQL inference plan
    (SURVEY.md §3.5). String feature names are hashed like
    feature_hashing() (ref: ftvec/hashing/FeatureHashingUDF.java:172);
    `num_features` is REQUIRED when names are strings and must match the
    trainer's `-dims` (same feature space as the model table). Integer ids
    are floor-modded into [0, num_features) exactly like every trainer's
    parser (`int(name) % num_features`, matching the C bulk parser), so
    out-of-range and negative ids land on the same model rows the trainer
    wrote — without the mod the join silently drops them."""
    from ..utils.feature import parse_feature
    from ..utils.hashing import mhash

    _check_ident(out_table)
    # build all rows BEFORE touching out_table so a refused call (or a bad
    # src_query) leaves any existing exploded table intact
    ins = []
    for rid, text in conn.execute(src_query):
        for fv in parse_features(text):
            name, value = parse_feature(fv)
            try:
                idx = int(name)
            except ValueError:
                # hashing must land in the SAME space the model was trained
                # at or the join silently mismatches — refuse to guess
                if num_features is None:
                    raise ValueError(
                        f"feature {name!r} is a string name; pass "
                        "num_features= matching the trainer's -dims so it "
                        "hashes into the model's feature space")
                idx = mhash(name, num_features)
            else:
                if num_features is not None:
                    idx %= num_features
                elif idx < 0:
                    raise ValueError(
                        f"feature id {idx} is negative; pass num_features= "
                        "matching the trainer's -dims so it floor-mods into "
                        "the model's feature space like the trainer did")
            ins.append((rid, idx, float(value)))
    q = conn.cursor()
    q.execute(f"DROP TABLE IF EXISTS {out_table}")
    q.execute(f"CREATE TABLE {out_table} "
              "(rowid INTEGER, feature INTEGER, value REAL)")
    q.executemany(f"INSERT INTO {out_table} VALUES (?,?,?)", ins)
    conn.commit()
