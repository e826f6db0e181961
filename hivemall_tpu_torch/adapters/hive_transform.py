"""Hive `TRANSFORM ... USING` streaming bridge — a JVM-free execution path a
real Hive cluster can drive today.

Hive's streaming contract (the same one `scoreKDD.py`-style scripts use):
the query planner pipes each map task's rows to the child process as
TSV — columns joined by ``\\t``, rows by ``\\n``, ``\\N`` for NULL, array
elements joined by ``\\x02`` (Hive's default collection-items terminator) —
and parses the child's stdout with the same framing. That makes every
registry trainer reachable from HiveQL without a JVM UDF (ref: the UDTF
surface `hivemall/UDTFWithOptions.java:48` + `define-all.hive:27-28`; this
bridge replaces the UDTF *transport*, not the trainer semantics):

    ADD FILE hivemall-tpu;                    -- bin/hivemall-tpu shim
    SELECT TRANSFORM (features, label)
        USING 'hivemall-tpu train_arow -dims 16777216'
        AS (feature INT, weight FLOAT, covar FLOAT)
    FROM training;

Each map task trains one replica over its split and emits model rows at
close — exactly the reference's mapper-side UDTF life cycle
(BinaryOnlineClassifierUDTF.java:249-298); the usual ensemble UDAF / GROUP
BY `avg(weight)` / argmin_kld reduce step merges replicas, unchanged.

Subcommands (one per trainer family, mirroring adapters/sqlite.py's
materializations):

- every linear binary classifier / regressor  -> ``feature weight [covar]``
- multiclass trainers                          -> ``label feature weight [covar]``
- ``train_fm``        -> ``feature wi vif_json`` (w0 on feature -1, NULL vif)
- ``train_randomforest_*`` -> ``model_id model_type pred_model
  var_importance oob_errors oob_tests`` (dense ``\\x02``-joined features in)
- MF family (3 input columns)                  -> ``idx pu qi bu bi mu``
- ``predict_linear -loadmodel <file> [-sigmoid]``  (rowid, features) ->
  (rowid, score); the model file is the trainer's own TSV output shipped via
  ``ADD FILE`` — the `-loadmodel` distributed-cache path
  (LearnerBaseUDTF.java:215-333) without a JVM
- ``predict_fm -loadmodel <file>``                 (rowid, features) ->
  (rowid, score) over a train_fm TSV model
- ``predict_ffm -loadmodel <blob-file>``           (rowid, ffm features)
  -> (rowid, score) over a compressed TrainedFFMModel blob (full
  pairwise scoring, V included)
- ``predict_multiclass -loadmodel <file>``         (rowid, features) ->
  (rowid, best_label, best_score) over a multiclass TSV model (the
  per-label SUM + max_label plan)
- ``predict_forest -loadmodel <file> [-regression]`` (rowid, dense
  features) -> (rowid, vote) over a forest TSV model (tree_predict +
  rf_ensemble)
- ``predict_gbt -loadmodel <file>``                (rowid, dense
  features) -> (rowid, label, score) over a GBT TSV model
  (intercept + shrinkage * summed rounds; binary sign / multiclass
  argmax)

Run as ``hivemall-tpu-torch <subcommand> ...`` (bin/ shim) or
``python -m hivemall_tpu_torch.adapters.hive_transform <subcommand> ...``.

The port's copy of `hivemall_tpu/adapters/hive_transform.py`: the same
subcommands, options and TSV protocol over the port's trainers, plus one
flag, ``--device <name>`` (or ``--device=<name>``), taken out of the
arguments before the rest is joined into the trainer's options. It names
the device the trainers (and predict_ffm's decoded blob) run on; unset is
the CUDA device, and a RuntimeError (a non-zero exit) where there is none.
"""

from __future__ import annotations

import json
import sys
from typing import IO, List, Optional, Sequence

HIVE_NULL = r"\N"
ITEM_SEP = "\x02"  # Hive's default collection-items terminator


# ------------------------------------------------------------------ framing

def _fmt(v) -> str:
    if v is None:
        return HIVE_NULL
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _emit(out: IO[str], *cols) -> None:
    out.write("\t".join(_fmt(c) for c in cols))
    out.write("\n")


def _cells(line: str) -> List[Optional[str]]:
    line = line.rstrip("\n")
    return [None if c == HIVE_NULL else c for c in line.split("\t")]


def _feature_list(cell: str) -> List[str]:
    """A Hive array<string> arrives \\x02-joined; a plain string feature
    column is space- (or comma-) joined — accept all three."""
    if ITEM_SEP in cell:
        return [t for t in cell.split(ITEM_SEP) if t]
    if "," in cell and " " not in cell.strip():
        return [t for t in cell.split(",") if t]
    return cell.split()


def _dense_list(cell: str) -> List[float]:
    return [float(t) for t in _feature_list(cell)]


# ------------------------------------------------------------------ training

_MF_TRAINERS = frozenset(
    ("train_mf_sgd", "train_mf_adagrad", "train_bprmf"))


def _run_trainer(trainer: str, options: Optional[str], src: IO[str],
                 out: IO[str], device: Optional[str] = None) -> int:
    from ..sql.registry import get_function

    fn = get_function(trainer)
    is_forest = trainer.startswith(("train_randomforest",
                                    "train_gradient_tree"))
    if trainer in _MF_TRAINERS:
        return _run_mf_trainer(trainer, fn, options, src, out, device)

    feats: list = []
    labels: list = []
    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 2 or cols[0] is None or cols[-1] is None:
            continue  # NULL feature/label rows are skipped, like the UDTF
        feats.append(_dense_list(cols[0]) if is_forest
                     else _feature_list(cols[0]))
        # multiclass labels stay strings; everything else is numeric
        labels.append(cols[-1] if trainer.startswith("train_multiclass")
                      else float(cols[-1]))

    model = fn(feats, labels, options, device=device) \
        if options is not None else fn(feats, labels, device=device)
    _emit_model_rows(trainer, model, out)
    return 0


def _run_mf_trainer(trainer: str, fn, options: Optional[str], src: IO[str],
                    out: IO[str], device: Optional[str] = None) -> int:
    """3-column input (user, item, rating) — or (user, pos_item, neg_item)
    for train_bprmf; emission mirrors adapters/sqlite.train_mf's one-table
    shape (ref: OnlineMatrixFactorizationUDTF close)."""
    users: List[int] = []
    items: List[int] = []
    third: List[float] = []
    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 3 or None in cols[:3]:
            continue
        users.append(int(cols[0]))
        items.append(int(cols[1]))
        third.append(float(cols[2]))
    if trainer == "train_bprmf":
        third = [int(t) for t in third]
    model = fn(users, items, third, options, device=device) \
        if options is not None else fn(users, items, third, device=device)

    rows = model.model_rows()
    tu, P, Bu = rows["users"]
    ti, Q, Bi = rows["items"]
    mu = rows["mu"]
    for u, pv, b in zip(tu, P, Bu):
        _emit(out, int(u), json.dumps([float(x) for x in pv]), None,
              float(b), None, mu)
    for i, qv, b in zip(ti, Q, Bi):
        _emit(out, int(i), None, json.dumps([float(x) for x in qv]),
              None, float(b), mu)
    return 0


def _emit_model_rows(trainer: str, model, out: IO[str]) -> None:
    """TSV rendering of the shared typed row iteration (adapters/
    model_rows.iter_model_rows — the ONE copy of the family dispatch).
    List-valued cells (FM Vif, importances, opcode programs) render as
    JSON text, everything else through _fmt (None -> \\N)."""
    from .model_rows import iter_model_rows

    # iter_model_rows raises its own descriptive ValueError for models
    # without row emission; don't catch-and-relabel (it would mask data
    # errors from the eager family branches as "no row emission")
    _, rows = iter_model_rows(model)
    for row in rows:
        _emit(out, *(json.dumps(c) if isinstance(c, list) else c
                     for c in row))


# ---------------------------------------------------------------- predicting

def _parse_predict_args(argv: Sequence[str], flags: Sequence[str] = ()):
    """Tiny arg scan: -loadmodel <file> plus boolean flags."""
    model_path = None
    seen = set()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-loadmodel", "--loadmodel"):
            i += 1
            if i >= len(argv):
                raise SystemExit("-loadmodel needs a file argument")
            model_path = argv[i]
        elif a.lstrip("-") in flags:
            seen.add(a.lstrip("-"))
        else:
            raise SystemExit(f"unknown predict option: {a}")
        i += 1
    if model_path is None:
        raise SystemExit("predict requires -loadmodel <model.tsv> "
                         "(ship it with ADD FILE)")
    return model_path, seen


def _run_predict_linear(argv: Sequence[str], src: IO[str],
                        out: IO[str]) -> int:
    # overflow-safe sigmoid (math.exp raises OverflowError past ~|710|,
    # which real CTR scores can reach; the library sigmoid is np-based)
    from ..tools import sigmoid

    model_path, flags = _parse_predict_args(argv, flags=("sigmoid",))
    weights = {}
    with open(model_path) as f:
        for line in f:
            if not line.strip():
                continue
            cols = _cells(line)
            if cols[1] is None:
                continue  # e.g. train_ffm's feature -2 blob row (NULL wi)
            weights[int(cols[0])] = float(cols[1])  # covar column ignored

    from ..utils.feature import parse_feature

    use_sigmoid = "sigmoid" in flags
    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 2 or cols[1] is None:
            continue
        score = 0.0
        for tok in _feature_list(cols[1]):
            name, value = parse_feature(tok)
            try:
                k = int(name)
            except ValueError:
                print(f"predict_linear: string feature {name!r} — hash "
                      "features before training/scoring", file=sys.stderr)
                return 2
            score += weights.get(k, 0.0) * value
        if use_sigmoid:
            score = float(sigmoid(score))
        _emit(out, cols[0], score)
    return 0


def _run_predict_fm(argv: Sequence[str], src: IO[str], out: IO[str]) -> int:
    model_path, _ = _parse_predict_args(argv)
    w = {}
    V = {}
    w0 = 0.0
    with open(model_path) as f:
        for line in f:
            if not line.strip():
                continue
            cols = _cells(line)
            fid = int(cols[0])
            if cols[1] is None:
                continue  # e.g. train_ffm's feature -2 blob row (NULL wi)
            if fid == -1:
                w0 = float(cols[1])
                continue
            w[fid] = float(cols[1])
            if len(cols) > 2 and cols[2] is not None:
                V[fid] = json.loads(cols[2])

    from ..utils.feature import parse_feature

    k = len(next(iter(V.values()))) if V else 0
    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 2 or cols[1] is None:
            continue
        try:
            fv = [(int(n), x) for n, x in
                  (parse_feature(t) for t in _feature_list(cols[1]))]
        except ValueError:
            print("predict_fm: string feature name — hash features before "
                  "training/scoring", file=sys.stderr)
            return 2
        p = w0
        for name, x in fv:
            p += w.get(name, 0.0) * x
        for f in range(k):
            s = s2 = 0.0
            for name, x in fv:
                vf = V.get(name)
                if vf is None:
                    continue
                vx = vf[f] * x
                s += vx
                s2 += vx * vx
            p += 0.5 * (s * s - s2)
        _emit(out, cols[0], p)
    return 0


def _run_predict_ffm(argv: Sequence[str], src: IO[str], out: IO[str],
                     device: Optional[str] = None) -> int:
    """(rowid, "field:idx:value" features) -> (rowid, score) over a
    compressed FFM blob file (TrainedFFMModel.to_blob, the
    FFMPredictionModel shipping shape) — full pairwise scoring, V
    included. Ship the blob with ADD FILE like any model artifact."""
    model_path, _ = _parse_predict_args(argv)
    from ..models.ffm import TrainedFFMModel

    with open(model_path, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"HFM1"):
        # a train_ffm TSV emission (or just its blob row): pull the base91
        # text from the feature -2 row
        from ..tools import unbase91

        blob_text = None
        for line in raw.decode("utf-8", errors="replace").splitlines():
            c = _cells(line)
            if c and c[0] == "-2" and len(c) >= 3 and c[2] is not None:
                blob_text = c[2]
        if blob_text is None:
            print("predict_ffm: file is neither a raw blob nor a "
                  "train_ffm TSV emission with a feature -2 blob row",
                  file=sys.stderr)
            return 2
        raw = unbase91(blob_text)
    model = TrainedFFMModel.from_blob(raw, device=device)
    ids: List[str] = []
    rows: List[List[str]] = []
    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 2 or cols[1] is None:
            continue
        ids.append(cols[0])
        rows.append(_feature_list(cols[1]))
    if not ids:
        return 0
    for rid, s in zip(ids, model.predict(rows)):
        _emit(out, rid, float(s))
    return 0


def _run_predict_multiclass(argv: Sequence[str], src: IO[str],
                            out: IO[str]) -> int:
    """(rowid, features) -> (rowid, best_label, best_score) over a
    multiclass model TSV (label, feature, weight[, covar]) — the per-label
    SUM + max_label SQL plan, framework-side."""
    model_path, _ = _parse_predict_args(argv)
    weights: dict = {}
    with open(model_path) as f:
        for line in f:
            if not line.strip():
                continue
            cols = _cells(line)
            weights.setdefault(cols[0], {})[int(cols[1])] = float(cols[2])
    if not weights:
        print("predict_multiclass: empty model file", file=sys.stderr)
        return 2

    from ..utils.feature import parse_feature

    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 2 or cols[1] is None:
            continue
        try:
            fv = [(int(n), x) for n, x in
                  (parse_feature(t) for t in _feature_list(cols[1]))]
        except ValueError:
            print("predict_multiclass: string feature name — hash features "
                  "before training/scoring", file=sys.stderr)
            return 2
        best_label, best_score = None, None
        for label, w in weights.items():
            s = sum(w.get(k, 0.0) * x for k, x in fv)
            if best_score is None or s > best_score:
                best_label, best_score = label, s
        _emit(out, cols[0], best_label, best_score)
    return 0


def _run_predict_forest(argv: Sequence[str], src: IO[str],
                        out: IO[str]) -> int:
    """(rowid, dense features) -> (rowid, vote) over a forest model TSV
    (the 6-column train_randomforest_* emission) — tree_predict +
    rf_ensemble, framework-side (classification by default; pass
    -regression for mean leaf values)."""
    model_path, flags = _parse_predict_args(argv, flags=("regression",))
    model_rows = []
    with open(model_path) as f:
        for line in f:
            if not line.strip():
                continue
            c = _cells(line)
            model_rows.append((int(c[0]), c[1], c[2], c[3], c[4], c[5]))
    if not model_rows:
        print("predict_forest: empty model file", file=sys.stderr)
        return 2

    from ..parallel.forest_shard import ensemble_predict_rows

    ids: List[str] = []
    X: List[List[float]] = []
    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 2 or cols[1] is None:
            continue
        ids.append(cols[0])
        X.append(_dense_list(cols[1]))
    if not ids:
        return 0
    preds = ensemble_predict_rows(model_rows, X,
                                  classification="regression" not in flags)
    for rid, p in zip(ids, preds):
        _emit(out, rid, float(p) if "regression" in flags else int(p))
    return 0


def _run_predict_gbt(argv: Sequence[str], src: IO[str], out: IO[str]) -> int:
    """(rowid, dense features) -> (rowid, label, score) over a GBT model
    TSV (the per-(round, class) train_gradient_tree_boosting_classifier
    emission): score_cls = intercept + shrinkage * sum over rounds of the
    class tree's leaf; binary label = score>0, multiclass = argmax."""
    model_path, _ = _parse_predict_args(argv)
    from ..models.trees.predict import compile_tree

    per_cls: dict = {}
    vocab = None
    with open(model_path) as f:
        for line in f:
            if not line.strip():
                continue
            c = _cells(line)
            cls = int(c[1])
            entry = per_cls.setdefault(
                cls, {"intercept": float(c[4]), "shrinkage": float(c[5]),
                      "trees": []})
            entry["trees"].append(compile_tree(c[2], c[3]))
            if vocab is None and len(c) > 8 and c[8] is not None:
                vocab = json.loads(c[8])
    if not per_cls:
        print("predict_gbt: empty model file", file=sys.stderr)
        return 2
    classes = sorted(per_cls)

    def to_label(index: int):
        # the emission's classes column maps score indices back to the
        # trained labels (arbitrary here; the reference requires 0..K-1
        # so its emission needs no vocabulary)
        return vocab[index] if vocab is not None else index

    for line in src:
        if not line.strip():
            continue
        cols = _cells(line)
        if len(cols) < 2 or cols[1] is None:
            continue
        x = _dense_list(cols[1])
        scores = {}
        for cls in classes:
            e = per_cls[cls]
            scores[cls] = e["intercept"] + e["shrinkage"] * sum(
                t(x) for t in e["trees"])
        if len(classes) == 1:  # binary: one tree stack, sign decides
            label = to_label(int(scores[classes[0]] > 0))
            _emit(out, cols[0], label, scores[classes[0]])
        else:
            best = max(classes, key=lambda cl: scores[cl])
            _emit(out, cols[0], to_label(best), scores[best])
    return 0


# ----------------------------------------------------------------------- CLI

def _pop_device(argv: List[str]):
    """(argv without --device, the device named or None)."""
    rest: List[str] = []
    device = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a device name")
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = _pop_device(argv)
    if not argv or argv[0] in ("-h", "--help", "-help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    src, out = sys.stdin, sys.stdout
    if cmd == "predict_linear":
        return _run_predict_linear(rest, src, out)
    if cmd == "predict_fm":
        return _run_predict_fm(rest, src, out)
    if cmd == "predict_multiclass":
        return _run_predict_multiclass(rest, src, out)
    if cmd == "predict_forest":
        return _run_predict_forest(rest, src, out)
    if cmd == "predict_ffm":
        return _run_predict_ffm(rest, src, out, device)
    if cmd == "predict_gbt":
        return _run_predict_gbt(rest, src, out)

    from ..sql.registry import REGISTRY

    is_trainer = cmd.startswith("train_") or cmd == "logress"
    if cmd not in REGISTRY or not is_trainer:
        print(f"unknown subcommand {cmd!r}; expected a train_* registry "
              "name or predict_{linear,fm,ffm,multiclass,forest,gbt}",
              file=sys.stderr)
        return 2
    options = " ".join(rest) if rest else None
    return _run_trainer(cmd, options, src, out, device)


if __name__ == "__main__":
    sys.exit(main())
