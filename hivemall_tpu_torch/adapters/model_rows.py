"""Typed per-family model-row iteration.

Every trainer family dumps its model as relational rows at close() in the
reference (linear: BinaryOnlineClassifierUDTF.java:249-298). The column
names and row forms are the JAX package's
(`hivemall_tpu/adapters/model_rows.py`), which a serving artifact's
manifest records as ``meta["columns"]``.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def iter_model_rows(model) -> Tuple[List[str], Iterable[tuple]]:
    """(column_names, iterable of typed row tuples) for a trained model.

    - FM: feature(int), Wi(float), Vif(list[float]|None) — w0 rides the
      feature == -1 row (the TSV/SQL convention; the reference parks it on
      feature 0's bias slot)
    - FFM: feature(int), Wi(float), blob(str|None) — w0 on the feature == -1
      row, then the touched features' weights, then a feature == -2 row
      carrying the whole model as basE91 text of ``to_blob()``
    - GBT: iter(int), cls(int), model_type(str), pred_model(str),
      intercept(float), shrinkage(float), var_importance(list[float]),
      oob_error_rate(None), classes(str, the JSON label vocabulary) — one
      row per (boosting round, class tree)
    - forest: model_id(int), model_type(str), pred_model(str),
      var_importance(list[float]), oob_errors(int), oob_tests(int)
    - multiclass: label, feature(int), weight(float)[, covar(float)] over
      the touched (label, feature) entries
    - linear: feature(int), weight(float)[, covar(float)]

    MF has no row emission (as in the JAX package) and raises ValueError.
    """
    from ..models.ffm import TrainedFFMModel
    from ..models.fm import TrainedFMModel
    from ..models.mf import TrainedMFModel
    from ..models.trees.forest import TrainedForest, TrainedGBT

    if isinstance(model, TrainedMFModel):
        raise ValueError(f"{type(model).__name__}: model has no row emission")

    if isinstance(model, TrainedGBT):
        cols = ["iter", "cls", "model_type", "pred_model", "intercept",
                "shrinkage", "var_importance", "oob_error_rate", "classes"]

        def gbt_rows():
            for m, c, mt, text, ic, sh, imp, oob, vocab in model.model_rows():
                yield (int(m), int(c), str(mt), text, float(ic), float(sh),
                       [float(x) for x in imp], oob, vocab)

        return cols, gbt_rows()

    if isinstance(model, TrainedFMModel):
        def fm_rows():
            w0, feats, w, v = model.model_rows()
            yield (-1, float(w0), None)
            for f, wi, vi in zip(feats, w, v):
                yield (int(f), float(wi), [float(x) for x in vi])

        return ["feature", "Wi", "Vif"], fm_rows()

    if isinstance(model, TrainedFFMModel):
        def ffm_rows():
            from ..utils.codec import base91

            feats, w, w0 = model.model_rows()
            yield (-1, float(w0), None)
            for f, wi in zip(feats, w):
                yield (int(f), float(wi), None)
            yield (-2, None, base91(model.to_blob()))

        return ["feature", "Wi", "blob"], ffm_rows()

    if isinstance(model, TrainedForest):
        cols = ["model_id", "model_type", "pred_model", "var_importance",
                "oob_errors", "oob_tests"]

        def forest_rows():
            for mid, mtype, text, imp, oe, ot in model.model_rows():
                yield (int(mid), str(mtype), text,
                       [float(x) for x in imp], int(oe), int(ot))

        return cols, forest_rows()

    if hasattr(model, "label_vocab"):  # multiclass family
        rows = model.model_rows()
        cols = (["label", "feature", "weight", "covar"] if len(rows) == 4
                else ["label", "feature", "weight"])

        def mc_rows():
            for tup in zip(*rows):
                lab, feat, w = tup[0], int(tup[1]), float(tup[2])
                if len(tup) == 4:
                    yield (lab, feat, w, float(tup[3]))
                else:
                    yield (lab, feat, w)

        return cols, mc_rows()

    if not (hasattr(model, "state") and hasattr(model.state, "weights")):
        raise ValueError(f"{type(model).__name__}: model has no row emission")
    from ..core.state import model_rows as linear_rows

    rows = linear_rows(model.state)
    use_cov = len(rows) == 3 and rows[2] is not None
    cols = (["feature", "weight", "covar"] if use_cov
            else ["feature", "weight"])

    def lin_rows():
        if use_cov:
            for f, w, c in zip(*rows):
                yield (int(f), float(w), float(c))
        else:
            for f, w in zip(rows[0], rows[1]):
                yield (int(f), float(w))

    return cols, lin_rows()
