"""Typed per-family model-row iteration.

Every trainer family dumps its model as relational rows at close() in the
reference (linear: BinaryOnlineClassifierUDTF.java:249-298). The port has
the linear family so far; the column names are the JAX package's
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
    - linear: feature(int), weight(float)[, covar(float)]

    MF has no row emission (as in the JAX package); other families
    (multiclass, FFM, trees) are later slices of the port. Both raise
    ValueError.
    """
    from ..models.fm import TrainedFMModel
    from ..models.mf import TrainedMFModel

    if isinstance(model, TrainedMFModel):
        raise ValueError(f"{type(model).__name__}: model has no row emission")

    if isinstance(model, TrainedFMModel):
        def fm_rows():
            w0, feats, w, v = model.model_rows()
            yield (-1, float(w0), None)
            for f, wi, vi in zip(feats, w, v):
                yield (int(f), float(wi), [float(x) for x in vi])

        return ["feature", "Wi", "Vif"], fm_rows()
    if hasattr(model, "label_vocab") or not (
            hasattr(model, "state") and hasattr(model.state, "weights")):
        raise ValueError(
            f"{type(model).__name__}: model has no row emission in the torch "
            f"port (hivemall_tpu_torch) — the linear and FM families are "
            f"ported; the other families are later slices")
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
