"""Apache Arrow engine bridge — the host-engine adapter layer (L6).

The reference binds to its host engines through Hive ObjectInspectors and a
Spark DataFrame DSL (ref: hivemall/UDTFWithOptions.java:48,
spark/src/main/scala/org/apache/spark/sql/hive/HivemallOps.scala:67-475).
Modern engines (Spark, DuckDB, Polars, Flight services, pandas) interchange
through Arrow, so THE engine-neutral binding here is Arrow-native:

- `arrow_ops(table, device=None)` — every registry trainer as a method
  over a pyarrow.Table with a hivemall-style features column
  (`list<string>` of "name:value" / "idx:value", exactly the reference's
  features array type), the HivemallOps analog;
- `model_to_arrow` / `model_from_arrow` — the trained model as an Arrow
  table `(feature, weight[, covar])`, the reference's model-table emission
  (`BinaryOnlineClassifierUDTF.close()`:249-298) in the interchange format
  every host engine can consume;
- `write_model_ipc` / `read_model_ipc` — Arrow IPC file round trip; reading
  one back is the `-loadmodel` warm start (LearnerBaseUDTF.java:215-333)
  without a Hive distributed cache;
- `predict_batches(model, reader)` — streaming scoring over a
  RecordBatchReader (the HivemallStreamingOps analog,
  HivemallStreamingOps.scala:27-46).

The port's copy of `hivemall_tpu/adapters/arrow.py`: the same tables and
files (an IPC file written by either package reads back in the other).
The trainers take the table's `device` (None: the CUDA device, raising
where there is none); the model-table functions are host numpy and take
no device. The registry (and with it torch) is imported at the first
trainer lookup, not with the module: `adapters/__init__` re-exports this
module, and the TRANSFORM bridge's predict process imports no torch.

Zero-copy note: numeric label columns cross via `to_numpy()` without
copying when they have no nulls; list-of-string feature columns are
necessarily materialized (the reference pays the same ObjectInspector
deserialization per row).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator, Optional

import numpy as np

if TYPE_CHECKING:
    from ..device import DeviceLike


def _require_pyarrow():
    try:
        import pyarrow as pa  # noqa: F401

        return pa
    except ImportError as e:
        raise ImportError(
            "the Arrow adapter needs pyarrow (pip install pyarrow)") from e


def table_features(table, features_col: str):
    """Extract a hivemall features column (`list<string>` of "name:value")
    from an Arrow table/batch into the list-of-rows form every train_* /
    predict consumes."""
    _require_pyarrow()
    col = table.column(features_col) if hasattr(table, "column") \
        else table[features_col]
    return col.to_pylist()


def table_labels(table, label_col: str) -> np.ndarray:
    col = table.column(label_col) if hasattr(table, "column") \
        else table[label_col]
    return np.asarray(col.to_numpy(zero_copy_only=False))


class ArrowOps:
    """`arrow_ops(table).train_arow("features", "label", "-dims 1024")` —
    every `train_*` in the SQL registry, over Arrow data, on `device`."""

    def __init__(self, table, device: DeviceLike = None):
        _require_pyarrow()
        self._table = table
        self._device = device

    @property
    def table(self):
        return self._table

    def __getattr__(self, name: str):
        if name.startswith("train_"):
            from ..sql import get_function

            try:
                fn = get_function(name)
            except KeyError:
                raise AttributeError(name) from None

            def trainer(features_col: str, label_col: str,
                        options: Optional[str] = None):
                feats = table_features(self._table, features_col)
                labels = table_labels(self._table, label_col)
                if options is None:
                    return fn(feats, labels, device=self._device)
                return fn(feats, labels, options, device=self._device)

            return trainer
        raise AttributeError(name)


def arrow_ops(table, device: DeviceLike = None) -> ArrowOps:
    return ArrowOps(table, device=device)


def model_to_arrow(model):
    """Emit a trained linear model as the reference's model table
    `(feature int64, weight float32[, covar float32])` — ready to hand to
    any Arrow-speaking engine for the join+groupby inference plan
    (SURVEY.md §3.5)."""
    pa = _require_pyarrow()
    from ..core.state import model_rows

    rows = model_rows(model.state)
    if len(rows) == 3 and rows[2] is not None:
        feats, w, cov = rows
        return pa.table({"feature": pa.array(feats, pa.int64()),
                         "weight": pa.array(w, pa.float32()),
                         "covar": pa.array(cov, pa.float32())})
    feats, w = rows[0], rows[1]
    return pa.table({"feature": pa.array(feats, pa.int64()),
                     "weight": pa.array(w, pa.float32())})


def model_from_arrow(table, dims: int):
    """Warm-start arrays from a model table: returns (initial_weights,
    initial_covars-or-None) for init_linear_state / the trainers'
    `initial_weights` / `initial_covars`. Errors on a dims mismatch rather
    than silently aliasing features into a smaller table."""
    feats = np.asarray(table.column("feature").to_numpy(zero_copy_only=False),
                       dtype=np.int64)
    if feats.size and (int(feats.max()) >= dims or int(feats.min()) < 0):
        raise ValueError(
            f"model table has feature ids outside [0, {dims}) "
            f"(min {int(feats.min())}, max {int(feats.max())}); "
            "load it with the dims it was trained at")
    w = np.zeros(dims, np.float32)
    w[feats] = table.column("weight").to_numpy(zero_copy_only=False)
    cov = None
    if "covar" in table.column_names:
        cov = np.ones(dims, np.float32)
        cov[feats] = table.column("covar").to_numpy(zero_copy_only=False)
    return w, cov


def write_model_ipc(model, path: str) -> None:
    pa = _require_pyarrow()
    import pyarrow.ipc as ipc

    t = model_to_arrow(model)
    with pa.OSFile(path, "wb") as f:
        with ipc.new_file(f, t.schema) as writer:
            writer.write_table(t)


def read_model_ipc(path: str, dims: int):
    pa = _require_pyarrow()
    import pyarrow.ipc as ipc

    with pa.memory_map(path, "rb") as f:
        t = ipc.open_file(f).read_all()
    return model_from_arrow(t, dims)


def predict_batches(model, batches, features_col: str = "features"
                    ) -> Iterator[np.ndarray]:
    """Streaming scoring over an iterable of RecordBatches / Tables (e.g. a
    RecordBatchReader): yields one score array per batch, scored on the
    model's device."""
    for batch in batches:
        feats = table_features(batch, features_col)
        yield np.asarray(model.predict(feats))
