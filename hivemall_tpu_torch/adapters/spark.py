"""pyspark DataFrame DSL — the Spark-module surface (HivemallOps parity).

The reference's spark module exposes every trainer as a DataFrame method
(`df.train_arow('features, 'label)`, ref: spark/src/main/scala/org/apache/
spark/sql/hive/HivemallOps.scala:67-475), grouped ensemble/metric
aggregates (GroupedDataEx.scala:134-257), `setMixServs` (:692), and a
streaming predict bridge (HivemallStreamingOps.scala:27-46). Training
runs inside each task and emits model rows that the caller merges with a
group-by aggregate — exactly the Hive flow (per-mapper UDTF + ensemble
UDAF), which maps 1:1 onto pyspark's `mapInPandas` (one trainer per
partition) + `groupBy().applyInPandas` (the merge).

pyspark is not bundled in this image, so the adapter is written against
the narrow structural contract it needs — `df.mapInPandas(fn, schema)`,
`df.groupBy(col).applyInPandas(fn, schema)`, `df.schema` — and the glue is
tested on simulated partitioned frames implementing that contract
(tests/test_spark_adapter.py). On a real cluster:

    from hivemall_tpu_torch.adapters.spark import spark_hivemall_ops

    rows = spark_hivemall_ops(train_df).train_arow(
        "features", "label", "-dims 16777216")        # one model/partition
    model = spark_hivemall_ops(rows).groupby("feature").argmin_kld(
        "weight", "covar", key_type="bigint")          # ensemble merge

Every computation delegates to the tested pandas DSL (dataframe.py) and
the shared row emission (model_rows.py); this module only places work onto
partitions/groups and declares Spark schemas.

The port's copy of `hivemall_tpu/adapters/spark.py`: the same schemas and
placement. `spark_hivemall_ops(df, mix_servs=None, device=None)` trains
each partition's model on `device` (None: the CUDA device, raising where
there is none). The functions handed to `mapInPandas` carry the device
as a string or None, never a tensor, a model or a `torch.device`: each
executor is its own process and resolves the device itself.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Iterator, Optional

from .dataframe import HivemallFrame, hivemall_ops

if TYPE_CHECKING:
    from ..device import DeviceLike

# Covariance emitters: (feature, weight, covar) — everything else emits
# (feature, weight). Mirrors each rule's use_covariance
# (models/classifier.py, models/regression.py; the names are the stable
# define-all surface, cross-checked against the trained model's actual
# columns at executor time).
_COV_LINEAR = frozenset((
    "train_cw", "train_arow", "train_arowh", "train_scw", "train_scw2",
    "train_arow_regr", "train_arowe_regr", "train_arowe2_regr",
))
_COV_MULTICLASS = frozenset((
    "train_multiclass_cw", "train_multiclass_arow", "train_multiclass_arowh",
    "train_multiclass_scw", "train_multiclass_scw2",
))
_MF_TRAINERS = frozenset(("train_mf_sgd", "train_mf_adagrad", "train_bprmf"))


def model_row_schema(trainer: str) -> str:
    """Spark DDL schema of `trainer`'s model-row emission (column layouts:
    adapters/model_rows.iter_model_rows)."""
    if trainer == "train_fm":
        return "feature bigint, Wi double, Vif array<double>"
    if trainer == "train_ffm":
        return "feature bigint, Wi double, blob string"
    if trainer == "train_gradient_tree_boosting_classifier":
        return ("iter bigint, cls bigint, model_type string, "
                "pred_model string, intercept double, shrinkage double, "
                "var_importance array<double>, oob_error_rate double, "
                "classes string")
    if trainer.startswith("train_randomforest"):
        return ("model_id bigint, model_type string, pred_model string, "
                "var_importance array<double>, oob_errors bigint, "
                "oob_tests bigint")
    if trainer.startswith("train_multiclass"):
        cov = ", covar double" if trainer in _COV_MULTICLASS else ""
        return f"label string, feature bigint, weight double{cov}"
    cov = ", covar double" if trainer in _COV_LINEAR else ""
    return f"feature bigint, weight double{cov}"


def _rows_frame(trainer: str, model, declared: str):
    """Model rows -> pandas frame matching `declared` (loud on mismatch:
    a silent schema drift would surface as nulls cluster-side)."""
    import pandas as pd

    from .model_rows import iter_model_rows

    cols, rows = iter_model_rows(model)
    declared_cols = [c.strip().split()[0] for c in declared.split(",")]
    if cols != declared_cols:
        raise ValueError(
            f"{trainer}: emitted columns {cols} != declared {declared_cols}")
    frame = pd.DataFrame(list(rows), columns=cols)
    if trainer.startswith("train_multiclass"):
        frame["label"] = frame["label"].astype(str)
    return frame


class SparkGroupedOps:
    """GroupedDataEx surface: each aggregate runs the pandas DSL per group
    via applyInPandas. `key_type` is the group column's Spark type in the
    output schema (defaults from df.schema when introspectable)."""

    def __init__(self, df, by: str):
        self._df = df
        self._by = by

    def _key_ddl(self, key_type: Optional[str]) -> str:
        if key_type:
            return key_type
        try:  # pyspark: StructType fields carry DDL-able types
            for f in self._df.schema.fields:
                if f.name == self._by:
                    return f.dataType.simpleString()
        except Exception:
            pass
        return "string"

    def _agg(self, op: str, *cols: str, name: str, val_type: str,
             key_type: Optional[str] = None, post=None):
        """`post` coerces the value column to the declared Spark type
        (e.g. str for labels, JSON for the rf_ensemble struct) — pyspark's
        Arrow conversion errors on object-dtype mismatches instead of
        casting."""
        by = self._by
        schema = f"{by} {self._key_ddl(key_type)}, {name} {val_type}"

        def fn(pdf):
            out = getattr(hivemall_ops(pdf).groupby(by), op)(*cols)
            if post is not None:
                out[out.columns[-1]] = out[out.columns[-1]].apply(post)
            return out

        return self._df.groupBy(by).applyInPandas(fn, schema=schema)

    def voted_avg(self, col: str, key_type: Optional[str] = None):
        return self._agg("voted_avg", col, name="value", val_type="double",
                         key_type=key_type)

    def weight_voted_avg(self, col: str, key_type: Optional[str] = None):
        return self._agg("weight_voted_avg", col, name="value",
                         val_type="double", key_type=key_type)

    def argmin_kld(self, mean_col: str, covar_col: str,
                   key_type: Optional[str] = None):
        return self._agg("argmin_kld", mean_col, covar_col, name="value",
                         val_type="double", key_type=key_type)

    def max_label(self, score_col: str, label_col: str,
                  key_type: Optional[str] = None):
        # labels keep their source dtype in the ensemble op -> stringify
        return self._agg("max_label", score_col, label_col, name="value",
                         val_type="string", key_type=key_type, post=str)

    def rf_ensemble(self, col: str, key_type: Optional[str] = None):
        # (label, probability, posteriori) struct -> JSON text, the same
        # encoding the SQL engine binding uses (sqlite._rf_ensemble_json)
        import json

        return self._agg(
            "rf_ensemble", col, name="value", val_type="string",
            key_type=key_type,
            post=lambda t: json.dumps({"label": int(t[0]),
                                       "probability": float(t[1]),
                                       "probabilities": [float(p)
                                                         for p in t[2]]}))

    def mae(self, pred_col: str, actual_col: str,
            key_type: Optional[str] = None):
        return self._agg("mae", pred_col, actual_col, name="mae",
                         val_type="double", key_type=key_type)

    def mse(self, pred_col: str, actual_col: str,
            key_type: Optional[str] = None):
        return self._agg("mse", pred_col, actual_col, name="mse",
                         val_type="double", key_type=key_type)

    def rmse(self, pred_col: str, actual_col: str,
             key_type: Optional[str] = None):
        return self._agg("rmse", pred_col, actual_col, name="rmse",
                         val_type="double", key_type=key_type)

    def f1score(self, actual_col: str, pred_col: str,
                key_type: Optional[str] = None):
        return self._agg("f1score", actual_col, pred_col, name="f1score",
                         val_type="double", key_type=key_type)


class SparkHivemallOps:
    def __init__(self, df, mix_servs: Optional[str] = None,
                 device: DeviceLike = None):
        self._df = df
        self._mix_servs = mix_servs
        # what the executors' closures carry: a string or None
        self._device = None if device is None else str(device)

    @property
    def df(self):
        return self._df

    def set_mix_servs(self, servers: str) -> "SparkHivemallOps":
        """Inject `-mix <servers>` into every subsequent train_* call
        (ref: HivemallOps.scala:692 setMixServs)."""
        return SparkHivemallOps(self._df, mix_servs=servers,
                                device=self._device)

    def groupby(self, by: str) -> SparkGroupedOps:
        return SparkGroupedOps(self._df, by)

    # Alias matching pyspark naming
    groupBy = groupby

    # ---- trainers: one model per partition, merged by the caller ----
    def __getattr__(self, name: str):
        if not name.startswith("train_"):
            raise AttributeError(name)
        if name in _MF_TRAINERS:
            raise NotImplementedError(
                f"{name} takes (user, item, rating) rows — use the Hive "
                "TRANSFORM bridge (adapters/hive_transform.py) or the "
                "direct API (models/mf.py) for matrix factorization")
        # fail fast on the driver: a typo'd trainer name must not surface
        # as an executor task failure after the job launches
        from ..sql import get_function

        get_function(name)
        mix, dev = self._mix_servs, self._device
        schema = model_row_schema(name)

        def trainer(features_col: str, label_col: str,
                    options: Optional[str] = None):
            def fn(pdf_iter: Iterator) -> Iterator:
                import pandas as pd

                # Spark invokes the function on EMPTY partitions too
                # (repartition over small data); emit nothing for those
                chunks = [c for c in pdf_iter if len(c)]
                if not chunks:
                    return
                pdf = pd.concat(chunks, ignore_index=True)
                hf = HivemallFrame(pdf, mix_servs=mix, device=dev)
                model = getattr(hf, name)(features_col, label_col, options)
                yield _rows_frame(name, model, schema)

            return self._df.mapInPandas(fn, schema=schema)

        return trainer

    # ---- row transforms (HivemallOps.scala:521-673) ----
    def transform(self, method: str, *args, schema=None, **kw):
        """Apply any HivemallFrame transform per partition. `schema=None`
        reuses the input schema (for row-preserving/reordering transforms);
        pass a DDL string when the transform changes columns."""
        mix, dev = self._mix_servs, self._device
        out_schema = self._df.schema if schema is None else schema

        def fn(pdf_iter: Iterator) -> Iterator:
            import pandas as pd

            chunks = [c for c in pdf_iter if len(c)]
            if not chunks:
                return  # empty partition — emit nothing
            pdf = pd.concat(chunks, ignore_index=True)
            yield getattr(HivemallFrame(pdf, mix_servs=mix, device=dev),
                          method)(*args, **kw).df

        return SparkHivemallOps(
            self._df.mapInPandas(fn, schema=out_schema), mix_servs=mix,
            device=dev)

    def amplify(self, xtimes: int) -> "SparkHivemallOps":
        return self.transform("amplify", xtimes)

    def rand_amplify(self, xtimes: int, num_buffers: int = 2,
                     seed: int = 31) -> "SparkHivemallOps":
        """Per-partition buffered shuffle amplification — the map-side
        semantics of the reference (RandomAmplifierUDTF runs per mapper)."""
        return self.transform("rand_amplify", xtimes, num_buffers, seed)

    def part_amplify(self, xtimes: int) -> "SparkHivemallOps":
        return self.transform("part_amplify", xtimes)

    def each_top_k(self, k: int, group_col: str, value_col: str, *,
                   schema: str) -> "SparkHivemallOps":
        """Per-partition top-k per group (rank/value columns prepended).
        Like the reference UDTF, input must be clustered by `group_col`
        (repartition by it first); `schema` declares the output columns
        ('rank int, value double, <input columns...>')."""
        return self.transform("each_top_k", k, group_col, value_col,
                              schema=schema)


def spark_hivemall_ops(df, mix_servs: Optional[str] = None,
                       device: DeviceLike = None) -> SparkHivemallOps:
    return SparkHivemallOps(df, mix_servs=mix_servs, device=device)


def lr_datagen_spark(spark, options: Optional[str] = None):
    """Synthetic LR dataset as a Spark DataFrame (HivemallOps lr_datagen
    analog): features as array<string>, label double."""
    from .dataframe import lr_datagen_frame

    pdf = lr_datagen_frame(options)
    pdf = pdf.assign(features=pdf["features"].apply(
        lambda r: [str(t) for t in r]))
    return spark.createDataFrame(pdf)


def predict_stream_spark(model, batches: Iterable, features_col: str =
                         "features") -> Iterator:
    """Streaming predict bridge (HivemallStreamingOps.scala:27-46 analog):
    score each micro-batch DataFrame as it arrives (use from
    foreachBatch). Yields one numpy score array per batch, scored on the
    model's device; batches may be pyspark DataFrames (collected via
    toPandas) or pandas frames."""
    from .dataframe import predict_stream

    def to_pandas(b):
        return b.toPandas() if hasattr(b, "toPandas") else b

    return predict_stream(model, (to_pandas(b) for b in batches),
                          features_col)
