"""DataFrame DSL — the Spark-module analog.

The reference's spark module wraps every trainer as an implicit DataFrame
method (`df.train_arow('features, 'label)` etc.,
ref: spark/src/main/scala/org/apache/spark/sql/hive/HivemallOps.scala:67-475)
plus grouped aggregates (GroupedDataEx.scala:134-257). The pandas-facing
equivalent here wraps the same registry:

    hf = hivemall_ops(df)                       # df: pandas DataFrame
    model = hf.train_arow("features", "label", "-dims 1024")
    df2 = hf.amplify(3)
    agg = hf.groupby("feature").argmin_kld("weight", "covar")

Streaming predict (HivemallStreamingOps.scala:27-46) maps to
`predict_stream(model, batches)` over an iterator of DataFrames.

The port's copy of `hivemall_tpu/adapters/dataframe.py`: the same methods
and frames. `hivemall_ops(df, device=None)` / `HivemallFrame(df,
mix_servs=None, device=None)` hand `device` to every trainer (None: the
CUDA device, raising where there is none), and transforms and
`set_mix_servs` keep it. The registry (and with it torch) is imported at
the first trainer lookup, as in arrow.py.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Iterable, Iterator, Optional

import numpy as np

from ..ensemble import argmin_kld as _argmin_kld
from ..ensemble import max_label as _max_label
from ..ensemble import voted_avg as _voted_avg
from ..ensemble import weight_voted_avg as _weight_voted_avg

if TYPE_CHECKING:
    from ..device import DeviceLike


class _GroupedOps:
    def __init__(self, df, by):
        self._df = df
        self._by = by

    def _agg(self, fn: Callable, *cols: str, name: str = "value"):
        import pandas as pd

        rows = []
        for key, grp in self._df.groupby(self._by):
            if len(cols) == 1:
                out = fn(grp[cols[0]].tolist())
            else:
                out = fn(list(zip(*(grp[c].tolist() for c in cols))))
            rows.append((key, out))
        return pd.DataFrame(rows, columns=[self._by, name])

    def voted_avg(self, col: str):
        return self._agg(_voted_avg, col)

    def weight_voted_avg(self, col: str):
        return self._agg(_weight_voted_avg, col)

    def argmin_kld(self, mean_col: str, covar_col: str):
        return self._agg(_argmin_kld, mean_col, covar_col)

    def max_label(self, score_col: str, label_col: str):
        return self._agg(_max_label, score_col, label_col)

    def rf_ensemble(self, col: str):
        from ..ensemble import rf_ensemble

        return self._agg(rf_ensemble, col)

    def maxrow(self, compare_col: str):
        import pandas as pd

        from ..ensemble import maxrow as mr

        cols = list(self._df.columns)
        ci = cols.index(compare_col)
        rows = [(k,) + tuple(mr([tuple(r) for r in g.itertuples(index=False)], ci))
                for k, g in self._df.groupby(self._by)]
        return pd.DataFrame(rows, columns=["group"] + cols)

    def _metric(self, fn, pred_col: str, actual_col: str, name: str):
        import pandas as pd

        rows = [(k, fn(g[pred_col], g[actual_col]))
                for k, g in self._df.groupby(self._by)]
        return pd.DataFrame(rows, columns=[self._by, name])

    def mae(self, pred_col: str, actual_col: str):
        from ..evaluation import mae

        return self._metric(mae, pred_col, actual_col, "mae")

    def mse(self, pred_col: str, actual_col: str):
        from ..evaluation import mse

        return self._metric(mse, pred_col, actual_col, "mse")

    def rmse(self, pred_col: str, actual_col: str):
        from ..evaluation import rmse

        return self._metric(rmse, pred_col, actual_col, "rmse")

    def f1score(self, actual_col: str, pred_col: str):
        import pandas as pd

        from ..evaluation import f1score

        rows = [(k, f1score(g[actual_col].tolist(), g[pred_col].tolist()))
                for k, g in self._df.groupby(self._by)]
        return pd.DataFrame(rows, columns=[self._by, "f1score"])


class HivemallFrame:
    """Thin wrapper exposing registry functions as DataFrame methods; the
    trainers run on `device`."""

    def __init__(self, df, mix_servs: Optional[str] = None,
                 device: DeviceLike = None):
        self._df = df
        self._mix_servs = mix_servs
        self._device = device

    @property
    def df(self):
        return self._df

    def groupby(self, by: str) -> _GroupedOps:
        return _GroupedOps(self._df, by)

    def _wrap(self, df) -> "HivemallFrame":
        """Transforms keep the set_mix_servs config and the device of the
        source frame."""
        return HivemallFrame(df, mix_servs=self._mix_servs,
                             device=self._device)

    # ---- trainers: df.train_xxx(features_col, label_col, options) ----
    def __getattr__(self, name: str):
        if name.startswith("train_"):
            from ..sql import get_function

            fn = get_function(name)

            def trainer(features_col: str, label_col: str,
                        options: Optional[str] = None, **kw):
                from ..utils.options import OptionError

                feats = self._df[features_col].tolist()
                labels = self._df[label_col].to_numpy()
                dev = self._device
                if self._mix_servs:
                    mix = f"-mix {self._mix_servs}"
                    try:
                        return fn(feats, labels,
                                  f"{options} {mix}" if options else mix,
                                  device=dev, **kw)
                    except OptionError as e:
                        if "unknown option '-mix'" not in str(e):
                            raise
                        # batch trainers (forest/GBT) take no -mix, like the
                        # reference's own UDTFs; train without it
                        import warnings

                        warnings.warn(f"{name} does not accept -mix; "
                                      "set_mix_servs ignored for this trainer")
                return fn(feats, labels, options, device=dev, **kw)

            return trainer
        raise AttributeError(name)

    def set_mix_servs(self, servers: str) -> "HivemallFrame":
        """Inject `-mix <servers>` into every subsequent train_* call
        (ref: HivemallOps.scala:692 setMixServs)."""
        return HivemallFrame(self._df, mix_servs=servers, device=self._device)

    # ---- row transforms mirroring HivemallOps:521-673 ----
    def amplify(self, xtimes: int) -> "HivemallFrame":
        idx = np.repeat(np.arange(len(self._df)), xtimes)
        return self._wrap(self._df.iloc[idx].reset_index(drop=True))

    def rand_amplify(self, xtimes: int, num_buffers: int = 2,
                     seed: int = 31) -> "HivemallFrame":
        import pandas as pd

        from ..ftvec import rand_amplify as ra

        rows = list(ra(xtimes, num_buffers, self._df.itertuples(index=False),
                       seed=seed))
        return self._wrap(pd.DataFrame(rows, columns=list(self._df.columns)))

    def part_amplify(self, xtimes: int) -> "HivemallFrame":
        """Partition-local amplify (HivemallOps.scala part_amplify). A pandas
        DataFrame is one partition, so this equals `amplify` without any
        shuffle — kept as its own method so ported Spark code reads 1:1."""
        return self.amplify(xtimes)

    def explode_array(self, col: str) -> "HivemallFrame":
        """One output row per array element (HivemallOps.scala explode_array).
        Empty/None/NaN cells yield zero rows (Hive explode semantics)
        rather than pandas' NaN placeholder row."""
        keep = self._df[col].map(
            lambda a: isinstance(a, (list, tuple, np.ndarray)) and len(a) > 0)
        return self._wrap(self._df[keep].explode(col).reset_index(drop=True))

    def minhash(self, item_col: str, features_col: str, num_hashes: int = 5,
                num_keygroups: int = 2) -> "HivemallFrame":
        """Emit (clusterid, item) pairs per row — one per hash function
        (HivemallOps.scala minhash over knn/lsh/MinHashUDTF.java)."""
        import pandas as pd

        from ..knn import minhash as mh

        rows = []
        for r in self._df.to_dict("records"):
            rows.extend(mh(r[item_col], r[features_col],
                           num_hashes, num_keygroups))
        return self._wrap(pd.DataFrame(rows, columns=["clusterid", item_col]))

    def quantify(self, *cols: str) -> "HivemallFrame":
        """Map non-numeric values of the given columns (all columns when none
        given) to dense int ids in first-seen order, sharing one quantifier
        across rows (HivemallOps.scala quantify over QuantifyColumnsUDTF)."""
        from ..ftvec import Quantifier

        out = self._df.copy()
        use = list(cols) if cols else list(out.columns)
        q = Quantifier()
        for ci, c in enumerate(use):
            out[c] = [q.quantify(ci, v) for v in out[c]]
        return self._wrap(out)

    def binarize_label(self, pos_col: str, neg_col: str,
                       *feature_cols: str) -> "HivemallFrame":
        """Expand aggregated (pos_count, neg_count, features...) rows into
        `pos` label-1 rows and `neg` label-0 rows
        (HivemallOps.scala binarize_label over BinarizeLabelUDTF)."""
        import pandas as pd

        from ..ftvec import binarize_label as bl

        rows = []
        for r in self._df.to_dict("records"):
            feats = tuple(r[c] for c in feature_cols)
            rows.extend(bl(int(r[pos_col]), int(r[neg_col]), *feats))
        return self._wrap(
            pd.DataFrame(rows, columns=list(feature_cols) + ["label"]))

    def each_top_k(self, k: int, group_col: str, value_col: str) -> "HivemallFrame":
        import pandas as pd

        from ..tools import each_top_k as etk

        df = self._df.sort_values(group_col, kind="mergesort")
        # tuple(dict) yields the KEYS — the payload carries the row VALUES
        rows_in = ((r[group_col], r[value_col], tuple(r.values()))
                   for r in df.to_dict("records"))
        out = [(rank, value) + tuple(payload)
               for rank, value, payload in etk(k, rows_in)]
        cols = ["rank", "value"] + list(df.columns)
        return self._wrap(pd.DataFrame(out, columns=cols))


def hivemall_ops(df, device: DeviceLike = None) -> HivemallFrame:
    return HivemallFrame(df, device=device)


def lr_datagen_frame(options: Optional[str] = None):
    """Synthetic LR dataset as a DataFrame with features/label columns
    (HivemallOps.scala lr_datagen over dataset/LogisticRegressionDataGeneratorUDTF)."""
    import pandas as pd

    from ..dataset import lr_datagen

    rows, labels = lr_datagen(options)
    return pd.DataFrame({"features": list(rows), "label": labels})


def predict_stream(model, batches: Iterable, features_col: str = "features"
                   ) -> Iterator[np.ndarray]:
    """Streaming predict bridge (HivemallStreamingOps analog): yields scores
    per incoming DataFrame batch, scored on the model's device."""
    for batch in batches:
        yield model.predict(batch[features_col].tolist())
