"""Scaling UDFs (ref: ftvec/scaling/{RescaleUDF,ZScoreUDF,L2NormalizationUDF}.java)."""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np


def rescale(value: Union[float, str], min_: float, max_: float):
    """min-max normalization; on "name:value" strings rescales the value part
    (ref: RescaleUDF.java:39-75). min == max maps to 0.5."""
    if isinstance(value, str):
        name, _, v = value.partition(":")
        if not v:
            raise ValueError(f"Invalid feature value representation: {value}")
        return f"{name}:{rescale(float(v), min_, max_)}"
    if min_ == max_:
        return 0.5
    v = (float(value) - min_) / (max_ - min_)
    return float(min(1.0, max(0.0, v)))


def zscore(value: Union[float, str], mean: float, stddev: float):
    """(value - mean) / stddev, 0 when stddev == 0 (ref: ZScoreUDF.java:34-48)."""
    if isinstance(value, str):
        name, _, v = value.partition(":")
        return f"{name}:{zscore(float(v), mean, stddev)}"
    if stddev == 0.0:
        return 0.0
    return float((float(value) - mean) / stddev)


def l2_normalize(ftvecs: Sequence[str]) -> List[str]:
    """Scale a "name:value" vector to unit L2 norm (ref: L2NormalizationUDF.java:38-70)."""
    if ftvecs is None:
        return None
    names, weights = [], []
    for fv in ftvecs:
        name, _, v = fv.partition(":")
        names.append(name)
        weights.append(float(v) if v else 1.0)
    w = np.asarray(weights, dtype=np.float64)
    norm = float(np.sqrt(np.sum(w * w)))
    if norm == 0.0:
        norm = 1.0
    return [f"{n}:{float(x / norm)}" for n, x in zip(names, w)]
