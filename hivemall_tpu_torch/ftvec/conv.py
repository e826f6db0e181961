"""Conversion UDFs (ref: ftvec/conv/*.java)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.feature import parse_feature
from .trans import Quantifier


def conv2dense(feature_rows: Sequence[Tuple[int, float]], nDims: int) -> np.ndarray:
    """`conv2dense(feature, weight, nDims)` UDAF — collect (feature, weight)
    rows into one dense float vector (ref: ftvec/conv/ConvertToDenseModelUDAF.java:33)."""
    out = np.zeros(nDims, dtype=np.float32)
    for f, w in feature_rows:
        if f >= nDims:
            raise ValueError(f"feature {f} outside dims {nDims}")
        out[f] = w
    return out


def to_dense_features(ftvec: Sequence[str], dimensions: int) -> np.ndarray:
    """"idx:value" strings -> dense float[dimensions] (1-based indices kept
    as-is like the reference) (ref: ftvec/conv/ToDenseFeaturesUDF.java)."""
    out = np.zeros(dimensions + 1, dtype=np.float32)
    for fv in ftvec:
        name, v = parse_feature(fv)
        idx = int(name)
        if idx > dimensions:
            raise ValueError(f"feature index {idx} > dimensions {dimensions}")
        out[idx] = v
    return out


def to_sparse_features(dense: Sequence[float]) -> List[str]:
    """dense vector -> "idx:value" strings, skipping zeros
    (ref: ftvec/conv/ToSparseFeaturesUDF.java)."""
    return [f"{i}:{float(v)}" for i, v in enumerate(dense) if v is not None and v != 0.0]


def quantify(quantifier: Optional[Quantifier], *values) -> List[float]:
    """`quantify(output_row, col1, col2, ...)` — assign dense int ids to
    non-numeric columns (ref: ftvec/conv/QuantifyColumnsUDTF.java)."""
    q = quantifier if quantifier is not None else Quantifier()
    return [q.quantify(i, v) for i, v in enumerate(values)]
