"""Transformation UDFs (ref: ftvec/trans/*.java)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def vectorize_features(feature_names: Sequence[str], *values) -> List[str]:
    """`vectorize_features(array('a','b'), a_val, b_val)` -> ["a:va", "b:vb"];
    zero/null values are skipped; value 1 emits the bare name — categorical
    convention (ref: ftvec/trans/VectorizeFeaturesUDF.java)."""
    if len(feature_names) != len(values):
        raise ValueError("feature names and values must align")
    out: List[str] = []
    for name, v in zip(feature_names, values):
        if v is None:
            continue
        if isinstance(v, str):
            if v == "":
                continue
            try:
                f = float(v)
            except ValueError:
                out.append(f"{name}#{v}")  # categorical string value
                continue
            v = f
        if v == 0:
            continue
        if v == 1:
            out.append(str(name))
        else:
            out.append(f"{name}:{v}")
    return out


def categorical_features(feature_names: Sequence[str], *values) -> List[str]:
    """`categorical_features(array('a','b'), v1, v2)` -> ["a#v1", "b#v2"]
    (ref: ftvec/trans/CategoricalFeaturesUDF.java)."""
    if len(feature_names) != len(values):
        raise ValueError("feature names and values must align")
    return [f"{n}#{v}" for n, v in zip(feature_names, values) if v is not None]


def quantitative_features(feature_names: Sequence[str], *values) -> List[str]:
    """`quantitative_features(array('a','b'), v1, v2)` -> ["a:v1", "b:v2"]
    (ref: ftvec/trans/QuantitativeFeaturesUDF.java); null/zero skipped."""
    if len(feature_names) != len(values):
        raise ValueError("feature names and values must align")
    out = []
    for n, v in zip(feature_names, values):
        if v is None:
            continue
        v = float(v)
        if v != 0.0:
            out.append(f"{n}:{v}")
    return out


def ffm_features(feature_names: Sequence[str], *values,
                 num_features: Optional[int] = None,
                 num_fields: int = 1024) -> List[str]:
    """`ffm_features(array('a','b'), v1, v2)` -> ["<field>:<index>:1", ...]
    hashing field names and feature#value pairs
    (ref: ftvec/trans/FFMFeaturesUDF.java)."""
    from ..utils.hashing import DEFAULT_NUM_FEATURES, mhash

    nf = num_features or DEFAULT_NUM_FEATURES
    out = []
    for field_idx, (name, v) in enumerate(zip(feature_names, values)):
        if v is None:
            continue
        feat = f"{name}#{v}"
        idx = mhash(feat, nf)
        out.append(f"{field_idx}:{idx}:1")
    return out


def indexed_features(*values) -> List[str]:
    """`indexed_features(v1, v2, ...)` -> ["1:v1", "2:v2", ...] (1-based)
    (ref: ftvec/trans/IndexedFeatures.java)."""
    return [f"{i + 1}:{float(v)}" for i, v in enumerate(values) if v is not None]


class Quantifier:
    """`quantified_features` stateful identifier assignment: maps each distinct
    non-numeric column value to a dense int id in first-seen order
    (ref: ftvec/trans/QuantifiedFeaturesUDTF.java, ftvec/conv/QuantifyColumnsUDTF.java)."""

    def __init__(self) -> None:
        self.maps: Dict[int, Dict[object, int]] = {}

    def quantify(self, col: int, value) -> float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        m = self.maps.setdefault(col, {})
        if value not in m:
            m[value] = len(m)
        return float(m[value])


def quantified_features(quantifier: Quantifier, *values) -> List[float]:
    return [quantifier.quantify(i, v) for i, v in enumerate(values)]


def binarize_label(pos: int, neg: int, *features) -> List[Tuple]:
    """`binarize_label(pos_cnt, neg_cnt, features...)` — emit `pos` rows with
    label 1 and `neg` rows with label 0 (ref: ftvec/trans/BinarizeLabelUDTF.java)."""
    if pos < 0 or neg < 0:
        raise ValueError("pos/neg must be non-negative")
    out = []
    for _ in range(pos):
        out.append(tuple(features) + (1,))
    for _ in range(neg):
        out.append(tuple(features) + (0,))
    return out


def onehot_encode(quantifier: Quantifier, *values) -> List[str]:
    """Categorical one-hot via the quantifier: value v of column i becomes
    feature "i#v"."""
    return [f"{i}#{v}" for i, v in enumerate(values) if v is not None]
