"""Feature parsing — the host-side front door of the framework.

The linear learners' feature grammar: ``"name"`` or ``"name:value"`` —
split at the FIRST colon, value defaults to 1.0, name may be an int index or
arbitrary string (ref: core/.../model/FeatureValue.java:74-93). The FM/FFM
grammar, ``"field:index:value"`` or ``"index:value"``, is `FMFeature`.

String names are folded into the hashed feature space with bit-identical
MurmurHash3 (see utils/hashing.py), which is the reference's own default
canonicalization (ref: ftvec/hashing/FeatureHashingUDF.java:172).

`parse_features_batch` parses through the native host library's C parser
(`native.parse_features_bulk`, as the JAX package does) and keeps the
numpy path, `parse_features_numpy`, for what the C parser declines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np

from .hashing import DEFAULT_NUM_FEATURES, mhash, murmurhash3_bytes_batch

FeatureLike = Union[str, Tuple[int, float], Tuple[str, float]]


@dataclass
class FeatureValue:
    """Parsed (feature, value) pair (ref: model/FeatureValue.java:26)."""

    feature: Union[int, str]
    value: float = 1.0

    @staticmethod
    def parse(s: str) -> "FeatureValue":
        if not s:
            raise ValueError("feature string is empty")
        pos = s.find(":")
        if pos == 0:
            raise ValueError(f"invalid feature {s!r}")
        if pos < 0:
            name: Union[int, str] = s
            value = 1.0
        else:
            name = s[:pos]
            vs = s[pos + 1 :]
            if not vs:
                raise ValueError(f"invalid feature value {s!r}")
            value = float(vs)
        try:
            name = int(name)
        except (TypeError, ValueError):
            pass
        return FeatureValue(name, value)


def parse_feature(s: str) -> Tuple[Union[int, str], float]:
    fv = FeatureValue.parse(s)
    return fv.feature, fv.value


def parse_features_batch(
    rows: Sequence[Sequence[FeatureLike]],
    num_features: int = DEFAULT_NUM_FEATURES,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Parse many rows of features into (indices, values) numpy arrays.

    Accepts per-row lists of "name[:value]" strings or (name, value) tuples.
    String names are bulk murmur-hashed; int names index the space directly,
    matching the reference's dense-model int-feature path
    (ref: LearnerBaseUDTF.java:164-196 dense vs sparse model selection).
    The C parser takes every row set it accepts (parse + hash + mod in one
    pass); tuple features, exotic numeric literals and malformed tokens go
    to `parse_features_numpy`, which keeps the error behavior.
    """
    from .. import native

    fast = native.parse_features_bulk(rows, num_features)
    if fast is not None:
        return fast
    return parse_features_numpy(rows, num_features)


def parse_features_numpy(
    rows: Sequence[Sequence[FeatureLike]],
    num_features: int = DEFAULT_NUM_FEATURES,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """`parse_features_batch` without the C parser: a Python loop over the
    tokens and one vectorized hash pass over the string names."""
    idx_rows: List[np.ndarray] = []
    val_rows: List[np.ndarray] = []
    # Collect string names for one vectorized hash pass.
    str_names: List[str] = []
    str_slots: List[Tuple[int, int]] = []  # (row, k) positions to backfill
    for r, row in enumerate(rows):
        idxs = np.empty(len(row), dtype=np.int64)
        vals = np.empty(len(row), dtype=np.float32)
        for k, f in enumerate(row):
            if isinstance(f, str):
                name, value = parse_feature(f)
            else:
                name, value = f
            vals[k] = value
            if isinstance(name, (int, np.integer)):
                idxs[k] = int(name) % num_features
            else:
                idxs[k] = -1
                str_slots.append((r, k))
                str_names.append(str(name))
        idx_rows.append(idxs)
        val_rows.append(vals)
    if str_names:
        hashed = murmurhash3_bytes_batch(str_names, num_features)
        for (r, k), h in zip(str_slots, hashed):
            idx_rows[r][k] = h
    return idx_rows, val_rows


@dataclass
class FMFeature:
    """FM/FFM feature: (field, index, value) (ref: fm/Feature.java:32).
    The JAX package's grammar, statement for statement: a string field
    hashes into [0, num_fields), a string index into [0, num_features).
    Note that the negative-index check raises INSIDE the int parse's
    handler, so with ``as_int`` (the default) a negative index is hashed
    as a string like any other non-integer index."""

    index: int
    value: float
    field: int = -1  # -1 when not field-aware

    @staticmethod
    def parse(s: str, as_int: bool = True,
              num_features: int = DEFAULT_NUM_FEATURES,
              num_fields: int = 1024) -> "FMFeature":
        parts = s.split(":")
        if len(parts) == 2:
            idx_s, val_s = parts
            field = -1
        elif len(parts) == 3:
            field_s, idx_s, val_s = parts
            try:
                field = int(field_s)
            except ValueError:
                field = mhash(field_s, num_fields)
        else:
            raise ValueError(f"invalid FM feature {s!r}")
        try:
            idx = int(idx_s)
            if idx < 0:
                raise ValueError(f"index must be non-negative: {s!r}")
        except ValueError:
            if not as_int:
                raise
            idx = mhash(idx_s, num_features)
        return FMFeature(idx, float(val_s), field)
