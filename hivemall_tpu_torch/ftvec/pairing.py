"""Pairing UDFs (ref: ftvec/pairing/{PolynomialFeaturesUDF,PoweredFeaturesUDF}.java)."""

from __future__ import annotations

from typing import List, Sequence

from ..utils.feature import parse_feature


def polynomial_features(ftvec: Sequence[str], degree: int,
                        interaction_only: bool = False,
                        truncate: bool = True) -> List[str]:
    """Degree-d polynomial feature expansion over "name:value" strings
    (ref: PolynomialFeaturesUDF.java:44-130). With truncate, features valued
    0/1 are not self-powered; interaction_only skips self-products."""
    if ftvec is None:
        return None
    if degree < 2:
        raise ValueError(f"degree must be >= 2: {degree}")
    parsed = [parse_feature(fv) for fv in ftvec]
    dst: List[str] = []

    def add_poly(feat: str, value: float, cur_degree: int, start: int):
        if cur_degree > degree:
            return
        for j in range(start, len(parsed)):
            name_j, v_j = parsed[j]
            if interaction_only and feat.endswith(str(name_j)):
                pass  # self-product guard handled via start index below
            new_feat = f"{feat}^{name_j}"
            new_val = value * v_j
            dst.append(f"{new_feat}:{new_val}")
            next_start = j + 1 if interaction_only else j
            add_poly(new_feat, new_val, cur_degree + 1, next_start)

    for i, fv in enumerate(ftvec):
        dst.append(fv)  # x^1
        name, v = parsed[i]
        if truncate and (v == 0.0 or v == 1.0):
            # powers of 0/1 are redundant; still pair with *other* features
            start = i + 1
        else:
            start = i + 1 if interaction_only else i
        feat = str(name)
        for j in range(start, len(parsed)):
            name_j, v_j = parsed[j]
            if truncate and i == j and (v == 0.0 or v == 1.0):
                continue
            new_feat = f"{feat}^{name_j}"
            new_val = v * v_j
            dst.append(f"{new_feat}:{new_val}")
            add_poly(new_feat, new_val, 3, j + 1 if interaction_only else j)
    return dst


def powered_features(ftvec: Sequence[str], degree: int,
                     truncate: bool = True) -> List[str]:
    """x, x^2, ..., x^degree per feature (ref: PoweredFeaturesUDF.java)."""
    if ftvec is None:
        return None
    if degree < 2:
        raise ValueError(f"degree must be >= 2: {degree}")
    dst: List[str] = []
    for fv in ftvec:
        name, v = parse_feature(fv)
        dst.append(fv)
        if truncate and (v == 0.0 or v == 1.0):
            continue
        p = v
        for d in range(2, degree + 1):
            p *= v
            dst.append(f"{name}^{d}:{p}")
    return dst
