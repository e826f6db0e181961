"""Training a covariance learner (AROW, SCW) the plain way, from the same
padded rows the port is handed as arrays: pad lanes carry the id ``dims``
and the value 0, and labels are 0 / 1 (a label > 0 is the class +1).

`exact_fit` is the reference's per-row semantics. For each row, in order:
gather its features' w and cov, form score = sum(w_k x_k) and
var = sum(cov_k x_k^2), take the rule's (alpha, beta), and where the row
fires add y * alpha * cov_k * x_k to w and -beta * (cov_k * x_k)^2 to cov
for every lane, lanes of one feature summing. A row's lanes are first
folded to its distinct features (the sums of their values and of their
squares), which is the same arithmetic. numpy, row by row, on the host.

`precision="float64"` is the reference. `precision="bfloat16"` keeps the
tables in bfloat16 (rounded to nearest even at every write): the control,
one step below the float32 that the configurations state.
`precision="float32"` keeps the tables, the lanes and each row's score,
variance and coefficients in float32: a witness at the program's own
precision that shares no code with it, for telling rounding at a rule's
threshold from a fault.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import ScalarOps

PRECISIONS = ("float64", "float32", "bfloat16")


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), kept in a
    float32 array."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                           & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return rounded.astype(np.uint32).view(np.float32)


def signs(labels: np.ndarray) -> np.ndarray:
    return np.where(np.asarray(labels) > 0, 1.0, -1.0)


def distinct_lanes(padded_ids: np.ndarray, padded_values: np.ndarray,
                   dims: int) -> Tuple[List[np.ndarray], List[np.ndarray],
                                       List[np.ndarray]]:
    """Per row: its distinct live ids (int64), the sum of their lanes'
    values and the sum of their squares (float64)."""
    n, k = padded_ids.shape
    order = np.argsort(padded_ids, axis=1, kind="stable")
    ids = np.take_along_axis(padded_ids, order, 1).ravel()
    vals = np.take_along_axis(padded_values, order, 1).astype(
        np.float64).ravel()
    starts = np.ones(n * k, bool)
    starts[1:] = ids[1:] != ids[:-1]
    starts[::k] = True
    pos = np.flatnonzero(starts)
    gid = ids[pos]
    row = pos // k
    s1 = np.add.reduceat(vals, pos)
    s2 = np.add.reduceat(vals * vals, pos)
    keep = (gid >= 0) & (gid < dims)
    gid, row, s1, s2 = gid[keep], row[keep], s1[keep], s2[keep]
    cuts = np.searchsorted(row, np.arange(1, n))
    return np.split(gid, cuts), np.split(s1, cuts), np.split(s2, cuts)


def exact_fit(padded_ids: np.ndarray, padded_values: np.ndarray,
              labels: np.ndarray, dims: int, epochs: int, rule, hyper: dict,
              precision: str = "float64",
              fired: Optional[list] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(w, cov) after `epochs` passes over the rows, row by row. Where
    `fired` is a list, each pass appends to it a bool array of the rows
    that fired in it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    ids, sums, squares = distinct_lanes(padded_ids, padded_values, dims)
    ys = signs(labels).tolist()
    f32 = np.float32
    if precision == "float64":
        w, cov = np.zeros(dims), np.ones(dims)

        def store(x):
            return x

        def scalar(x):
            return float(x)
    elif precision == "bfloat16":
        w, cov = np.zeros(dims, f32), np.ones(dims, f32)
        store = to_bf16

        def scalar(x):
            return float(x)
    else:
        w, cov = np.zeros(dims, f32), np.ones(dims, f32)
        sums = [a.astype(f32) for a in sums]
        squares = [q.astype(f32) for q in squares]

        def store(x):
            return x

        def scalar(x):
            return float(f32(x))
    coefficients = rule.coefficients
    for _ in range(epochs):
        flags = np.zeros(len(ys), bool) if fired is not None else None
        for i, (u, a, q, y) in enumerate(zip(ids, sums, squares, ys)):
            wu = w[u]
            cu = cov[u]
            alpha, beta, hit = coefficients(scalar(wu.dot(a)),
                                            scalar(cu.dot(q)), y, hyper,
                                            ScalarOps)
            if hit:
                w[u] = store(wu + scalar(y * alpha) * (cu * a))
                cov[u] = store(cu - scalar(beta) * (cu * cu * q))
                if flags is not None:
                    flags[i] = True
        if flags is not None:
            fired.append(flags)
    return w.astype(np.float64), cov.astype(np.float64)
