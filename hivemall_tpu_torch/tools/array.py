"""Array UDFs (ref: hivemall/tools/array/*.java)."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence


def float_array(nDims: int, value: float = 0.0) -> List[float]:
    """`float_array(nDims)` constant vector (ref: tools/array/AllocFloatArrayUDF.java)."""
    return [float(value)] * int(nDims)


def array_remove(arr: Sequence, target) -> List:
    """Remove all occurrences (ref: tools/array/ArrayRemoveUDF.java)."""
    if arr is None:
        return None
    return [x for x in arr if x != target]


def sort_and_uniq_array(arr: Sequence) -> List:
    """(ref: tools/array/SortAndUniqArrayUDF.java)."""
    if arr is None:
        return None
    return sorted(set(arr))


def subarray_startwith(arr: Sequence, key) -> Optional[List]:
    """Subarray from the first element == key (inclusive)
    (ref: tools/array/SubarrayStartWithUDF.java)."""
    if arr is None:
        return None
    try:
        i = list(arr).index(key)
    except ValueError:
        return None
    return list(arr)[i:]


def subarray_endwith(arr: Sequence, key) -> Optional[List]:
    """Subarray up to the first element == key (inclusive)
    (ref: tools/array/SubarrayEndWithUDF.java)."""
    if arr is None:
        return None
    try:
        i = list(arr).index(key)
    except ValueError:
        return None
    return list(arr)[: i + 1]


def subarray(arr: Sequence, from_idx: int, to_idx: int) -> Optional[List]:
    """arr[from:to] (to exclusive, clamped) (ref: tools/array/SubarrayUDF.java)."""
    if arr is None:
        return None
    n = len(arr)
    return list(arr)[max(0, from_idx) : min(n, to_idx)]


def array_concat(*arrays: Sequence) -> List:
    """(ref: tools/array/ArrayConcatUDF.java)."""
    out: List = []
    for a in arrays:
        if a is not None:
            out.extend(a)
    return out


def array_avg(rows: Iterable[Sequence[float]]) -> List[float]:
    """Element-wise average over grouped arrays (ref: tools/array/ArrayAvgGenericUDAF.java)."""
    total: List[float] = []
    n = 0
    for row in rows:
        if row is None:
            continue
        if not total:
            total = [0.0] * len(row)
        for i, v in enumerate(row):
            total[i] += float(v)
        n += 1
    return [t / n for t in total] if n else []


def array_sum(rows: Iterable[Sequence[float]]) -> List[float]:
    """Element-wise sum over grouped arrays (ref: tools/array/ArraySumUDAF.java)."""
    total: List[float] = []
    for row in rows:
        if row is None:
            continue
        if not total:
            total = [0.0] * len(row)
        for i, v in enumerate(row):
            total[i] += float(v)
    return total


def to_string_array(arr: Sequence) -> List[str]:
    """(ref: tools/array/ToStringArrayUDF.java)."""
    if arr is None:
        return None
    return [None if x is None else str(x) for x in arr]


def array_intersect(*arrays: Sequence) -> List:
    """Intersection preserving first-array order (ref: tools/array/ArrayIntersectUDF.java)."""
    if not arrays or arrays[0] is None:
        return []
    out = []
    rest = [set(a) for a in arrays[1:] if a is not None]
    seen = set()
    for x in arrays[0]:
        if x in seen:
            continue
        if all(x in s for s in rest):
            out.append(x)
            seen.add(x)
    return out


def collect_all(values: Iterable) -> List:
    """Group-collect (ref: tools/array/CollectAllUDAF.java)."""
    return list(values)
