"""Misc UDFs/UDTFs (ref: hivemall/tools/*.java)."""

from __future__ import annotations

import heapq
from typing import Any, Iterable, Iterator, List, Sequence, Tuple


def generate_series(start: int, end: int) -> List[int]:
    """Inclusive integer series (ref: tools/GenerateSeriesUDTF.java)."""
    return list(range(int(start), int(end) + 1))


def convert_label(label: float) -> float:
    """-1/1 <-> 0/1 label flip (ref: tools/ConvertLabelUDF.java):
    -1 -> 0, 0 -> -1, else pass-through."""
    f = float(label)
    if f == -1.0:
        return 0.0
    if f == 0.0:
        return -1.0
    return f


def x_rank(keys: Iterable) -> Iterator[Tuple[Any, int]]:
    """Per-key rank counter like ROW_NUMBER over sorted input
    (ref: tools/RankSequenceUDF.java / x_rank in define-all.hive)."""
    last = object()
    rank = 0
    for k in keys:
        if k != last:
            rank = 1
            last = k
        else:
            rank += 1
        yield k, rank


def each_top_k(k: int, rows: Iterable[Tuple[Any, float, Sequence]],
               ) -> Iterator[Tuple[int, float, Sequence]]:
    """`each_top_k(k, group, value, args...)` — per-group top-k rows by value
    with their rank (ref: tools/EachTopKUDTF.java:48-140, BoundedPriorityQueue).
    Input rows are (group, value, payload); groups must arrive contiguously
    (the reference has the same requirement). Negative k emits bottom-k."""
    import itertools

    bottom = k < 0
    kk = abs(int(k))
    if kk == 0:
        return

    counter = itertools.count()  # tie-break to keep heap comparisons total

    def flush(heap):
        ordered = sorted(heap, key=lambda t: t[0], reverse=not bottom)
        for rank, (key, _, value, payload) in enumerate(ordered, 1):
            yield rank, value, payload

    cur_group = object()
    heap: List[Tuple] = []
    for group, value, payload in rows:
        if group != cur_group:
            yield from flush(heap)
            heap = []
            cur_group = group
        key = value if not bottom else -value
        item = (key, next(counter), value, payload)
        if len(heap) < kk:
            heapq.heappush(heap, item)
        else:
            heapq.heappushpop(heap, item)
    yield from flush(heap)
