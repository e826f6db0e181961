"""Binary-relevance ranking measures (ref: evaluation/BinaryResponsesMeasures.java)."""

from __future__ import annotations

from typing import Optional, Sequence


def precision_at(ranked: Sequence, truth: Sequence, k: Optional[int] = None) -> float:
    items = list(ranked)[: k if k is not None else len(ranked)]
    if not items:
        return 0.0
    ts = set(truth)
    return sum(1 for it in items if it in ts) / len(items)


def recall_at(ranked: Sequence, truth: Sequence, k: Optional[int] = None) -> float:
    ts = set(truth)
    if not ts:
        return 0.0
    items = list(ranked)[: k if k is not None else len(ranked)]
    return sum(1 for it in items if it in ts) / len(ts)


def hitrate(ranked: Sequence, truth: Sequence, k: Optional[int] = None) -> float:
    ts = set(truth)
    items = list(ranked)[: k if k is not None else len(ranked)]
    return 1.0 if any(it in ts for it in items) else 0.0


def mrr(ranked: Sequence, truth: Sequence, k: Optional[int] = None) -> float:
    ts = set(truth)
    items = list(ranked)[: k if k is not None else len(ranked)]
    for i, it in enumerate(items):
        if it in ts:
            return 1.0 / (i + 1)
    return 0.0


def average_precision(ranked: Sequence, truth: Sequence,
                      k: Optional[int] = None) -> float:
    ts = set(truth)
    if not ts:
        return 0.0
    items = list(ranked)[: k if k is not None else len(ranked)]
    hits = 0
    s = 0.0
    for i, it in enumerate(items):
        if it in ts:
            hits += 1
            s += hits / (i + 1)
    denom = min(len(ts), len(items)) if items else 1
    return s / denom if denom else 0.0
