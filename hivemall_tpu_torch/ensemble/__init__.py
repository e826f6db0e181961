"""Ensemble/merge UDAFs (ref: hivemall/ensemble/*.java, SURVEY.md §2.12) —
the offline model-merge counterparts of the MIX reductions."""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def voted_avg(values: Iterable[float]) -> float:
    """Average of the majority-sign values (ref: ensemble/bagging/VotedAvgUDAF.java:26):
    if positives outnumber negatives, average the positives; else the negatives."""
    pos = [v for v in values if v > 0]
    neg = [v for v in values if v <= 0]
    if len(pos) > len(neg):
        return float(np.mean(pos)) if pos else 0.0
    return float(np.mean(neg)) if neg else 0.0


def weight_voted_avg(values: Iterable[float]) -> float:
    """Weighted variant: side with larger absolute weight sum wins
    (ref: ensemble/bagging/WeightVotedAvgUDAF.java:29)."""
    pos = [v for v in values if v > 0]
    neg = [v for v in values if v <= 0]
    if sum(pos) > -sum(neg):
        return float(np.mean(pos)) if pos else 0.0
    return float(np.mean(neg)) if neg else 0.0


def max_label(score_label_pairs: Iterable[Tuple[float, object]]):
    """Label with the maximum score (ref: ensemble/MaxValueLabelUDAF.java:28)."""
    best = None
    for score, label in score_label_pairs:
        if best is None or score > best[0]:
            best = (score, label)
    return best[1] if best is not None else None


def maxrow(rows: Iterable[Sequence], compare_index: int = 0) -> Optional[Sequence]:
    """The whole row holding the max compare column (ref: ensemble/MaxRowUDAF.java:59)."""
    best = None
    for row in rows:
        if best is None or row[compare_index] > best[compare_index]:
            best = row
    return best


def argmin_kld(mean_covar_pairs: Iterable[Tuple[float, float]]) -> float:
    """Precision-weighted mean (1/sum(1/covar)) * sum(mean/covar)
    (ref: ensemble/ArgminKLDistanceUDAF.java:28-90) — the offline counterpart
    of the MIX argminKLD operator (parallel/mix.py)."""
    sum_mean_div_covar = 0.0
    sum_inv_covar = 0.0
    n = 0
    for mean, covar in mean_covar_pairs:
        if mean is None or covar is None:
            continue
        sum_mean_div_covar += mean / covar
        sum_inv_covar += 1.0 / covar
        n += 1
    if n == 0:
        return 0.0
    return float(sum_mean_div_covar / sum_inv_covar)


def rf_ensemble(votes: Iterable[int]) -> Tuple[int, float, List[float]]:
    """Random-forest majority vote -> (label, probability, posterior probs)
    (ref: smile/tools/RandomForestEnsembleUDAF.java:34)."""
    counts = Counter(int(v) for v in votes)
    if not counts:
        return -1, 0.0, []
    total = sum(counts.values())
    k = max(counts) + 1
    posteriori = [counts.get(i, 0) / total for i in range(k)]
    label, cnt = counts.most_common(1)[0]
    return label, cnt / total, posteriori
