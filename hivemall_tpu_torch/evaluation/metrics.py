"""Evaluation UDAFs (ref: hivemall/evaluation/*.java, SURVEY.md §2.11) — a
numpy copy of `hivemall_tpu/evaluation/metrics.py` (the port imports
nothing of the JAX package).

Each metric exists in two forms:
- a streaming aggregator class with iterate/merge/terminate — the UDAF
  lifecycle (PARTIAL1/PARTIAL2/FINAL) that makes the metric map/combine/
  reduce-safe exactly like the reference (e.g. NDCGUDAF.java:113-196);
- a one-shot vectorized function over arrays (the convenient API).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


class _PartialSum:
    def __init__(self) -> None:
        self.sum = 0.0
        self.count = 0

    def iterate(self, v: float) -> None:
        self.sum += float(v)
        self.count += 1

    def merge(self, other: "_PartialSum") -> None:
        self.sum += other.sum
        self.count += other.count


class MAE(_PartialSum):
    """mean absolute error (ref: evaluation/MeanAbsoluteErrorUDAF.java)."""

    def iterate(self, predicted: float, actual: float) -> None:  # type: ignore[override]
        super().iterate(abs(float(predicted) - float(actual)))

    def terminate(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MSE(_PartialSum):
    """mean squared error (ref: evaluation/MeanSquaredErrorUDAF.java)."""

    def iterate(self, predicted: float, actual: float) -> None:  # type: ignore[override]
        d = float(predicted) - float(actual)
        super().iterate(d * d)

    def terminate(self) -> float:
        return self.sum / self.count if self.count else 0.0


class RMSE(MSE):
    """root mean squared error (ref: evaluation/RootMeanSquaredErrorUDAF.java)."""

    def terminate(self) -> float:
        return math.sqrt(super().terminate())


class LogLossAggregator(_PartialSum):
    """logloss(predicted, actual) UDAF (ref: evaluation/LogarithmicLossUDAF.java:28-100):
    actual in {0,1} (or {-1,1}), predicted a probability."""

    EPS = 1e-15

    def iterate(self, predicted: float, actual: float) -> None:  # type: ignore[override]
        p = min(max(float(predicted), self.EPS), 1.0 - self.EPS)
        y = 1.0 if float(actual) > 0 else 0.0
        super().iterate(-(y * math.log(p) + (1.0 - y) * math.log(1.0 - p)))

    def terminate(self) -> float:
        return self.sum / self.count if self.count else 0.0


class R2:
    """R^2 coefficient of determination (ref: evaluation/R2UDAF.java:33)."""

    def __init__(self) -> None:
        self.n = 0
        self.sum_sq_err = 0.0
        self.sum_actual = 0.0
        self.sum_sq_actual = 0.0

    def iterate(self, predicted: float, actual: float) -> None:
        a, p = float(actual), float(predicted)
        self.n += 1
        self.sum_sq_err += (a - p) ** 2
        self.sum_actual += a
        self.sum_sq_actual += a * a

    def merge(self, o: "R2") -> None:
        self.n += o.n
        self.sum_sq_err += o.sum_sq_err
        self.sum_actual += o.sum_actual
        self.sum_sq_actual += o.sum_sq_actual

    def terminate(self) -> float:
        if self.n == 0:
            return 0.0
        mean = self.sum_actual / self.n
        ss_tot = self.sum_sq_actual - self.n * mean * mean
        if ss_tot == 0.0:
            return 1.0 if self.sum_sq_err == 0.0 else 0.0
        return 1.0 - self.sum_sq_err / ss_tot


class F1Score:
    """f1score(actual_list, predicted_list) micro-F1 over multi-label rows
    (ref: evaluation/FMeasureUDAF.java:33)."""

    def __init__(self) -> None:
        self.tp = 0
        self.total_actual = 0
        self.total_predicted = 0

    def iterate(self, actual: Sequence, predicted: Sequence) -> None:
        sa, sp = set(actual), set(predicted)
        self.tp += len(sa & sp)
        self.total_actual += len(sa)
        self.total_predicted += len(sp)

    def merge(self, o: "F1Score") -> None:
        self.tp += o.tp
        self.total_actual += o.total_actual
        self.total_predicted += o.total_predicted

    def terminate(self) -> float:
        prec = self.tp / self.total_predicted if self.total_predicted else 0.0
        rec = self.tp / self.total_actual if self.total_actual else 0.0
        if prec + rec == 0.0:
            return 0.0
        return 2.0 * prec * rec / (prec + rec)


class NDCG:
    """ndcg(rank_items, true_items[, k]) UDAF with full partial lifecycle
    (ref: evaluation/NDCGUDAF.java:51-196)."""

    def __init__(self, k: Optional[int] = None) -> None:
        self.k = k
        self.sum = 0.0
        self.count = 0

    def iterate(self, ranked: Sequence, truth: Sequence) -> None:
        self.sum += ndcg(ranked, truth, self.k)
        self.count += 1

    def merge(self, o: "NDCG") -> None:
        self.sum += o.sum
        self.count += o.count

    def terminate(self) -> float:
        return self.sum / self.count if self.count else 0.0


class AUC:
    """Streaming ROC AUC over (score, label) pairs."""

    def __init__(self) -> None:
        self.scores: list = []
        self.labels: list = []

    def iterate(self, score: float, label: float) -> None:
        self.scores.append(float(score))
        self.labels.append(1.0 if float(label) > 0 else 0.0)

    def merge(self, o: "AUC") -> None:
        self.scores.extend(o.scores)
        self.labels.extend(o.labels)

    def terminate(self) -> float:
        return auc(np.asarray(self.scores), np.asarray(self.labels))


# ---------------- one-shot vectorized forms ----------------

def mae(predicted, actual) -> float:
    p, a = np.asarray(predicted, float), np.asarray(actual, float)
    return float(np.mean(np.abs(p - a)))


def mse(predicted, actual) -> float:
    p, a = np.asarray(predicted, float), np.asarray(actual, float)
    return float(np.mean((p - a) ** 2))


def rmse(predicted, actual) -> float:
    return float(math.sqrt(mse(predicted, actual)))


def r2(predicted, actual) -> float:
    agg = R2()
    for p, a in zip(np.asarray(predicted, float), np.asarray(actual, float)):
        agg.iterate(p, a)
    return agg.terminate()


def logloss(predicted, actual) -> float:
    p = np.clip(np.asarray(predicted, float), 1e-15, 1 - 1e-15)
    y = (np.asarray(actual, float) > 0).astype(float)
    return float(np.mean(-(y * np.log(p) + (1 - y) * np.log(1 - p))))


def f1score(actual_rows, predicted_rows) -> float:
    agg = F1Score()
    for a, p in zip(actual_rows, predicted_rows):
        agg.iterate(a, p)
    return agg.terminate()


def ndcg(ranked: Sequence, truth: Sequence, k: Optional[int] = None) -> float:
    """Binary-relevance NDCG@k (ref: evaluation/BinaryResponsesMeasures.java nDCG)."""
    truth_set = set(truth)
    if not truth_set:
        return 0.0
    items = list(ranked)[: k if k is not None else len(ranked)]
    dcg = sum(1.0 / math.log2(i + 2) for i, it in enumerate(items) if it in truth_set)
    ideal_n = min(len(truth_set), len(items)) if items else 0
    idcg = sum(1.0 / math.log2(i + 2) for i in range(ideal_n))
    return dcg / idcg if idcg > 0 else 0.0


def auc(scores, labels) -> float:
    """ROC AUC via rank statistic (ties averaged)."""
    s = np.asarray(scores, float)
    y = (np.asarray(labels, float) > 0).astype(float)
    n_pos = float(y.sum())
    n_neg = float(len(y) - y.sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), float)
    sorted_s = s[order]
    i = 0
    r = 1.0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i : j + 1]] = avg
        r += j - i + 1
        i = j + 1
    sum_pos_ranks = float(np.sum(ranks[y == 1]))
    return (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
