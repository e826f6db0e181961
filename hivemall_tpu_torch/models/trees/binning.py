"""Feature binning for histogram-based tree growth — the port's numpy copy
of `hivemall_tpu/models/trees/binning.py` (the port imports nothing of the
JAX package). Binning stays on the host: `make_bins` is `np.quantile`, and
`bin_data` returns int32 bin ids, which the growers copy to the device as
they are.

The reference does exact split search over per-column pre-sorted values
(ref: smile/classification/DecisionTree.java:407+, column order[][] built in
RandomForestClassifierUDTF.java:288-302). Exact sorted-column CART is hostile
to TPU (data-dependent loops, dynamic shapes); the TPU-first equivalent is
XGBoost/LightGBM-style quantile binning: each numeric column is discretized
into <=255 bins once up front, then every split decision is a histogram sum —
one big scatter-add per tree level (SURVEY.md §7 step 7 / hard part (d)).

Nominal attributes keep their category ids as bin ids and split by equality,
matching the reference's NOMINAL attribute handling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

MAX_BINS = 64


@dataclass
class BinInfo:
    """Per-feature binning: `edges[b]` is the upper edge (inclusive) of bin b
    in original units; nominal features have edges = category values."""

    nominal: bool
    edges: np.ndarray  # [n_bins] float64
    n_bins: int


def make_bins(X: np.ndarray, attrs: Sequence[str],
              max_bins: int = MAX_BINS) -> List[BinInfo]:
    """attrs[i] in {'Q' (quantitative), 'C' (categorical/nominal)}
    (the reference's -attrs Q,C,... option, RandomForestClassifierUDTF.java:113)."""
    out: List[BinInfo] = []
    for f in range(X.shape[1]):
        col = X[:, f]
        if attrs[f] == "C":
            cats = np.unique(col)
            out.append(BinInfo(True, cats.astype(np.float64), len(cats)))
        else:
            qs = np.quantile(col, np.linspace(0, 1, max_bins + 1)[1:])
            edges = np.unique(qs)
            out.append(BinInfo(False, edges.astype(np.float64), len(edges)))
    return out


def bin_data(X: np.ndarray, bins: List[BinInfo]) -> np.ndarray:
    """[N, F] float -> [N, F] int32 bin ids."""
    n, F = X.shape
    out = np.empty((n, F), dtype=np.int32)
    for f in range(F):
        b = bins[f]
        if b.nominal:
            out[:, f] = np.searchsorted(b.edges, X[:, f])
            out[:, f] = np.clip(out[:, f], 0, b.n_bins - 1)
        else:
            out[:, f] = np.searchsorted(b.edges, X[:, f], side="left")
            out[:, f] = np.clip(out[:, f], 0, b.n_bins - 1)
    return out


def threshold_of(bins: List[BinInfo], f: int, bin_id: int) -> float:
    """Real-unit split value for `x <= threshold` (numeric) or `x == value`
    (nominal) recovered from a bin id — so exported trees evaluate on raw
    features exactly like the reference's."""
    b = bins[f]
    return float(b.edges[min(bin_id, b.n_bins - 1)])
