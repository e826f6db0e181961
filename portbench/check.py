"""The comparison that decides `correct`: the tables a timed fit trained
against the plain reference's, recomputed from the same rows.

The numbers (`numbers`), over the whole 2^24-entry tables:

- `w_gap`: ||w - w_ref|| / ||w_ref||;
- `cov_gap`: ||cov - cov_ref|| / ||1 - cov_ref||, the covariance's change
  from its initial 1 against the reference's change;
- `w_median_gap`, `cov_median_gap`: the median of |w - w_ref| / |w_ref|
  (of |cov - cov_ref| / cov_ref) over the features the reference moved;
- `off_share`: the share of those features off by more than 1e-3 of their
  value in w or cov;
- `w_max_abs`, `cov_max_abs`, `moved`: the largest gaps, and how many
  features the reference moved;
- `examples`: |rows the program counted (`hivemall.<rule>.examples`) -
  rows the window trained|.

A non-finite entry in the program's table makes every gap `FAR`. A cell
holds the numbers its file's `limits` name to those limits (`examples` to 0)
and prints the rest beside them. Which numbers each cell holds, and the
readings each limit was set from, are in PERF.md: where a few rows at a
learner's threshold fire on one side of float32 rounding only and swing an
L2 gap from seed to seed, the steady median is held beside it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

FAR = 1e30  # a gap that no limit admits, and that JSON can carry


def _relative(diff: np.ndarray, scale: np.ndarray) -> float:
    den = float(np.linalg.norm(scale))
    num = float(np.linalg.norm(diff))
    return num / den if den > 0 else (0.0 if num == 0 else FAR)


def numbers(w: np.ndarray, cov: np.ndarray, ref_w: np.ndarray,
            ref_cov: np.ndarray) -> Dict[str, float]:
    names = ("w_gap", "cov_gap", "w_median_gap", "cov_median_gap",
             "off_share", "w_max_abs", "cov_max_abs")
    moved = (ref_w != 0) | (ref_cov != 1)
    if not (np.isfinite(w).all() and np.isfinite(cov).all()):
        return {**{n: FAR for n in names}, "moved": float(moved.sum())}
    rel_w = np.abs(w - ref_w)[moved] / np.maximum(np.abs(ref_w[moved]),
                                                  1e-30)
    rel_c = np.abs(cov - ref_cov)[moved] / np.abs(ref_cov[moved])
    median = (lambda x: float(np.median(x))) if moved.any() \
        else (lambda x: 0.0)
    return {"w_gap": _relative(w - ref_w, ref_w),
            "cov_gap": _relative(cov - ref_cov, 1.0 - ref_cov),
            "w_median_gap": median(rel_w),
            "cov_median_gap": median(rel_c),
            "off_share": float(((rel_w > 1e-3) | (rel_c > 1e-3)).mean())
            if moved.any() else 0.0,
            "w_max_abs": float(np.abs(w - ref_w).max()),
            "cov_max_abs": float(np.abs(cov - ref_cov).max()),
            "moved": float(moved.sum())}


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, number, limit)]) over the numbers that have a
    limit."""
    held = [(name, float(values[name]), float(limit))
            for name, limit in limits.items()]
    return all(value <= limit for _, value, limit in held), held
