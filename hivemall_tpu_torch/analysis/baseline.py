"""Checked-in baseline: accepted pre-existing findings.

The baseline is a multiset of finding keys ``(rule, path, snippet)`` — line
numbers are carried for display but NOT matched, so edits elsewhere in a
file don't churn the baseline while any edit to a flagged line resurfaces
it. CI semantics:

- a current finding whose key is not covered by the baseline is NEW ->
  exit 1 (fix it or, for accepted debt outside the hot paths, refresh with
  ``--update-baseline`` in the same review);
- a baseline entry with no current finding is STALE -> reported as a note;
  the tier-1 test (tests/test_torch_analysis.py) asserts exact equality in
  both directions so the baseline can never drift silently.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[Finding]:
    path = path or DEFAULT_BASELINE
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return [Finding.from_dict(d) for d in data.get("findings", [])]


def write_baseline(findings: Sequence[Finding],
                   path: Optional[str] = None) -> str:
    path = path or DEFAULT_BASELINE
    payload = {
        "version": 1,
        "note": "accepted pre-existing graftcheck findings; refresh with "
                "`python -m hivemall_tpu_torch.analysis --update-baseline`",
        "findings": [f.to_dict() for f in findings],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=False)
        fh.write("\n")
    return path


def diff_against_baseline(current: Sequence[Finding],
                          baseline: Sequence[Finding],
                          scanned_paths: Optional[Sequence[str]] = None,
                          ) -> Tuple[List[Finding], List[Finding]]:
    """(new, stale). When `scanned_paths` is given (changed-files mode),
    baseline entries for files outside the scanned set are ignored — a
    partial scan can never report stale entries for files it didn't read."""
    if scanned_paths is not None:
        scanned = set(scanned_paths)
        baseline = [b for b in baseline if b.path in scanned]
    base_counts: Dict[tuple, int] = Counter(b.key for b in baseline)
    new: List[Finding] = []
    for f in current:
        if base_counts.get(f.key, 0) > 0:
            base_counts[f.key] -= 1
        else:
            new.append(f)
    cur_counts = Counter(f.key for f in current)
    stale: List[Finding] = []
    for b in baseline:
        if cur_counts.get(b.key, 0) > 0:
            cur_counts[b.key] -= 1
        else:
            stale.append(b)
    return new, stale
