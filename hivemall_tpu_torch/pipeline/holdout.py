"""Drift-aware rolling holdout for the continuous-training eval gate.

The gate needs labeled data the trainer has NEVER seen, drawn from the
stream's CURRENT concept. Both properties come from one mechanism: every
``every``-th observed batch is routed here instead of to the trainer
(a deterministic 1/``every`` holdout split of the live stream), and the
reservoir is a bounded ring in rows — old-concept batches age out as the
stream drifts, so the gate always scores candidates against roughly the
last ``capacity_rows`` worth of held-out traffic.

Thread-safety: the pipeline worker appends while benches/tests snapshot
concurrently; one lock guards the ring, and snapshot() copies references
out under it (the arrays themselves are never mutated after append).

A host copy of `hivemall_tpu/pipeline/holdout.py` (numpy only; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional, Tuple

import numpy as np


class RollingHoldout:
    """Bounded ring of held-out ``(indices, values, labels)`` batches."""

    def __init__(self, capacity_rows: int = 4096, every: int = 8) -> None:
        if every < 2:
            raise ValueError(f"every must be >= 2 (every={every} would "
                             "starve the trainer)")
        self.capacity_rows = int(capacity_rows)
        self.every = int(every)
        self._batches: deque = deque()
        self._rows = 0
        self._lock = threading.Lock()

    def routes_here(self, batch_index: int) -> bool:
        """True when observed batch ``batch_index`` is holdout, not
        training data. Offset 1 so batch 0 (and the first batch after a
        resume at a multiple of ``every``) trains — a cold start should
        learn before it evaluates."""
        return batch_index % self.every == 1

    def add(self, indices: np.ndarray, values: np.ndarray,
            labels: np.ndarray) -> None:
        with self._lock:
            self._batches.append((indices, values, labels))
            self._rows += len(labels)
            while self._rows > self.capacity_rows and len(self._batches) > 1:
                old = self._batches.popleft()
                self._rows -= len(old[2])

    @property
    def rows(self) -> int:
        with self._lock:
            return self._rows

    def snapshot(self) -> Optional[Tuple[List[np.ndarray], List[np.ndarray],
                                         np.ndarray]]:
        """Current reservoir as a pre-parsed request the serving engines
        score directly: ``(idx_rows, val_rows, labels)`` with labels in
        {-1,+1}. None while empty."""
        with self._lock:
            batches = list(self._batches)
        if not batches:
            return None
        idx_rows: List[np.ndarray] = []
        val_rows: List[np.ndarray] = []
        labels: List[np.ndarray] = []
        for idx, val, lab in batches:
            # per-row arrays, int64 indices — the pre-parsed request form
            # the serving engines accept verbatim
            idx_rows.extend(np.asarray(idx, np.int64))
            val_rows.extend(np.asarray(val, np.float32))
            labels.append(np.asarray(lab, np.float32))
        return idx_rows, val_rows, np.concatenate(labels)
