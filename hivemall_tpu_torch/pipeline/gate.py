"""The evaluation gate: refuse to publish a model that regresses.

The gate is the pipeline's only quality authority: a frozen candidate
artifact is scored on the rolling holdout next to the CURRENTLY-SERVED
version, and publication happens only when the candidate's holdout logloss
does not regress past ``regression_tol_logloss``. Decisions are explicit
records (`GateDecision`) — the bench publishes them and /models carries
them as version lineage.

Semantics (tests/test_torch_pipeline.py pins each):

- **no incumbent** — first publish: a finite candidate metric suffices
  (there is nothing to regress against; serving something beats serving
  nothing);
- **insufficient holdout** — with an incumbent serving, a candidate that
  cannot be measured (< ``min_holdout_rows`` held-out rows) is refused:
  never swap blind;
- **regression** — candidate logloss > incumbent logloss + tolerance:
  refused, the old version keeps serving;
- scoring happens through the SERVING path (the port's ServingEngine
  over the verified artifact, on the pipeline's device), so what the gate
  measures is what production would run — manifest dtype pins, quantized
  tables and all.

The port of `hivemall_tpu/pipeline/gate.py`: the decision logic is host
Python over numpy scores, the scores come from the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..evaluation.metrics import auc, logloss
from ..tools.math import sigmoid


def score_metrics(engine, idx_rows, val_rows, labels) -> dict:
    """Holdout logloss/AUC of one engine. Margins are std-calibrated
    before the sigmoid: linear margin scores are uncalibrated, and
    without the normalization a confidently-wrong tail row saturates the
    1e-15 clip and dominates the mean — the gate would compare score
    SCALES, not ranking quality.
    Labels in {-1,+1} or {0,1} (evaluation.metrics treats >0 as
    positive)."""
    margins = np.asarray(engine.predict((idx_rows, val_rows)), np.float32)
    z = margins / max(float(np.std(margins)), 1e-9)
    return {"logloss": logloss(sigmoid(z), labels),
            "auc": auc(margins, labels)}


@dataclass
class GateDecision:
    """One gate verdict, the unit of lineage."""

    version: str
    published: bool
    reason: str  # first_publish | improved_or_equal | regression |
    #              insufficient_holdout | artifact_corrupt | rollback
    holdout_rows: int = 0
    candidate_logloss: Optional[float] = None
    candidate_auc: Optional[float] = None
    incumbent_logloss: Optional[float] = None
    incumbent_version: Optional[str] = None
    trained_through_event: Optional[int] = None
    extra: dict = field(default_factory=dict)

    def as_record(self) -> dict:
        r = {k: v for k, v in self.__dict__.items()
             if k != "extra" and v is not None}
        r.update(self.extra)
        return r


class EvalGate:
    """Stateless decision function over (candidate, incumbent, holdout)."""

    def __init__(self, regression_tol_logloss: float = 0.005,
                 min_holdout_rows: int = 64) -> None:
        self.regression_tol_logloss = float(regression_tol_logloss)
        self.min_holdout_rows = int(min_holdout_rows)

    def evaluate(self, version: str, candidate_engine, incumbent_engine,
                 holdout_snapshot,
                 incumbent_version: Optional[str] = None,
                 incumbent_metrics: Optional[dict] = None) -> GateDecision:
        """Score both sides on the SAME holdout and decide.

        ``holdout_snapshot`` is RollingHoldout.snapshot() output (or
        None); ``incumbent_engine`` None means no version is serving.
        ``incumbent_metrics`` (a score_metrics() result) skips rescoring
        the incumbent when the caller already scored it on this exact
        snapshot — the pipeline's health check runs first in the same
        cycle and hands its numbers over."""
        n = 0 if holdout_snapshot is None else len(holdout_snapshot[2])
        if incumbent_engine is None:
            d = GateDecision(version, True, "first_publish", holdout_rows=n)
            if n:
                idx_rows, val_rows, labels = holdout_snapshot
                m = score_metrics(candidate_engine, idx_rows, val_rows,
                                  labels)
                d.candidate_logloss, d.candidate_auc = (m["logloss"],
                                                        m["auc"])
                if not math.isfinite(d.candidate_logloss):
                    d.published = False
                    d.reason = "candidate_metric_not_finite"
            return d
        if n < self.min_holdout_rows:
            return GateDecision(
                version, False, "insufficient_holdout", holdout_rows=n,
                incumbent_version=incumbent_version,
                extra={"min_holdout_rows": self.min_holdout_rows})
        idx_rows, val_rows, labels = holdout_snapshot
        cand = score_metrics(candidate_engine, idx_rows, val_rows, labels)
        inc = incumbent_metrics if incumbent_metrics is not None \
            else score_metrics(incumbent_engine, idx_rows, val_rows, labels)
        regressed = (not math.isfinite(cand["logloss"])
                     or cand["logloss"] > inc["logloss"]
                     + self.regression_tol_logloss)
        return GateDecision(
            version, not regressed,
            "regression" if regressed else "improved_or_equal",
            holdout_rows=n,
            candidate_logloss=cand["logloss"], candidate_auc=cand["auc"],
            incumbent_logloss=inc["logloss"],
            incumbent_version=incumbent_version)
