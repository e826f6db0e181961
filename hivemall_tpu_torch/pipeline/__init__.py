"""Continuous-training pipeline: stream -> freeze -> eval gate -> hot-swap —
the port of `hivemall_tpu/pipeline/`.

The subsystem that owns a control loop across both halves of the
codebase: an online trainer consumes a
drifting event stream, periodically freezes immutable artifacts
(serving/artifact), runs an evaluation gate on a rolling holdout
(evaluation/metrics: refuse to publish on regression), and atomically
hot-swaps passing versions into a live serving/server.ModelRegistry while
traffic flows — reporting end-to-end "event observed -> model serving it"
freshness as a first-class metric. It trains and serves on one device,
the card unless the caller passes ``device="cpu"``.
"""

from .gate import EvalGate, GateDecision, score_metrics
from .holdout import RollingHoldout
from .loop import (FAMILY, FRESHNESS_BUCKETS, ContinuousPipeline,
                   PipelineConfig, artifact_frozen)

__all__ = [
    "ContinuousPipeline", "PipelineConfig", "EvalGate", "GateDecision",
    "RollingHoldout", "score_metrics", "artifact_frozen", "FAMILY",
    "FRESHNESS_BUCKETS",
]
