"""Evaluation metrics and binary-response ranking measures (numpy copies
of `hivemall_tpu/evaluation/`)."""

from .metrics import (  # noqa: F401
    AUC,
    F1Score,
    LogLossAggregator,
    MAE,
    MSE,
    NDCG,
    R2,
    RMSE,
    auc,
    f1score,
    logloss,
    mae,
    mse,
    ndcg,
    r2,
    rmse,
)
from .binary_responses import (  # noqa: F401
    average_precision,
    hitrate,
    mrr,
    precision_at,
    recall_at,
)
