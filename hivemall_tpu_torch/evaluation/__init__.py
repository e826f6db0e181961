"""Evaluation metrics (a numpy copy of `hivemall_tpu/evaluation/metrics.py`)."""

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
