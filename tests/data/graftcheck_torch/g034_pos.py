"""G034 positive fixture: unbucketed dynamic shapes reaching jitted callees."""
# graftcheck: jit-hot-module
import torch
import torch.nn.functional as F


def _score(v):
    return torch.sum(v * 2.0, dim=-1)


scorer = torch.compile(_score)


def predict(batch, n):
    live = batch[:n]
    return scorer(live)  # EXPECT: G034


def predict_inline(batch, n):
    return scorer(batch[:n])  # EXPECT: G034
