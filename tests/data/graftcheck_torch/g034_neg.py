"""G034 negative fixture: bucket-routed or static shapes at jit call sites."""
# graftcheck: jit-hot-module
import torch
import torch.nn.functional as F

from hivemall_tpu_torch.core.batch import bucket_rows


def _score(v):
    return torch.sum(v * 2.0, dim=-1)


scorer = torch.compile(_score)


def predict(batch, n):
    live = bucket_rows(batch[:n])
    return scorer(live)[:n]


def predict_inline(batch, n):
    return scorer(bucket_rows(batch[:n]))[:n]


def predict_fixed(batch):
    head = batch[:128]
    return scorer(head)


def predict_whole(batch):
    return scorer(batch)
