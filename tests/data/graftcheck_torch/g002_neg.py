"""Known-negative G002 cases: epoch-boundary batched reads.

# graftcheck: hot-module
"""
import torch
import numpy as np


def make_train_step(rule):
    return torch.compile(rule)


def epoch_boundary_read(state, blocks, rule):
    stepper = make_train_step(rule)
    losses = []
    for blk in blocks:
        state, loss = stepper(state, blk)
        losses.append(loss)  # stays on device; dispatch stays async
    return state, float(torch.stack(losses).sum().cpu())


def level_boundary_batched_get(state, blocks, rule):
    stepper = make_train_step(rule)
    for blk in blocks:
        state, stats = stepper(state, blk)
        # ONE whole-value .cpu() per level: the approved boundary idiom
        gain, counts = stats.cpu()
        if counts.sum() == 0:
            break
    return state


def host_data_is_free(rows):
    out = []
    for r in rows:
        out.append(np.asarray(r).sum())  # numpy input rows: no device sync
    return out


class Trainer:
    def step(self, state, indices, labels):
        # shape attribute read: no device->host copy
        pad = np.zeros(np.shape(labels), np.float32)
        return self._step(state, indices, labels, pad)
