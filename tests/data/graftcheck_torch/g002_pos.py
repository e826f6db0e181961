"""Known-positive G002 host-sync cases.  # graftcheck: hot-module"""
import torch
import torch.nn.functional as F
import numpy as np


def make_train_step(rule):
    return torch.compile(rule)


def per_block_float(state, blocks, rule):
    stepper = make_train_step(rule)
    total = 0.0
    for blk in blocks:
        state, loss = stepper(state, blk)
        total += float(loss)  # EXPECT: G002
    return state, total


def per_block_asarray(state, blocks, rule):
    stepper = make_train_step(rule)
    history = []
    for blk in blocks:
        state, loss = stepper(state, blk)
        history.append(np.asarray(loss))  # EXPECT: G002
    return state, history


def per_element_device_get(outs):
    rows = []
    scores = torch.cumsum(outs, 0)
    for i in range(4):
        rows.append(scores[i].cpu())  # EXPECT: G002
    return rows


def item_in_loop(blocks):
    done = []
    for blk in blocks:
        flag = torch.max(blk)
        done.append(flag.item())  # EXPECT: G002
    return done


class Trainer:
    def step(self, state, labels):
        n = int(labels)  # EXPECT: G002
        return self._step(state, labels, n)
