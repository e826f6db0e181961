"""G032 positive fixture: fresh wrapper identities churning the jit cache."""
import functools

import torch


def _score(v):
    return v * 2.0


def _mul(scale, v):
    return v * scale


def serve(batch):
    scorer = torch.compile(lambda v: _score(v))  # EXPECT: G032
    return scorer(batch)


def rescale(batch, scale):
    def scaled(v):
        return _score(v) * scale

    return torch.compile(scaled)(batch)  # EXPECT: G032


def partial_wrap(batch, scale):
    return torch.compile(functools.partial(_mul, scale))(batch)  # EXPECT: G032


def fresh_scorer():
    return torch.compile(_score)


def drive(blocks):
    out = []
    for b in blocks:
        out.append(fresh_scorer()(b))  # EXPECT: G032
    return out
