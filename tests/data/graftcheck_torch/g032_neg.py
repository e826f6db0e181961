"""G032 negative fixture: construction-once contexts and memoized wrappers."""
import functools

import torch


def _score(v):
    return v * 2.0


predictor = torch.compile(_score)  # module level: one wrapper forever

_SCORER_JIT = {}


def _scorer_jit(key, build):
    got = _SCORER_JIT.get(key)
    if got is None:
        got = build()
        _SCORER_JIT[key] = got
    return got


def make_scorer(scale):
    # a make_* factory is construction-once by convention
    def scaled(v):
        return _score(v) * scale

    return torch.compile(scaled)


@functools.lru_cache(maxsize=None)
def _cached_scorer(width):
    return torch.compile(_score)


class Engine:
    def __init__(self):
        self._step = torch.compile(_score)

    def run(self, blocks):
        out = []
        for b in blocks:
            out.append(self._step(b))
        return out


def scorer(x):
    return torch.compile(_score)(x)


def run_shadowed(blocks):
    # the local binding shadows the module-level `scorer` def above — the
    # loop calls the memoized wrapper, not the constructor
    scorer = _scorer_jit("fixed", lambda: torch.compile(_score))
    out = []
    for b in blocks:
        out.append(scorer(b))
    return out


def run_cached(blocks):
    out = []
    for b in blocks:
        out.append(_cached_scorer(4)(b))
    return out
