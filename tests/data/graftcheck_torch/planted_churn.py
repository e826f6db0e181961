"""A planted capture churn: fresh_scorer captures a fresh closure on every
call and drive calls it once per block (G032 flags both lines); drive_memo
reaches the same capture through a memo dict, built once per shape."""
import torch

_SCORER_GRAPH = {}


def fresh_scorer(sample):
    def churn_score(v):
        return torch.sum(v * 2.0)
    return torch.cuda.make_graphed_callables(churn_score, (sample,))


def drive(blocks):
    out = []
    for b in blocks:
        out.append(fresh_scorer(b)(b))
    return out


def memo_scorer(sample):
    key = (tuple(sample.shape), sample.dtype)
    got = _SCORER_GRAPH.get(key)
    if got is None:
        got = fresh_scorer(sample)
        _SCORER_GRAPH[key] = got
    return got


def drive_memo(blocks):
    out = []
    for b in blocks:
        out.append(memo_scorer(b)(b).clone())
    return out
