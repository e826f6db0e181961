"""G035 positive fixture: donated buffers reused across calls."""
import torch
import torch.nn.functional as F


def _accum(best, cand):
    return torch.maximum(best, cand)


merge = torch.cuda.make_graphed_callables(_accum, SAMPLE)


def run(blocks, best):
    out = []
    for cand in blocks:
        out.append(merge(best, cand))  # EXPECT: G035
    return out


def _build_merge():
    return torch.cuda.make_graphed_callables(_accum, SAMPLE)


class Reducer:
    def __init__(self):
        self._merge = _build_merge()

    def reduce(self, best, cand):
        best2 = self._merge(best, cand)
        return self._merge(best2, cand) + best2  # EXPECT: G035
