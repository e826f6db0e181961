"""G035 negative fixture: donated buffers rebound before reuse."""
import torch
import torch.nn.functional as F


def _accum(best, cand):
    return torch.maximum(best, cand)


merge = torch.cuda.make_graphed_callables(_accum, SAMPLE)


def run(blocks, best):
    for cand in blocks:
        best = merge(best, cand)  # the carry rebinds the replay's output
    return best


def _build_merge():
    return torch.cuda.make_graphed_callables(_accum, SAMPLE)


class Reducer:
    def __init__(self):
        self._merge = _build_merge()

    def reduce(self, best, cand):
        best = self._merge(best, cand)
        return best
