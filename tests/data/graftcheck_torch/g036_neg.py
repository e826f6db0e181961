"""G036 negative fixture: declared sync boundaries and loop-edge reads."""
# graftcheck: jit-hot-module
import torch


def fetch_state(out):
    # *_fetch/*_sync names declare the sync: callers opt in knowingly
    return out.cpu()


def _bump(n):
    return n + 1


def drive(step, blocks, state):
    for b in blocks:
        state = step(state, b)
    return fetch_state(state)  # whole-value read at the loop boundary


def count(blocks):
    total = 0
    for _b in blocks:
        total = _bump(total)  # host-only helper: nothing blocks
    return total
