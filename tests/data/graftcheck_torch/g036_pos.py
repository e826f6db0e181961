"""G036 positive fixture: callee-performed device syncs inside hot loops."""
# graftcheck: jit-hot-module
import torch


def _read_back(out):
    return out.cpu()


def _summarize(state):
    return _read_back(state)[0]


def drive(step, blocks, state):
    logs = []
    for b in blocks:
        state = step(state, b)
        logs.append(_read_back(state))  # EXPECT: G036
    return state, logs


def monitor(step, blocks, state):
    history = []
    for b in blocks:
        state = step(state, b)
        history.append(_summarize(state))  # EXPECT: G036
    return state, history
