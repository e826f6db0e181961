"""Known-positive G006 untraced-side-effect cases."""
import time

import torch
import numpy as np

COUNTER = {"steps": 0}
LOG = []


@torch.compile
def print_in_trace(state, x):
    print("step!", x)  # EXPECT: G006
    return state + x


@torch.compile
def metrics_in_trace(counter, x):
    counter.increment()  # EXPECT: G006
    return x


@torch.compile
def clock_in_trace(x):
    t0 = time.perf_counter()  # EXPECT: G006
    return x * t0


@torch.compile
def numpy_rng_in_trace(x):
    noise = np.random.randn()  # EXPECT: G006
    return x + noise


@torch.compile
def closure_mutation(x):
    LOG.append(x)  # EXPECT: G006
    COUNTER["steps"] += 1  # EXPECT: G006
    return x
