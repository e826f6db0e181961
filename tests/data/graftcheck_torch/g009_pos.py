"""G009 positive fixture: version-fragile torch spellings. The TF32 flag's
read carries a machine-applicable fix; the fixer round-trip test applies
it and re-scans."""

import math

import torch
from torch._six import inf  # EXPECT: G009

MAX_NORM = 1.0


def clip(x):
    return torch.clamp(x, -inf, math.inf)


def train_step_mixed(model, x):
    # the deprecated spelling of autocast, which torch.amp.autocast("cuda",
    # ...) replaces
    x = x.float()
    with torch.cuda.amp.autocast(dtype=torch.bfloat16):  # EXPECT: G009
        return model(x)


def tf32_on():
    return torch.backends.cuda.matmul.allow_tf32  # EXPECT: G009
