"""Known-positive G001 recompile-hazard cases (parsed, never imported)."""
import torch
import torch.nn.functional as F


@torch.compile
def branch_on_traced(x, threshold):
    if x > threshold:  # EXPECT: G001
        return x
    return -x


@torch.compile
def while_on_traced(x):
    while x < 10:  # EXPECT: G001
        x = x + 1
    return x


@torch.compile
def shape_keyed_fstring(x):
    key = f"block-{x.shape}"  # EXPECT: G001
    return x, key


def rejit_in_loop(blocks, fn):
    out = []
    for blk in blocks:
        stepper = torch.compile(fn)  # EXPECT: G001
        out.append(stepper(blk))
    return out


def data_dependent_statics(fn, batch):
    nums = tuple(range(batch.ndim))
    return torch.compile(fn, dynamic=len(nums) > 1)
