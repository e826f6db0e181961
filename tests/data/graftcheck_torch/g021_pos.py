"""Known-positive G021 low-precision-accumulation cases.

# graftcheck: hot-module
"""
import torch



def bf16_sum():
    x = torch.ones((16384,), dtype=torch.bfloat16)
    return torch.sum(x)


def f16_cumsum():
    x = torch.ones((1024,), dtype=torch.float16)
    return x.cumsum(0)


def bf16_mean():
    x = torch.ones((4096,), dtype=torch.bfloat16)
    return x.mean()


def bf16_scatter_add(idx, upd):
    acc = torch.zeros((256,), dtype=torch.bfloat16)
    return acc.index_add_(0, idx, upd)  # EXPECT: G021


def bf16_segment_sum(seg):
    vals = torch.ones((512,), dtype=torch.bfloat16)
    return torch.segment_reduce(vals, "sum", lengths=seg)
