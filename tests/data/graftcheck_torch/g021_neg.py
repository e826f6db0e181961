"""Known-negative G021 cases: widened accumulators, f32 inputs, unknown
dtypes, and non-accumulating ops.

# graftcheck: hot-module
"""
import torch



def widened_accumulator():
    x = torch.ones((16384,), dtype=torch.bfloat16)
    return torch.sum(x, dtype=torch.float32)  # the sanctioned idiom


def f32_sum():
    x = torch.ones((16384,), dtype=torch.float32)
    return torch.sum(x)


def unknown_operand(x):
    return torch.sum(x)  # param dtype unknown: trusted


def f32_scatter_add(idx, upd):
    acc = torch.zeros((256,), dtype=torch.float32)
    return acc.index_add_(0, idx, upd)


def touch_max_is_not_accumulation(idx):
    touched = torch.zeros((256,), dtype=torch.int8)
    return touched.scatter_reduce_(0, idx, torch.ones_like(touched), "amax")  # max: no absorbed-update error


def widened_method_sum():
    x = torch.ones((512,), dtype=torch.float16)
    return x.sum(dtype=torch.float32)


def f32_segment_sum(seg):
    vals = torch.ones((512,), dtype=torch.float32)
    return torch.segment_reduce(vals, "sum", lengths=seg)
