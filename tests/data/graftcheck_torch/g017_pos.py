"""Known-positive G017 silent-promotion cases.  # graftcheck: hot-module"""
import torch


def widen_in_score():
    table = torch.zeros((64,), dtype=torch.bfloat16)
    scale = torch.ones((64,), dtype=torch.float32)
    return table * scale  # EXPECT: G017


def int8_meets_f32(x):
    q = torch.zeros((16,), dtype=torch.int8)
    wide = torch.ones((16,), dtype=torch.float32)
    return q + wide  # EXPECT: G017


def _load_quantized():
    return torch.zeros((16,), dtype=torch.float16)


def widen_through_helper():
    q = _load_quantized()
    deq = q - torch.zeros((16,), dtype=torch.float32)  # EXPECT: G017
    return deq


def widen_via_binary_call():
    q = torch.ones((8,), dtype=torch.bfloat16)
    return torch.maximum(q, torch.zeros((8,), dtype=torch.float64))  # EXPECT: G017
