"""Known-negative G017 cases: same-width math, weak scalars, explicit
casts, and unknown operands are all trusted.

# graftcheck: hot-module
"""
import torch


def reduced_stays_reduced():
    table = torch.zeros((64,), dtype=torch.bfloat16)
    scale = torch.ones((64,), dtype=torch.bfloat16)
    return table * scale  # bf16 x bf16: no widening


def weak_scalar_follows_array():
    table = torch.zeros((64,), dtype=torch.bfloat16)
    return table * 2.0  # Python scalar promotes BY the array (weak)


def unknown_operand_is_trusted(table):
    return table * torch.ones((64,), dtype=torch.float32)  # param dtype unknown


def explicit_widening(table):
    wide = table.float()  # declared: not a SILENT promotion
    return wide * torch.ones((64,), dtype=torch.float32)


def wide_times_wide():
    a = torch.zeros((8,), dtype=torch.float32)
    b = torch.ones((8,), dtype=torch.float32)
    return a + b
