"""Known-positive G019 cast-in-loop / materializing-dequant cases.

# graftcheck: hot-module
"""
import torch


def cast_per_step(table, blocks):
    out = []
    for blk in blocks:
        t = table.float()  # EXPECT: G019
        out.append(t[blk])
    return out


def cast_per_poll(table, ready):
    total = table
    while ready():
        total = total + table.to(torch.float32)  # EXPECT: G019
    return total


def materializing_dequant(blocks):
    q = torch.zeros((1 << 20,), dtype=torch.bfloat16)
    wide = q.to("cuda", torch.float32)  # EXPECT: G019
    return [wide[b] for b in blocks]
