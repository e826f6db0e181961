"""Known-negative G019 cases: loop-variant receivers, hoisted casts,
narrowing casts, and unknown dtypes are trusted.

# graftcheck: hot-module
"""
import torch


def hoisted_cast(table, blocks):
    t = table.to(dtype=torch.float32)  # once, above the loop
    out = []
    for blk in blocks:
        out.append(t[blk])
    return out


def loop_variant_receiver(x, blocks):
    for blk in blocks:
        x = x.float()[blk]  # x rebound each iteration
    return x


def narrowing_cast_is_the_goal():
    acc = torch.zeros((256,), dtype=torch.float32)
    return acc.bfloat16()  # the storage-policy write


def unknown_receiver(table):
    return table.type(torch.float32)  # param dtype unknown: trusted


def loop_target_cast(chunks):
    out = []
    for c in chunks:
        out.append(c.float())  # casts a DIFFERENT chunk each time
    return out
