"""Known-negative G006 cases: sanctioned or local effects."""
import torch
TRACE = torch.zeros(4, device="cuda")


@torch.compile
def debug_print_ok(x):
    TRACE.copy_(x)  # the sanctioned per-step effect: a device write
    return x


@torch.compile
def local_mutation_ok(slots, x):
    new_slots = dict(slots)
    new_slots["g"] = x
    acc = []
    acc.append(x)
    return new_slots, acc


@torch.compile
def device_rng_ok(gen):
    return torch.randn(4, device="cuda", generator=gen)


def host_loop_metrics_ok(blocks, counter):
    for blk in blocks:
        counter.increment()  # host side: counts real steps
    return blocks
