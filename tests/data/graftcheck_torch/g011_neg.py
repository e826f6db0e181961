"""G011 negative fixture: collectives at rendezvous-safe positions — zero
findings."""

import os

import torch
import torch.distributed as dist

from hivemall_tpu_torch.parallel.mesh import psum

WORKER_AXIS = "workers"


def reduce_then_pick(x, mesh):
    # every rank runs the psum; only the USE is rank-dependent
    total = psum(x, mesh, WORKER_AXIS)
    i = mesh.index(WORKER_AXIS)
    return torch.where(torch.tensor(i == 0), total, x)


def t_branch(x):
    return x * 2


def f_branch(x):
    return x


def branch_no_collective(pred, x, mesh):
    # branches are collective-free: divergence cannot strand a rendezvous
    total = psum(x, mesh, WORKER_AXIS)
    return t_branch(total) if pred.item() else f_branch(total)


def loop_reduce(x, mesh, steps):
    # an ordinary Python loop bound: same trip count on every rank
    for _ in range(steps):
        x = x + psum(x, mesh, WORKER_AXIS)
    return x


def save_then_sync(path):
    # the world size is the same on every rank (runtime/recovery.py)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return path


def preempt_agreed(flag, dev):
    # every rank's view, MAX-reduced: all stop at the same step or none
    x = torch.tensor([1.0 if os.path.exists(flag) else 0.0], device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    if x.item() > 0:
        dist.barrier()
    return bool(x.item() > 0)


def supervised_loop(flag, x, mesh, steps):
    for _ in range(steps):
        if preempt_agreed(flag, mesh.device):
            break
        x = psum(x, mesh, WORKER_AXIS)
    return x
