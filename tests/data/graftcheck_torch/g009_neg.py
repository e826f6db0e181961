"""G009 negative fixture: every TF32 read and write goes through the
version-portable runtime/torch_compat surface, autocast through torch.amp
and DTensor through its public module — zero findings."""

import torch
from torch.distributed.tensor import DTensor

from hivemall_tpu_torch.runtime.torch_compat import (set_tf32_matmul,
                                                     tf32_matmul_enabled)


def train_step(model, x):
    with torch.amp.autocast("cuda", dtype=torch.bfloat16):
        return model(x)


def tf32_on():
    return tf32_matmul_enabled()


def exact_matmuls():
    set_tf32_matmul(False)


def is_distributed(t):
    return isinstance(t, DTensor)
