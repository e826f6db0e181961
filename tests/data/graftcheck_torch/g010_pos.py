"""G010 positive fixture: a rank's partial value, reduced over its own
stripe, returned as if it were the whole."""

import torch

from hivemall_tpu_torch.parallel.mesh import make_mesh

# A rank's stripe returned as itself is that rank's stripe by design: no
# torch function declares its output replicated, so the reference's
# passthrough case (out_specs=P() over a sharded input) has no torch form
# (TORCH_DEPARTURES).
SHARD_AXIS = "shards"


def passthrough(w, idx):
    # w is this rank's stripe, and the caller knows it
    return w


def make_bad_passthrough(w, idx):
    mesh = make_mesh(axis_name=SHARD_AXIS)
    return passthrough(w, idx), mesh


def local_top(w, idx, mesh):
    lo = mesh.index(SHARD_AXIS) * w.shape[0]
    s = torch.index_select(w, 0, idx - lo)
    # no collective anywhere in the call graph: a partial sum per rank
    return torch.sum(s)  # EXPECT: G010


def make_bad_unreduced(w, idx):
    mesh = make_mesh(axis_name=SHARD_AXIS)
    return local_top(w, idx, mesh)
