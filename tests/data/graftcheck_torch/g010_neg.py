"""G010 negative fixture: reduced outputs, a rank's stripe returned as
such, and opaque helpers (trusted) — zero findings."""

import torch
from external_scoring import opaque_score

from hivemall_tpu_torch.parallel.mesh import all_gather_host, psum

SHARD_AXIS = "shards"


def reduced(w, idx, mesh):
    s = torch.index_select(w, 0, idx - mesh.index(SHARD_AXIS) * w.shape[0])
    return psum(torch.sum(s), mesh, SHARD_AXIS)


def sharded_out(w, mesh):
    # this rank's stripe, returned as its stripe: no reduction, no claim
    lo = mesh.index(SHARD_AXIS) * w.shape[0]
    return w[lo:] * 2


def calls_opaque(w, idx, mesh):
    # opaque external helper: could reduce internally, so it is trusted
    s = w[mesh.index(SHARD_AXIS)]
    return opaque_score(s.sum(), idx)


def gathered(w, mesh):
    part = (w * mesh.index(SHARD_AXIS)).sum()
    return all_gather_host(part, mesh, SHARD_AXIS).sum()


def stripe_score(mesh, axis_name):
    shard = mesh.index(axis_name)

    def local_score(w, x):
        # the closure's stripe is summed over the axis it came from
        return psum(torch.sum(w[shard] * x), mesh, axis_name)

    return local_score
