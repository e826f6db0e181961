"""G007 positive fixture: collective axes not bound by the mesh they
receive — including through helper calls (the interprocedural case)."""

import torch

# the port's collectives receive their mesh, psum(x, mesh, axis), and a
# mesh binds the axes it was built with: make_mesh(axis_name=...) binds
# one (parallel/mesh.py)
from hivemall_tpu_torch.parallel.mesh import make_mesh, pmean, psum


WORKER_AXIS = "workers"
SHARD_AXIS = "shards"


def helper_loss(x, mesh):
    # two call-graph levels below the mesh's construction: still checked
    return psum(torch.sum(x), mesh, WORKER_AXIS)  # EXPECT: G007


def body(x, mesh):
    local = x * 2
    return helper_loss(local, mesh)


def make_step(x):
    # the mesh only binds "shards"; the helper psums over "workers"
    mesh = make_mesh(axis_name=SHARD_AXIS)
    return body(x, mesh)


def mix_avg(w, mesh, axis_name=WORKER_AXIS):
    return pmean(w, mesh, axis_name)  # EXPECT: G007


def body2(w, mesh):
    # the literal argument propagates along the call edge
    return mix_avg(w, mesh, WORKER_AXIS)


def make_step2(w):
    mesh = make_mesh(axis_name=SHARD_AXIS)
    return body2(w, mesh)
