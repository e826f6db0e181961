"""G008 positive fixture: mesh lookups naming axes the mesh does not bind
(the port's counterpart of a PartitionSpec naming one)."""

import torch

# a rank finds its stripe by axis name: mesh.index(axis), mesh.shape[axis]
# (parallel/sharded.py); an axis its make_mesh did not bind raises KeyError
from hivemall_tpu_torch.parallel.mesh import make_mesh, psum


WORKER_AXIS = "workers"
SHARD_AXIS = "shards"


def local_score(w, x, mesh, shard):
    return psum(torch.sum(w[shard] * x), mesh, SHARD_AXIS)


def make_predict(w, x):
    # 1-D mesh binds only "shards"; the stripe lookup names "workers"
    mesh = make_mesh(axis_name=SHARD_AXIS)
    return local_score(w, x, mesh,
                       mesh.index(WORKER_AXIS))  # EXPECT: G008


def place(x):
    # a 1-D mesh of workers has no "model" axis to count stripes on
    mesh = make_mesh(axis_name=WORKER_AXIS)
    return x.reshape(mesh.shape["model"], -1)  # EXPECT: G008
