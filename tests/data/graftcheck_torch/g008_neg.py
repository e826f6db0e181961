"""G008 negative fixture: lookups consistent with their mesh; dynamic
axes and unknown meshes trusted — zero findings."""

import torch

from hivemall_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, psum


WORKER_AXIS = "workers"
SHARD_AXIS = "shards"


def local_score(w, x, mesh, shard):
    return psum(torch.sum(w[shard] * x), mesh, SHARD_AXIS)


def make_predict(w, x):
    mesh = make_mesh(axis_name=SHARD_AXIS)
    return local_score(w, x, mesh, mesh.index(SHARD_AXIS))


def make_predict_2d(w, x):
    mesh = make_mesh_2d(2, 2)  # binds workers x shards by default
    rows = mesh.shape[WORKER_AXIS]
    return local_score(w, x, mesh, mesh.coords[SHARD_AXIS]) * rows


def place(x):
    mesh = make_mesh()
    return x.reshape(mesh.shape[WORKER_AXIS], -1)


def place_dynamic(x, axis):
    # non-literal axis: trusted
    mesh = make_mesh()
    return x.reshape(mesh.shape[axis], -1)


def place_unknown_mesh(x, mesh):
    # unknown mesh: trusted
    return x.reshape(mesh.shape["model"], -1)
