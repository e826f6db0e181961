"""G007 negative fixture: bound axes, dynamic axes (trusted), unknown
meshes (trusted) — zero findings."""

import torch

from hivemall_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                              pmean, psum)


WORKER_AXIS = "workers"
SHARD_AXIS = "shards"


def helper_loss(x, mesh):
    return psum(torch.sum(x), mesh, WORKER_AXIS)


def body(x, mesh):
    return helper_loss(x * 2, mesh)


def make_step(x):
    # the axis the helper reduces over IS bound by this mesh
    mesh = make_mesh(axis_name=WORKER_AXIS)
    return body(x, mesh)


def mix_avg(w, mesh, axis_name):
    # dynamic axis parameter with no resolvable binding: trusted
    return pmean(w, mesh, axis_name)


def make_step_2d(w, axis_for_mix):
    mesh = make_mesh_2d(2, 1, replica_axis=WORKER_AXIS,
                        shard_axis=SHARD_AXIS)

    def body2(w):
        return mix_avg(w, mesh, axis_for_mix)

    return body2(w)


def make_step_unknown_mesh(x, mesh):
    # the mesh is a parameter: trusted
    return body(x, mesh)


class Trainer:
    def __init__(self, mesh=None):
        # assigned from a parameter: the mesh is the caller's, trusted
        self.mesh = mesh if mesh is not None else make_mesh()

    def step(self, x):
        return psum(x, self.mesh, SHARD_AXIS)
