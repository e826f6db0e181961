"""Known-negative G004 cases: declared or variable axis names."""
import torch.distributed as dist

from hivemall_tpu_torch.parallel.mesh import make_mesh, pmean, psum

LOCAL_AXIS = "rows"  # *_AXIS module constant: a declaration


def registry_axis(x, mesh):
    return psum(x, mesh, "workers")  # declared in parallel/mesh.py


def registry_shard_axis(x, mesh):
    return pmean(x, mesh, "shards")


def variable_axis(x, mesh, axis):
    return psum(x, mesh, axis)  # variables trace back to the registry


def local_constant_axis(x, mesh):
    return psum(x, mesh, LOCAL_AXIS)


def local_literal_after_declaration(mesh):
    return mesh.index("rows")


def private_mesh_axis(x):
    mesh = make_mesh(axis_name="pipeline")
    dist.barrier()  # names a group, not an axis
    return psum(x, mesh, "pipeline")
