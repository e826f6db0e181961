"""Known-positive G004 axis-name-mismatch cases."""
from hivemall_tpu_torch.parallel.mesh import pmean, psum


def typoed_psum(x, mesh):
    return psum(x, mesh, "worker")  # EXPECT: G004


def typoed_axis_index(mesh):
    return mesh.index("replicas")  # EXPECT: G004


def typoed_kwarg(x, mesh):
    return pmean(x, mesh, axis="shard")  # EXPECT: G004
