"""G011 positive fixture: collectives under rank-divergent control flow."""

from hivemall_tpu_torch.parallel.mesh import psum


WORKER_AXIS = "workers"


def skewed_reduce(x, mesh):
    i = mesh.index(WORKER_AXIS)
    if i == 0:
        # only rank 0 reaches the rendezvous: the others deadlock
        return psum(x, mesh, WORKER_AXIS)  # EXPECT: G011
    return x


def t_branch(x, mesh):
    return psum(x, mesh, WORKER_AXIS)  # EXPECT: G011


def f_branch(x):
    return x


def branch_reduce(pred, x, mesh):
    # a rank's own tensor decides: the others may take f_branch
    return t_branch(x, mesh) if pred.item() else f_branch(x)
