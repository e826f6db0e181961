"""Known-negative G020 cases: pinned reloads and host-side pack uses.

# graftcheck: artifact-io
"""
import torch
import numpy as np


def load_state_pinned(path, table_dt):
    with np.load(path) as z:
        return torch.as_tensor(z["weights"], table_dt)


def rebuild_pinned(artifact):
    a = artifact.arrays
    return torch.as_tensor(a["w"], dtype=torch.float32)


def rebuild_kwarg_pinned(artifact):
    a = artifact.arrays
    return torch.from_numpy(a["w"]).to(torch.bfloat16)


def host_side_use(artifact):
    a = artifact.arrays
    return np.asarray(a["feature"], np.int64)  # numpy round-trips exactly


def not_a_pack(rows):
    return torch.as_tensor(rows[0])  # plain sequence subscript: trusted
