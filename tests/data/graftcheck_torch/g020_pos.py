"""Known-positive G020 dtype-unstable round-trip cases.

# graftcheck: artifact-io
"""
import torch
import numpy as np


def load_state(path):
    with np.load(path) as z:
        return torch.as_tensor(z["weights"])  # EXPECT: G020


def rebuild_from_pack(artifact):
    a = artifact.arrays
    return torch.from_numpy(a["w"])  # EXPECT: G020


def rebuild_tuple_bound(artifact):
    a, meta = artifact.arrays, artifact.meta
    table = torch.tensor(a["table"])  # EXPECT: G020
    return table, meta


def load_slots(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}  # EXPECT: G020
