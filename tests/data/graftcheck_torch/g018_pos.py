"""Known-positive G018 f64-leak cases.  # graftcheck: serving-module"""
import numpy as np
import torch

def stage_request(instances, n_features):
    return torch.as_tensor(instances, dtype=torch.float64).reshape(-1, n_features)  # EXPECT: G018


def pad_labels(n):
    return torch.as_tensor(np.zeros(n))  # EXPECT: G018


def empty_scores(n):
    return torch.from_numpy(np.zeros((0, n)))  # EXPECT: G018


def ones_buffer(n):
    return torch.tensor(np.ones(n))  # EXPECT: G018


def cast_table(w):
    return w.double()  # EXPECT: G018


def float_fill(n):
    return torch.as_tensor(np.full((n,), 0.5))  # EXPECT: G018
