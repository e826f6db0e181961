"""G033 positive fixture: host branches/conversions on traced values."""
import torch
import torch.nn.functional as F


def _clip(delta, lo):
    if delta < lo:  # EXPECT: G033
        return lo
    return delta


@torch.compile
def update(w, delta):
    return w + _clip(delta, 0.0)


def _log_norm(v):
    return float(torch.sum(v))  # EXPECT: G033


@torch.compile
def norm_step(w):
    return w * _log_norm(w)


def _gate(v):
    return torch.ones(4) if v else torch.zeros(4)


score_static = torch.compile(_gate)


def dispatch(xs):
    dev = torch.as_tensor(xs, device="cuda")
    return score_static(dev)
