"""G033 negative fixture: shape-derived and static host decisions."""
import torch
import torch.nn.functional as F


def _route(table, upd):
    e, k = table.shape
    if e * k < 1024:  # shape-derived: concrete at trace time
        return table.reshape(-1), upd
    return table, upd


@torch.compile
def scatter_step(table, upd):
    flat, u = _route(table, upd)
    return flat.sum() + u.sum()


def _widen(v, width):
    if width > 8:  # untraced host argument
        return F.pad(v, (0, width - v.shape[0]))
    return v


@torch.compile
def pad_step(v):
    return _widen(v, 16)


def _by_rank(v):
    if v.ndim > 1:  # .ndim is static under trace
        return v.reshape(-1)
    return v


@torch.compile
def rank_step(v):
    return _by_rank(v).sum()


def _gate(v):
    return torch.ones(4) if v else torch.zeros(4)


score_static = torch.compile(_gate)


def dispatch(flag):
    return score_static(bool(flag))  # host scalar at the static position
