"""idle_dispatch.scan (%): the share of the traced window in which the card
ran nothing while the host was inside one of the port's dispatch spans and
phases (`models/base.py`): `fit.init_state` (the tables' allocation, once a
fit), `fit.h2d` (a block's copies), `fit.step` (the kernel wrapper's host
work and launches) and `fit.epoch_sync` (the epoch's loss read back), from
their mirrors on torch.profiler's host timeline. Nothing when the trace
holds none of them."""

from portbench.spans import idle_share


def read(view):
    return idle_share(view, ("fit.init_state", "fit.h2d", "fit.step",
                             "fit.epoch_sync"))
