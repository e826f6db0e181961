"""idle_pack.scan (%): the share of the traced window in which the card
ran nothing while the host was inside the port's `fit.pack` phase (a
block's rows packed into padded arrays, every block of every epoch;
`models/base.py`), from its mirror on torch.profiler's host timeline.
Nothing when the trace holds no such phase."""

from portbench.spans import idle_share


def read(view):
    return idle_share(view, ("fit.pack",))
