"""idle_stage.scan (%): the share of the traced window in which the card
ran nothing while the host was inside the port's `fit.stage` span (a fit's
rows hashed into arrays, once a fit; `models/base.py`), from its mirror on
torch.profiler's host timeline. Nothing when the trace holds no such span,
as a program without the span gives."""

from portbench.spans import idle_share


def read(view):
    return idle_share(view, ("fit.stage",))
