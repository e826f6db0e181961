"""device_idle.scan (%): the share of the traced window in which no
kernel, copy or fill ran on the card (torch.profiler's timeline, union),
in the exact-scan cells."""


def read(view):
    if not view.window_s or not view.device_ops:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
