"""mfu.scan (%): the window's counted model work at the card's published
peak, over the window: the larger of the exact-scan blocks' counted FLOPs
over the float32 peak (no tensor cores) and their counted bytes over the
HBM peak (`counts.scan_block`), over the traced window's seconds. Bytes
bind for these learners; the card's power limit is printed beside every
run. The plan is the scan kernel's own device work, not the learner's,
and is not counted."""


def read(view):
    bandwidth = view.peak("hbm_bytes_per_s")
    flops = view.peak("f32_flops_per_s")
    if bandwidth is None or flops is None or not view.window_s:
        return None
    work = view.work("scan")
    return 100.0 * max(work.bytes / bandwidth,
                       work.flops / flops) / view.window_s
