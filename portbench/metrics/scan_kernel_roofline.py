"""scan_kernel_roofline (%): the least time the window's exact-scan blocks
need on the card, over the device time of `linear_scan_kernel`
(kernels/linear_scan.py, csrc/linear_scan.cu) by torch.profiler. The least
time is the larger of the blocks' counted bytes over the HBM peak and their
counted FLOPs over the float32 peak (`counts.scan_block`: bytes bind).
Nothing when the trace holds no launch, or another number of launches than
the window ran blocks."""


def read(view):
    seconds, launches = view.kernel("linear_scan_kernel")
    bandwidth = view.peak("hbm_bytes_per_s")
    flops = view.peak("f32_flops_per_s")
    if not launches or launches != view.steps or bandwidth is None \
            or flops is None:
        return None
    work = view.work("scan")
    return 100.0 * max(work.bytes / bandwidth, work.flops / flops) / seconds
