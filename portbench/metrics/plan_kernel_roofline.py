"""plan_kernel_roofline (%): the least time the window's scan plans need on
the card, over the device time of `linear_scan_plan_kernel` by
torch.profiler: the block's ids read once and three int32 plan arrays
written once (`counts.plan_block`) at the HBM peak. Nothing when the trace
holds no launch, or another number than the window ran blocks."""


def read(view):
    seconds, launches = view.kernel("linear_scan_plan_kernel")
    bandwidth = view.peak("hbm_bytes_per_s")
    if not launches or launches != view.steps or bandwidth is None:
        return None
    return 100.0 * view.work("plan").bytes / bandwidth / seconds
