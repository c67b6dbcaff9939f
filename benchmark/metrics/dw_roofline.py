"""The depthwise convolutions' least time (``work/counts.py``: each input
read once and each output written once a call, or their float32 taps at the
card's peak, whichever is longer; no rematerialized rerun) over the device
seconds of the kernels that carry them in the window's trace, in percent."""

KERNELS = ("dw_spatial_fwd_kernel", "dw_temporal_fwd_walk", "dw_spatial_dx_kernel", "dw_spatial_dw_kernel",
           "dw_temporal_dw_walk", "sum_slabs")


def read(ctx):
    if ctx.trace is None or "dw_least_s" not in ctx.work:
        return None
    seconds = ctx.trace.device_seconds(KERNELS)
    return 100.0 * ctx.work["dw_least_s"] / seconds if seconds > 0 else None
