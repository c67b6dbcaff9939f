"""The model FLOPs of the window's work (``work/counts.py``: products and
depthwise taps of the forwards, three forwards a training step, a frozen
teacher's forward; no rematerialized rerun) over the window's seconds and
the card's published bfloat16 dense peak, in percent."""


def read(ctx):
    if ctx.rates is None or "flops" not in ctx.work:
        return None
    return 100.0 * ctx.work["flops"] / ctx.window_s / ctx.rates["bfloat16_flops"]
