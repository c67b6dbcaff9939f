"""The card's seconds inside the program's update spans (``step.zero_grad``,
``step.optimizer``: clip, lr and the optimizer's step, ``step.ema``; CUDA
events at each span's start and end on its stream) over the traced window,
in percent. Nothing where the program records no such span, or not on a
card, or where the process used more than one card (one card's stream times
a span: ``span_totals`` gives no device seconds)."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from sensorium_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without spans
        return None
    device = [d for name, (_, _, d) in span_totals().items() if name.startswith("step.")]
    if not device or None in device:
        return None
    return 100.0 * sum(device) / ctx.trace.window_s
