"""The card's seconds inside the program's batch-norm spans (``bn_act.*``,
each BN forward with its SiLU, and ``bn.backward``; CUDA events at each
span's start and end on its stream, so idle time inside a span counts) over
the traced window, in percent. Nothing where the program records no such
span, or not on a card, or where the process used more than one card (one
card's stream times a span: ``span_totals`` gives no device seconds)."""

PREFIXES = ("bn_act.", "bn.backward")


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from sensorium_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without spans
        return None
    device = [d for name, (_, _, d) in span_totals().items() if name.startswith(PREFIXES)]
    if not device or None in device:
        return None
    return 100.0 * sum(device) / ctx.trace.window_s
