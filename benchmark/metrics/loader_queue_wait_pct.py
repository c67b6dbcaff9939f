"""The host's seconds inside the program's ``loader.wait`` spans (the fit
loop blocked on the loader's queue of ready batches) over the traced window,
in percent. Nothing where the program records no such span, or not on a
card, or where the process used more than one card (``span_totals`` gives
no device seconds there)."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from sensorium_tpu_torch.utils.profiling import span_totals
    except ImportError:  # a program without spans
        return None
    wait = span_totals().get("loader.wait")
    if wait is None or wait[2] is None:
        return None
    return 100.0 * wait[1] / ctx.trace.window_s
