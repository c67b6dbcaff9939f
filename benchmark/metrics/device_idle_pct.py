"""Share of the traced window in which no operation ran on the card (the
union of each card's device intervals in the profiler's trace, averaged
over the cards), in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
