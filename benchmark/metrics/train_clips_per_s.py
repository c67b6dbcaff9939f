"""Clips of every training step the window ran, over the window's seconds
(the window ends once the fit has fetched its loss, which waits for the card)."""


def read(ctx):
    return ctx.counts["clips"] / ctx.window_s if "clips" in ctx.counts else None
