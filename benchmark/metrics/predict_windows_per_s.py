"""Window forwards of every trial the window served, over its seconds (each
trial's blend is on the host before the next is sent)."""


def read(ctx):
    return ctx.counts["windows"] / ctx.window_s if "windows" in ctx.counts else None
