"""Share of the window the fit loop spent blocked in the loader's next(),
timed by the benchmark's wrapper around the loader."""


def read(ctx):
    wait = ctx.counts.get("loader_wait_s")
    return None if wait is None else 100.0 * wait / ctx.window_s
