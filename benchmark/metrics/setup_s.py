"""Seconds from the process's start to the measured window: imports,
inputs, weights, the first launches (and their builds, on a first run) and
the warm-up steps or requests."""


def read(ctx):
    return ctx.setup_s
