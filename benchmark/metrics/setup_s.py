"""Seconds from the process's start to the window's: imports, the
kernels' build or its cache, the weights, the frame pool and the
capturing first call with the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
