"""Frames whose results reached the host in the window, over the
window's seconds (host clock)."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"]
