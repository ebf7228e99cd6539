"""The 95th percentile of the host-to-host time of every call of the
window: a cascade call and the copy of its whole result to the host."""

from harness.window import p95


def read(ctx):
    return p95(ctx["latencies_s"]) * 1e3
