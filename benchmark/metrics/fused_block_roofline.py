"""The fused residual-block kernel's share of its roofline: the least
time the configuration's fused runs need at the call's batch (the
largest of their 1x1 operations at the split-TF32 rate, their other
operations at the f32 rate and their bytes at the HBM bandwidth), over
the kernel's device time in the traced sub-window.  Nothing where the
kernel did not run."""

from harness.costs import fused_bound_s

KERNEL = "fused_blocks_kernel"


def read(ctx):
    t = ctx["trace"]
    runs = ctx["config"].get("fused_runs")
    if not t or not runs:
        return None
    spent = sum(s for name, s in t["device_ops"].items() if KERNEL in name)
    if spent <= 0:
        return None
    bound = fused_bound_s(runs, ctx["traffic"]["batch"]) * t["calls"]
    return 100.0 * bound / spent
