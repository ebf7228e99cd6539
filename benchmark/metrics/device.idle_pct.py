"""The share of the measured window in which the card waited between
calls: on the stream's clock (CUDA events recorded at each call's start
and once its work is queued, in the untraced window of the traced run),
the time from one call's end to the next call's start, over the time
from the first call's start to the last call's end.  Idle inside a call
(the host's launch before the call's first operation) is not in it; the
traced sub-window's ``busy_s`` over ``window_s`` sees that, with the
profiler's own cost on every graph launch."""


def read(ctx):
    gaps = ctx.get("device_gaps")
    if not gaps or gaps[1] <= 0:
        return None
    idle, span = gaps
    return 100.0 * idle / span
