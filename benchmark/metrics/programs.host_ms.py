"""Host ms a call in the program (the span ``programs.call``: the input
copies queued, the graph launched, the outputs' clones queued), on the
host's clock over the stamped window (``harness/spans.py``)."""

from harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, "programs.call")
