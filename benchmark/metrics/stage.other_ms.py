"""Device ms a call in the captured graph outside every stage span (the
frame planes, the ROIs, the projections, the iris refinement and the
result's assembly): the self time of the span ``programs.graph`` over
the stamped window (``harness/spans.py``)."""

from harness.spans import own_ms


def read(ctx):
    return own_ms(ctx, "programs.graph")
