"""Device idle ms a call from the end of the program's input copies
(the span ``programs.copy_in``) to the start of its graph
(``programs.graph``): the host's graph launch as the device waits for
it, over the stamped window (``harness/spans.py``)."""

from harness.spans import launch_wait_ms


def read(ctx):
    return launch_wait_ms(ctx)
