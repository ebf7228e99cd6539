"""Device ms a call in the detection stage (the detection warp and the
detector net: the span ``detect``), from the stamps inside the program's
captured graph over the stamped window (``harness/spans.py``)."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("detect",))
