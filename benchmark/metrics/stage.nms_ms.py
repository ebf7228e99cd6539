"""Device ms a call in the weighted NMS (decoding, scores, validity,
the merge and the letterbox's removal: the span ``nms``), from the stamps
inside the program's captured graph over the stamped window
(``harness/spans.py``)."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("nms",))
