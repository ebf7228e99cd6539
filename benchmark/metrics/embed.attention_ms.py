"""Device ms a call in the embedding net's attention cores (the spans
``net.attention`` that ``TFLiteNet`` opens around each: the head split of
q, k and v through the head merge, not the projections), from the stamps
inside the program's captured graph over the stamped window
(``harness/spans.py``).  Nothing where the program opens no such span."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("net.attention",))
