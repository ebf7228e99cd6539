"""Device ms a call in the identification stages (each face's crop and
the embedding net with the L2 norm: the spans ``embed_crop`` and
``embed``), from the stamps inside the program's captured graph over the
stamped window (``harness/spans.py``)."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("embed_crop", "embed"))
