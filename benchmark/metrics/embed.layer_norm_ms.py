"""Device ms a call in the embedding net's LayerNorms (the spans
``net.layer_norm`` that ``TFLiteNet`` opens around each decomposed
LayerNorm), from the stamps inside the program's captured graph over the
stamped window (``harness/spans.py``).  Nothing where the program opens
no such span."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("net.layer_norm",))
