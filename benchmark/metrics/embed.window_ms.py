"""Device ms a call in the embedding net's window partitions and reverses
(the spans ``net.window`` that ``TFLiteNet`` opens around each: the
token-grid RESHAPE, the cyclic shifts, the window factorisation's RESHAPE,
TRANSPOSE and RESHAPE), from the stamps inside the program's captured
graph over the stamped window (``harness/spans.py``).  Nothing where the
program opens no such span."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("net.window",))
