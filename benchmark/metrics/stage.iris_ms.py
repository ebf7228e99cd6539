"""Device ms a call in the iris stages (both eyes' warps and the iris
net: the spans ``iris_warp`` and ``iris``), from the stamps inside the
program's captured graph over the stamped window (``harness/spans.py``)."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("iris_warp", "iris"))
