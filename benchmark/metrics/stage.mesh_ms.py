"""Device ms a call in the mesh stages (the face ROI's warp and the
mesh net: the spans ``mesh_warp`` and ``mesh``), from the stamps inside
the program's captured graph over the stamped window
(``harness/spans.py``)."""

from harness.spans import device_ms


def read(ctx):
    return device_ms(ctx, ("mesh_warp", "mesh"))
