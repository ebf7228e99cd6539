"""The embedding net's share of its roofline: the least time the net
needs for a call's B*K crops, over the device ms a call of the span
``embed`` (the net and the L2 norm) in the stamped window
(``harness/spans.py``).  The least time is the larger of the net's
convolution and FC operations (``costs.graph_flops``) at the split-TF32
rate, the fastest that keeps f32 accuracy, and its bytes
(``net_bytes.graph_bytes``) at the HBM bandwidth.  Nothing where the
span was not read."""

from harness.costs import (F32_SPLIT_TF32_FLOPS, HBM_BYTES_PER_S,
                           graph_flops)
from harness.net_bytes import graph_bytes
from harness.spans import device_ms
from models import iresnet


def read(ctx):
    ms = device_ms(ctx, ("embed",))
    if ms is None:
        return None
    cfg = ctx["config"]
    path = iresnet.model_dir(cfg, ctx["root"]) / iresnet.GRAPH_FILE
    crops = ctx["traffic"]["batch"] * cfg["max_faces"]
    bound_s = max(graph_flops(path) * crops / F32_SPLIT_TF32_FLOPS,
                  graph_bytes(path, crops) / HBM_BYTES_PER_S)
    return 100.0 * bound_s / (ms * 1e-3)
