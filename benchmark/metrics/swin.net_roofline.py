"""The Swin embedding net's share of its roofline: the least time the net
needs for a call's B*K crops, over the device ms a call of the span
``embed`` (the net and the L2 norm) in the stamped window
(``harness/spans.py``).  The least time is the larger of the net's
operations (``swin_costs.graph_flops``: every FC over all its rows, every
window's tokens, the BATCH_MATMULs, the patch convolution) at the
split-TF32 rate, the fastest that keeps f32 accuracy, and its bytes
(``swin_costs.graph_bytes``) at the HBM bandwidth.  Nothing where the
span was not read."""

from harness import swin_costs
from harness.costs import F32_SPLIT_TF32_FLOPS, HBM_BYTES_PER_S
from harness.spans import device_ms
from models import swin


def read(ctx):
    ms = device_ms(ctx, ("embed",))
    if ms is None:
        return None
    cfg = ctx["config"]
    meta = swin_costs.graph_meta(swin.model_dir(cfg, ctx["root"])
                                 / swin.GRAPH_FILE)
    crops = ctx["traffic"]["batch"] * cfg["max_faces"]
    bound_s = max(swin_costs.graph_flops(meta) * crops / F32_SPLIT_TF32_FLOPS,
                  swin_costs.graph_bytes(meta, crops) / HBM_BYTES_PER_S)
    return 100.0 * bound_s / (ms * 1e-3)
