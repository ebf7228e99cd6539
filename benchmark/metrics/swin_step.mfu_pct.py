"""The whole identification step's share of the card's peak with the Swin
as the embedding net: the nets' operations that the window's frames need
(the detector on every frame, ``costs.graph_flops``; the Swin on every
face the plain reference finds, ``swin_costs.graph_flops``, its FCs over
every window's tokens and its BATCH_MATMULs), over the window's seconds
times the split-TF32 rate, the fastest that keeps f32 accuracy."""

from pathlib import Path

from harness import swin_costs
from harness.costs import F32_SPLIT_TF32_FLOPS, graph_flops
from models import swin


def read(ctx):
    cfg = ctx["config"]
    det = graph_flops(Path(ctx["root"]) / "tpu_face" / "data"
                      / cfg["graphs"]["detector"])
    net = swin_costs.graph_flops(swin_costs.graph_meta(
        swin.model_dir(cfg, ctx["root"]) / swin.GRAPH_FILE))
    faces = sum(n * f for n, f in zip(ctx["counts"],
                                      ctx["reference_faces"]))
    flops = det * ctx["frames"] + net * faces
    return 100.0 * flops / (ctx["window_s"] * F32_SPLIT_TF32_FLOPS)
