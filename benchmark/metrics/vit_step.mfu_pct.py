"""The whole identification step's share of the card's peak with the ViT
as the embedding net: the nets' operations that the window's frames need
(the detector on every frame, ``costs.graph_flops``; the ViT on every face
the plain reference finds, ``vit_costs.graph_flops``, its FCs over all
token rows and its BATCH_MATMULs), over the window's seconds times the
split-TF32 rate, the fastest that keeps f32 accuracy."""

from pathlib import Path

from harness import vit_costs
from harness.costs import F32_SPLIT_TF32_FLOPS, graph_flops
from models import vit


def read(ctx):
    cfg = ctx["config"]
    det = graph_flops(Path(ctx["root"]) / "tpu_face" / "data"
                      / cfg["graphs"]["detector"])
    net = vit_costs.graph_flops(vit_costs.graph_meta(
        vit.model_dir(cfg, ctx["root"]) / vit.GRAPH_FILE))
    faces = sum(n * f for n, f in zip(ctx["counts"],
                                      ctx["reference_faces"]))
    flops = det * ctx["frames"] + net * faces
    return 100.0 * flops / (ctx["window_s"] * F32_SPLIT_TF32_FLOPS)
