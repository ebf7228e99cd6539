"""The whole identification step's share of the card's peak: the nets'
operations that the window's frames need (the detector on every frame,
the embedding net on every face the plain reference finds;
``costs.graph_flops``), over the window's seconds times the split-TF32
rate, the fastest that keeps f32 accuracy (at the plain f32 rate, convs
moved onto the tensor cores would read above 100%)."""

from pathlib import Path

from harness.costs import F32_SPLIT_TF32_FLOPS, graph_flops
from models import iresnet


def read(ctx):
    cfg = ctx["config"]
    det = graph_flops(Path(ctx["root"]) / "tpu_face" / "data"
                      / cfg["graphs"]["detector"])
    net = graph_flops(iresnet.model_dir(cfg, ctx["root"])
                      / iresnet.GRAPH_FILE)
    faces = sum(n * f for n, f in zip(ctx["counts"],
                                      ctx["reference_faces"]))
    flops = det * ctx["frames"] + net * faces
    return 100.0 * flops / (ctx["window_s"] * F32_SPLIT_TF32_FLOPS)
