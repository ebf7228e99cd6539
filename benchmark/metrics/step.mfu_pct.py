"""The whole step's share of the card's peak: the nets' operations that
the window's frames need (the detector on every frame, the mesh and two
irises on every face the plain reference finds), over the window's
seconds times the peak for the configuration's type."""

from harness.costs import PEAK_FLOPS, cascade_flops


def read(ctx):
    cfg, traffic = ctx["config"], ctx["traffic"]
    det, face = cascade_flops(cfg, ctx["root"])
    faces = sum(n * f for n, f in zip(ctx["counts"],
                                      ctx["reference_faces"]))
    flops = det * ctx["frames"] + face * faces
    return 100.0 * flops / (ctx["window_s"] * PEAK_FLOPS[cfg["compute_dtype"]])
