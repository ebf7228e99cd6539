"""First-order memory traffic and FLOP model of the cascade on the card.

The counterpart of the JAX package's ``compiler/traffic.py``: it counts,
stage by stage, the bytes one cascade call has to move through the
card's memory and the FLOPs of its products, so that the bench
(``tpu_face_torch.bench``) can put achieved GB/s (``hbm_gbps``) beside
``mfu_pct``.  The counts are lower bounds on real traffic.

Rows kept from the JAX model, equal to its numbers:

* ``input_read``: the uint8 frames, read once.
* ``detect_cnn``, ``mesh_cnn``, ``iris_cnn``: ``graph_traffic`` of each
  net (only the outputs of ops a fusing compiler must materialize count,
  at ``act_bytes`` per element; elementwise chains are free; weights
  once per step) and its ``graph_flops``; the iris net twice per frame.
* ``nms``: decoded boxes [N, 16] f32 written and read, the score and
  validity vectors, and the anchor table once per step.
* ``project``: the landmark rows, f32.

Rows of the card, where the JAX model counted the TPU kernels' own
copies (the VMEM-resident plane fetch, the DMA'd strips):

* ``planes_build``: the port's unpadded channel planes
  (``ops/warp.make_planes``), [3, H, W] per frame, f32 while
  ``planes_fit_vmem`` holds and bf16 beyond it, as
  ``pipeline._DetectorBase._plane_cfg`` picks them.
* ``detect_warp``: ``ops/image.separable_sample_planar`` with the shapes
  it runs on: one [Ho, H] and one [Wo, W] hat matrix per call, shared by
  the batch (counted once per step as the products read them), and per
  frame the planes read, the [3, Ho, W] intermediate written and read,
  and the [3, Ho, Wo] f32 output written.  Planes of another type than
  the products' are first copied (read, written, then read by the
  product): bf16 planes under f32 dots, f32 planes under bf16 dots.
  bf16 dots (bf16 nets above 720 px) store the intermediate as bf16 and
  widen it to f32 before the second product.  FLOPs are the two
  products, 2*M*K*N per channel.  Frame sizes that take the exact
  two-stage letterbox (int-truncated pads, such as 200x225 portraits)
  are counted as this separable warp.
* ``mesh_warp``, ``iris_warp``: the gather kernels (``warp_bilinear``,
  ``warp_bilinear_strips``).  Each writes its f32 output once and reads
  one source pixel per output pixel and channel, at most the frame's
  whole plane set; a bilinear tap reads up to four, so the row is a
  lower bound.  They are gathers on the CUDA cores, not products: their
  FLOPs count 0.

One face per frame (the bench's configuration); K faces scale the mesh
and iris rows by K.
"""

from __future__ import annotations

import numpy as np

from ..ops.warp import planes_fit_vmem
from .lowering import Graph, graph_flops

# ops whose outputs a fusing compiler still has to materialize
MATERIALIZE_OPS = {"CONV_2D", "DEPTHWISE_CONV_2D", "MAX_POOL_2D",
                   "AVERAGE_POOL_2D", "RESIZE_BILINEAR",
                   "DEPTH_TO_SPACE", "CONCATENATION", "FULLY_CONNECTED",
                   "MEAN", "BATCH_MATMUL"}


def graph_traffic(graph: Graph, act_bytes: int = 2):
    """Per-frame activation bytes + per-step weight bytes of one CNN.

    Returns ``(ideal_acts, naive_acts, weight_bytes)``: *ideal* counts
    only materialized-op inputs/outputs (fused elementwise is free),
    *naive* counts every op's activations; both per frame, weights
    once."""
    shapes = {i: t["shape"] for i, t in enumerate(graph.tensors)}

    def nbytes(tid):
        s = shapes[tid]
        return int(np.prod([d if d > 0 else 1 for d in s])) * act_bytes

    ideal = naive = weight = 0
    for node in graph.ops:
        op, ins, outs = node["op"], node["inputs"], node["outputs"]
        acts_in = sum(nbytes(i) for i in ins if i not in graph.consts)
        weight += sum(graph.consts[i].nbytes for i in ins
                      if i in graph.consts)
        out_b = sum(nbytes(o) for o in outs)
        naive += acts_in + out_b
        if op in MATERIALIZE_OPS:
            ideal += acts_in + out_b
    return ideal, naive, weight


def plane_bytes(image_size):
    """Bytes per element of the cascade's warp planes for frames of
    ``image_size`` (w, h): 4 (f32) while ``planes_fit_vmem`` holds, else
    2 (bf16)."""
    w, h = image_size
    return 4 if planes_fit_vmem(h, w) else 2


def detect_warp_cost(image_size, det_size, act_bytes=2):
    """``(bytes per frame, bytes per step, FLOPs per frame)`` of the
    whole-frame detection warp (``separable_sample_planar``) from frames
    of ``image_size`` (w, h) to the detector's ``det_size`` (w, h)."""
    w, h = image_size
    wo, ho = det_size
    pb = plane_bytes(image_size)
    planes = 3 * h * w
    t1 = 3 * ho * w                            # [3, Ho, W] intermediate
    out = 3 * ho * wo * 4
    if act_bytes == 2 and max(image_size) > 720:
        # bf16 dots: the first product reads bf16 planes and stores t1 as
        # bf16, which is widened to f32 (read 2, written 4) for the second
        dot_b, t1_b = 2, t1 * (2 + 2 + 4 + 4)
        hats = ho * h * 2 + wo * w * 4         # bf16 wy, widened wx
    else:
        dot_b, t1_b = 4, t1 * (4 + 4)
        hats = (ho * h + wo * w) * 4
    # planes of another type than the products' are copied first
    copy = planes * (pb + dot_b) if pb != dot_b else 0
    frame = copy + planes * dot_b + t1_b + out
    flops = 3 * (2 * ho * h * w + 2 * ho * w * wo)
    return frame, hats, flops


def gather_warp_bytes(image_size, out_h, out_w, n_targets):
    """Bytes per frame of one gather warp call writing ``n_targets``
    [3, out_h, out_w] f32 grids: the output, and one source pixel per
    output pixel and channel read from the planes, at most the whole
    plane set."""
    w, h = image_size
    outs = n_targets * out_h * out_w * 3
    return outs * 4 + min(outs, 3 * h * w) * plane_bytes(image_size)


def cascade_step_costs(image_size, batch, det_graph: Graph,
                       mesh_graph: Graph, iris_graph: Graph,
                       act_bytes: int = 2):
    """Modeled per-step bytes and FLOPs of one cascade call on ``batch``
    frames of ``image_size`` (w, h).

    Returns ``{stage: (bytes, flops)}`` plus a ``"total"`` row."""
    w, h = image_size
    _, det_in_h, det_in_w, _ = det_graph.input_shape
    _, mesh_h, mesh_w, _ = mesh_graph.input_shape
    _, iris_h, iris_w, _ = iris_graph.input_shape
    n_anchors = 2304 if det_in_h == 192 else 896

    costs = {}
    costs["input_read"] = (batch * h * w * 3, 0)
    costs["planes_build"] = (batch * 3 * h * w * plane_bytes(image_size),
                             0)

    frame_b, step_b, flops = detect_warp_cost(image_size,
                                              (det_in_w, det_in_h),
                                              act_bytes)
    costs["detect_warp"] = (batch * frame_b + step_b, batch * flops)

    for name, g, mul in (("detect_cnn", det_graph, 1),
                         ("mesh_cnn", mesh_graph, 1),
                         ("iris_cnn", iris_graph, 2)):
        ideal, _naive, weight = graph_traffic(g, act_bytes)
        costs[name] = (batch * ideal * mul + weight,
                       batch * graph_flops(g) * mul)

    nms_b = batch * (3 * n_anchors * 16 * 4 + 4 * n_anchors * 4) \
        + n_anchors * 4 * 4
    costs["nms"] = (nms_b, 0)

    costs["mesh_warp"] = (
        batch * gather_warp_bytes(image_size, mesh_h, mesh_w, 1), 0)
    costs["iris_warp"] = (
        batch * gather_warp_bytes(image_size, iris_h, iris_w, 2), 0)

    # landmark projection + result assembly: 468*3 + iris rows, f32
    costs["project"] = (batch * (468 * 3 + 2 * 76 * 3) * 4 * 3, 0)

    costs["total"] = (sum(b for b, _ in costs.values()),
                      sum(f for _, f in costs.values()))
    return costs


def cascade_bytes_per_frame(image_size, batch, det_graph, mesh_graph,
                            iris_graph, act_bytes: int = 2):
    """Modeled bytes per frame (total row / batch): the number the bench
    multiplies by measured frames/s for ``hbm_gbps``."""
    total_b, _ = cascade_step_costs(image_size, batch, det_graph,
                                    mesh_graph, iris_graph,
                                    act_bytes)["total"]
    return total_b / batch
