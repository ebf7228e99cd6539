"""The yardstick's arithmetic: the card's peaks, the nets' operations (a
frozen copy of the program's MAC count) and the fused residual-block
kernel's operations and bytes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.  The
cascade's f32 configurations run with TF32 off: their nets' operations
are counted at the f32 rate.  A product can keep f32 accuracy on the
tensor cores as three TF32 products (split TF32, as the fused kernel's
1x1 does), so the fused kernel's bound counts its 1x1 products at a
third of the TF32 rate.
"""

import json
from pathlib import Path

import numpy as np

F32_FLOPS = 67e12
TF32_FLOPS = 495e12
F32_SPLIT_TF32_FLOPS = TF32_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": F32_FLOPS}


def graph_flops(path):
    """2 x the MACs of the convolutions and fully connected layers of one
    frame through the ``.npz`` graph at ``path`` (the count of the
    program's ``compiler.graph_flops``, batch 1)."""
    payload = np.load(path, allow_pickle=False)
    meta = json.loads(str(payload["__graph__"]))
    shapes = [t["shape"] for t in meta["tensors"]]
    total = 0
    for node in meta["ops"]:
        op, ins, outs = node["op"], node["inputs"], node["outputs"]
        if op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w = payload[f"t{ins[1]}"].shape
            per_pix = (w[0] * w[1] * w[2] * w[3] if op == "CONV_2D"
                       else w[1] * w[2] * w[3])
            total += 2 * per_pix * shapes[outs[0]][1] * shapes[outs[0]][2]
        elif op == "FULLY_CONNECTED":
            w = payload[f"t{ins[1]}"].shape
            total += 2 * w[0] * w[1]
    return total


def cascade_flops(config, root):
    """(operations of one frame's detector, of one face's mesh and two
    irises) of a cascade configuration, from its ``graphs``."""
    data = Path(root) / "tpu_face" / "data"
    g = config["graphs"]
    return (graph_flops(data / g["detector"]),
            graph_flops(data / g["mesh"]) + 2 * graph_flops(data / g["iris"]))


def fused_run_cost(c, h, w, layers, batch, itemsize=4):
    """(1x1 operations, other operations, bytes) of one run of ``layers``
    identity-skip residual blocks (3x3 depthwise, C -> C 1x1, skip add,
    ReLU) over ``batch`` activations [C, H, W]: per pixel and layer a
    multiply and an add per weight and four operations per channel (two
    biases, the add, the ReLU); the input read once, the output written
    once, and each layer's weights (9C + C + C^2 + C) read once."""
    pixels = batch * h * w
    pointwise = pixels * layers * 2 * c * c
    other = pixels * layers * (2 * 9 * c + 4 * c)
    nbytes = itemsize * (2 * pixels * c + layers * (c * c + 11 * c))
    return pointwise, other, nbytes


def fused_bound_s(runs, batch):
    """The least time one call's fused runs [(C, H, W, layers)] could take
    on the card: the largest of their 1x1 operations on the tensor cores
    at the split-TF32 rate, their other operations at the f32 rate and
    their bytes at the HBM bandwidth (the three run side by side)."""
    pointwise = other = nbytes = 0
    for c, h, w, layers in runs:
        p, o, b = fused_run_cost(c, h, w, layers, batch)
        pointwise += p
        other += o
        nbytes += b
    return max(pointwise / F32_SPLIT_TF32_FLOPS, other / F32_FLOPS,
               nbytes / HBM_BYTES_PER_S)
