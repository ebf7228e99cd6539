"""The bytes a converted net must move for a batch, for the roofline of a
dense-convolution net (the embedding net): a frozen count from the
``.npz`` graph, beside ``costs.graph_flops``'s count of its operations.

The least traffic of a net run layer by layer, each elementwise op fused
into a convolution's epilogue: every float constant (weights, biases,
scales, slopes) read once a call; per image, each CONV_2D's and
FULLY_CONNECTED's input read once and output written once, and each
ADD of two activations (a residual unit's skip) its second operand read
once.
"""

import json

import numpy as np


def graph_bytes(path, batch, itemsize=4):
    """Bytes of one call of the graph at ``path`` on ``batch`` images."""
    payload = np.load(path, allow_pickle=False)
    meta = json.loads(str(payload["__graph__"]))
    shapes = [t["shape"] for t in meta["tensors"]]
    consts = {int(k[1:]) for k in payload.files if k.startswith("t")}

    def size(t):
        return int(np.prod(shapes[t][1:]))

    weights = sum(int(np.prod(shapes[t])) for t in consts
                  if meta["tensors"][t].get("dtype", "float32")
                  .startswith("float"))
    per_image = 0
    for node in meta["ops"]:
        op, ins, outs = node["op"], node["inputs"], node["outputs"]
        if op in ("CONV_2D", "FULLY_CONNECTED"):
            per_image += size(ins[0]) + size(outs[0])
        elif op == "ADD" and not set(ins) & consts:
            per_image += size(ins[1])
    return itemsize * (weights + batch * per_image)
