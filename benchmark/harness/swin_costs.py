"""The operations and bytes of a shifted-window transformer (the Swin
embedding net) for its roofline and its step's share of the peak, from
the ``.npz`` graph's JSON alone (its tensors' shapes: no weight is read).

Operations are ``vit_costs.graph_flops``'s rule: CONV_2D as
``costs.graph_flops`` counts it, each FULLY_CONNECTED over all its rows
(every window's tokens: the graph's window-batched tensors [windows,
tokens, C] hold the windows of one image on their leading axis) and each
BATCH_MATMUL.

Bytes are ``vit_costs.graph_bytes``'s rule (every float constant read
once a call; per image each CONV_2D's and FULLY_CONNECTED's input read
and output written once, each BATCH_MATMUL's inputs read and output
written once, each ADD of two activations its second operand read once),
with an image's tensor its whole batch-1 shape: ``vit_costs`` leaves out
the leading axis, which is an image's windows here.
"""

import numpy as np

from .vit_costs import graph_flops, graph_meta  # noqa: F401


def graph_bytes(meta, batch, itemsize=4):
    """Bytes of one call of the graph ``meta`` (``graph_meta``'s) on
    ``batch`` images."""
    tensors = meta["tensors"]
    shapes = [t["shape"] for t in tensors]
    consumed = {i for node in meta["ops"] for i in node["inputs"]}
    made = {i for node in meta["ops"] for i in node["outputs"]}
    # constants: read by an op, made by none, no graph input
    consts = consumed - made - set(meta["inputs"])

    def size(t):
        return int(np.prod(shapes[t]))

    weights = sum(size(t) for t in consts
                  if tensors[t].get("dtype", "float32").startswith("float"))
    per_image = 0
    for node in meta["ops"]:
        op, ins, outs = node["op"], node["inputs"], node["outputs"]
        if op in ("CONV_2D", "FULLY_CONNECTED"):
            per_image += size(ins[0]) + size(outs[0])
        elif op == "BATCH_MATMUL":
            per_image += sum(size(i) for i in ins if i not in consts)
            per_image += size(outs[0])
        elif op == "ADD" and not set(ins) & consts:
            per_image += size(ins[1])
    return itemsize * (weights + batch * per_image)
