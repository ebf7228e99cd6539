"""The operations and bytes of a transformer net (the ViT embedding net)
for its roofline and its step's share of the peak, from the ``.npz``
graph's JSON alone (its tensors' shapes: no weight is read).

``costs.graph_flops``, the frozen count of the convolutional nets, counts
a FULLY_CONNECTED as one row and no BATCH_MATMUL; a ViT's products run
over every token, so here:

* CONV_2D and DEPTHWISE_CONV_2D as ``costs.graph_flops`` counts them;
* FULLY_CONNECTED: 2 x rows x out x in, the rows every input element but
  the contraction's (all the tokens; one for a flat input);
* BATCH_MATMUL: 2 x the output's elements x the contraction's length.

On a net with neither tokens nor BATCH_MATMUL (IR-ResNet's one flat FC)
the count is ``costs.graph_flops``'s.

Bytes, the least traffic of a net run product by product with each
elementwise op fused into a product (``net_bytes.graph_bytes``'s rule,
BATCH_MATMUL added): every float constant read once a call; per image
each CONV_2D's and FULLY_CONNECTED's input read once and output written
once, each BATCH_MATMUL's two inputs read once and output written once,
and each ADD of two activations (a residual) its second operand read once.
"""

import json

import numpy as np


def graph_meta(path):
    """The graph JSON of the ``.npz`` at ``path`` (its other members are
    not read)."""
    with np.load(path, allow_pickle=False) as payload:
        return json.loads(str(payload["__graph__"]))


def _op_flops(node, shapes):
    """2 x the MACs of one op on one image (0 for an op that is no
    product)."""
    op, ins, outs = node["op"], node["inputs"], node["outputs"]
    if op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
        w = shapes[ins[1]]
        per_pix = (w[0] * w[1] * w[2] * w[3] if op == "CONV_2D"
                   else w[1] * w[2] * w[3])
        return 2 * per_pix * shapes[outs[0]][1] * shapes[outs[0]][2]
    if op == "FULLY_CONNECTED":
        out_dim, in_dim = shapes[ins[1]]
        rows = int(np.prod(shapes[ins[0]])) // in_dim
        return 2 * rows * out_dim * in_dim
    if op == "BATCH_MATMUL":
        a = shapes[ins[0]]
        k = a[-2] if node["options"].get("adj_x") else a[-1]
        return 2 * int(np.prod(shapes[outs[0]])) * k
    return 0


def graph_flops(meta):
    """2 x the MACs of one image through the graph ``meta``
    (``graph_meta``'s)."""
    shapes = [t["shape"] for t in meta["tensors"]]
    return sum(_op_flops(node, shapes) for node in meta["ops"])


def graph_bytes(meta, batch, itemsize=4):
    """Bytes of one call of the graph ``meta`` (``graph_meta``'s) on
    ``batch`` images."""
    tensors = meta["tensors"]
    shapes = [t["shape"] for t in tensors]
    consumed = {i for node in meta["ops"] for i in node["inputs"]}
    made = {i for node in meta["ops"] for i in node["outputs"]}
    inputs = set(meta["inputs"])
    # constants: read by an op, made by none, no graph input
    consts = consumed - made - inputs

    def size(t):
        return int(np.prod(shapes[t][1:]))

    weights = sum(int(np.prod(shapes[t])) for t in consts
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
