"""Lower a converted TFLite graph (npz) to a batched PyTorch module.

Counterpart of tpu_face/compiler/lowering.py with its whole op set: the
ops of the five detectors and the mesh and iris nets (CONV_2D,
DEPTHWISE_CONV_2D, ADD, RELU, PRELU, MAX_POOL_2D, PAD, RESHAPE,
CONCATENATION, RESIZE_BILINEAR, DEPTH_TO_SPACE) and those of the
embedding nets (FULLY_CONNECTED, BATCH_MATMUL, AVERAGE_POOL_2D, SUB, MUL,
DIV, MINIMUM, MAXIMUM, MEAN, SOFTMAX, L2_NORMALIZATION, SQRT, RSQRT,
NEG, EXP, TANH, HARD_SWISH, LOGISTIC, TRANSPOSE), and two the JAX module
lacks, which a shifted-window transformer needs: SLICE (constant begin and
size over the graph's axes, a size of -1 to the end: the halves of each
cyclic shift, joined by a CONCATENATION; the first axis is the batch,
kept whole by begin 0 with size 1 or -1, and any other cut of it raises
``NotImplementedError``) and GELU (exact, by erf, unless
its ``approximate`` option asks for the tanh form).  Any other op raises
``NotImplementedError``, as does a SAME-padded AVERAGE_POOL_2D that is
no whole-window reshape (the JAX module asserts there).
``graph_flops``, ``load_model_fn`` and ``Graph(collapse_separable=...)``
are the JAX module's too.

The graphs are NHWC; the module's body holds 4-D activations NCHW
(cuDNN's native layout) and keeps the graph's NHWC semantics at its
edges: input and outputs are NHWC, PAD specs are reordered, axes are
mapped, and the ops whose shapes or axes refer to the graph's own layout
(RESHAPE, CONCATENATION across layouts, MEAN without ``keep_dims``,
FULLY_CONNECTED, BATCH_MATMUL, TRANSPOSE) see NHWC tensors; a 4-D
result of those goes back to NCHW.  Float constants that feed an
elementwise op are module buffers in their NHWC shape, read through an
NCHW view where the other operand is NCHW.  TFLite "SAME"
padding is asymmetric for even windows (the extra row/column goes
bottom/right), so it is computed per layer and applied with ``F.pad``
where the two sides differ.

Runs of identity-skip residual blocks (3x3 depthwise, C -> C 1x1, the
skip ADD, RELU: the body of the BlazeFace detectors) are found once at
construction (``_residual_runs``) and each runs as one call of
``ops.fused_block.fused_blocks``, a hand-written CUDA kernel on the card.
In an f32 net every other dense convolution ends in one call of
``ops.conv_epilogue.conv_epilogue``, which applies its bias, the residual
ADD that follows it (the skip's channel PAD absorbed) and the activation
in one pass (``_epilogue_chains``; a hand-written CUDA kernel on the card).
In an f32 net each dense 3x3 convolution that ``ops.conv_tc.routes``
takes (stride 1 or 2, symmetric padding 0 or 1, Cin >= 64 a multiple of
32, Cout a multiple of 64: ArcFace's IR-ResNet, no bundled graph) runs as
``ops.conv_tc.conv3x3_tc``, a hand-written split-TF32 tensor-core kernel
on the card; such a net holds its 4-D activations channels_last.  A
per-channel MUL then ADD that only such a conv reads (a BatchNorm before
it: each IR-ResNet unit's first) rides in the kernel's operand load
(``_input_affine``).  In an f32 net each FULLY_CONNECTED over a token
sequence that ``ops.fc_tc.routes`` takes (``_token_fcs``:
``keep_num_dims``, more than one row a sample, K a multiple of 32, N of
64, a NONE, RELU or RELU6 activation: insightface's ViT-L's 144, no
bundled graph's, not R100's) runs as ``ops.fc_tc.fc_tc``, a hand-written
split-TF32 tensor-core kernel on the card with the FC's bias and
activation in its epilogue.

A transformer's mechanisms are recognised as ranges of ops
(``_mechanism_spans``): each attention core (the head split of q, k and
v, BATCH_MATMUL, the scale, a constant bias and a windows' mask where
they follow, SOFTMAX, BATCH_MATMUL, the head merge), each LayerNorm as
the converter decomposes it, and each window partition or reverse (the
6-D window factorisation, its TRANSPOSE and RESHAPE, with the cyclic
shifts and token-grid RESHAPEs around them).  ``forward`` runs their ops
as before, inside a ``utils.profiling`` span (``net.attention``,
``net.layer_norm``, ``net.window``), the null context unless tracing is
on; but in an f32 net each attention core that ``ops.attention_tc``
takes (``_attention_operands``: the head splits and merge over heads of
a multiple of 8 up to 96, sequences up to 144 tokens, a scalar scale, a
bias per head and a mask per window of an image, SOFTMAX with beta 1:
insightface's ViT-L's 24 and Swin-S's 24) runs inside its span as one
call of ``ops.attention_tc.attention_tc``, a hand-written kernel on the
card from the q, k and v FCs' outputs to the head merge's.  A RESHAPE
target's leading 1 is the batch and a leading -1 stays -1: the windows
of every image of the batch.

``compute_dtype=torch.bfloat16`` runs the net in bf16 as
``tpu_face.compiler.build_jax_fn(..., compute_dtype=jnp.bfloat16)`` does:
bf16 input, weights, biases and PReLU alphas, every op's output in bf16
(the convolutions accumulate in f32), outputs back in f32.
"""

import json
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention_tc, conv_epilogue, conv_tc, fc_tc, fused_block
from ..utils import profiling

# elementwise ops of two operands: {op: fn}
_BINARY = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul,
           "DIV": torch.div, "MINIMUM": torch.minimum,
           "MAXIMUM": torch.maximum}
# elementwise ops of one operand: {op: fn}
_UNARY = {
    "RELU": torch.relu, "SQRT": torch.sqrt, "RSQRT": torch.rsqrt,
    "NEG": torch.neg, "EXP": torch.exp, "TANH": torch.tanh,
    "LOGISTIC": torch.sigmoid,
    # JAX's order: x * clip(x + 3, 0, 6) / 6, each step rounded in a
    # bf16 net
    "HARD_SWISH": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
}
_SUPPORTED = (("CONV_2D", "DEPTHWISE_CONV_2D", "PRELU", "MAX_POOL_2D",
               "AVERAGE_POOL_2D", "PAD", "RESHAPE", "CONCATENATION",
               "RESIZE_BILINEAR", "DEPTH_TO_SPACE", "FULLY_CONNECTED",
               "BATCH_MATMUL", "MEAN", "SOFTMAX", "L2_NORMALIZATION",
               "TRANSPOSE", "SLICE", "GELU") + tuple(_BINARY)
              + tuple(_UNARY))

# NHWC axis -> NCHW axis
_TO_NCHW_AXIS = {0: 0, 1: 2, 2: 3, 3: 1}


class Graph:
    """A converted TFLite graph: op list + constant pool (numpy).

    ``collapse_separable`` folds DEPTHWISE(linear) -> CONV(1x1) pairs
    into one dense conv (``_collapse_separable_pairs``): False (off),
    True (every eligible pair), or a predicate ``f(ci, co, h_out) ->
    bool`` selecting pairs.  It runs after the PAD folding, as in JAX, and
    before ``TFLiteNet`` looks for residual runs: a collapsed pair has no
    depthwise left, so its block is no longer a run for the fused kernel
    (a fully collapsed BACK graph has none and runs op by op)."""

    def __init__(self, npz_path, collapse_separable=False):
        payload = np.load(npz_path, allow_pickle=False)
        meta = json.loads(str(payload["__graph__"]))
        self.inputs = meta["inputs"]
        self.outputs = meta["outputs"]
        self.tensors = meta["tensors"]
        self.consts = {int(k[1:]): payload[k] for k in payload.files
                       if k.startswith("t")}
        self.ops = _fold_pads_into_convs(meta["ops"], self.consts,
                                         set(self.outputs))
        if collapse_separable:
            pred = (collapse_separable if callable(collapse_separable)
                    else None)
            self.ops = _collapse_separable_pairs(
                self.ops, self.consts, self.tensors, set(self.outputs),
                pred)

    @property
    def input_shape(self):
        return tuple(self.tensors[self.inputs[0]]["shape"])

    @property
    def output_shapes(self):
        return [tuple(self.tensors[i]["shape"]) for i in self.outputs]


def _fold_pads_into_convs(ops, consts, graph_outputs):
    """Fold PAD ops into the convolutions that consume them.

    Zero-pad + VALID conv == conv with explicit edge padding, so the pad
    becomes a conv attribute ``[(top, bottom), (left, right)]``.  Folds
    only when every consumer is a CONV/DW with VALID padding and the pad
    touches spatial dims alone; MAX_POOL is NOT foldable (its identity
    is -inf, not 0)."""
    consumers = _consumers(ops)

    def spatial_pad(node):
        if node["op"] != "PAD" or node["inputs"][1] not in consts:
            return None
        p = np.asarray(consts[node["inputs"][1]])
        if p.shape != (4, 2) or p[0].any() or p[3].any():
            return None
        return [(int(p[1][0]), int(p[1][1])),
                (int(p[2][0]), int(p[2][1]))]

    folded = []
    for node in ops:
        pad = spatial_pad(node)
        out = node["outputs"][0] if node["outputs"] else None
        users = consumers.get(out, [])
        if (pad is not None and out not in graph_outputs and users
                and all(u["op"] in ("CONV_2D", "DEPTHWISE_CONV_2D")
                        and u["options"]["padding"] == "VALID"
                        and u["inputs"][0] == out for u in users)):
            for u in users:
                u["inputs"] = [node["inputs"][0]] + u["inputs"][1:]
                u["options"] = dict(u["options"], padding=pad)
            continue
        folded.append(node)
    return folded


def _collapse_separable_pairs(ops, consts, tensors, graph_outputs, pred):
    """Fold linear DEPTHWISE_CONV -> 1x1 CONV pairs into one dense conv
    (copy of the JAX module's).  The depthwise stage has no activation,
    so the pair composes exactly:

        K_dense[o, kh, kw, i] = PW[o, 0, 0, i] * DW[0, kh, kw, i]
        b_dense = PW[:, 0, 0, :] @ b_dw + b_pw

    Eligible: a depthwise with depth multiplier 1, activation NONE and
    dilation 1 whose output feeds exactly one later 1x1 CONV_2D (stride
    1, dilation 1) and is no graph output; ``pred(ci, co, h_out)``, if
    given, selects among them.  The product is formed in f64 and stored
    f32; the new constants get fresh tensor ids, appended to ``tensors``
    and ``consts``."""
    consumers = {}
    for idx, node in enumerate(ops):
        for t in node["inputs"]:
            consumers.setdefault(t, []).append(idx)

    def weights(node):
        ins = node["inputs"]
        b = consts[ins[2]] if len(ins) > 2 and ins[2] in consts else None
        return consts[ins[1]], b

    next_id = len(tensors)
    out = []
    skip = set()
    for idx, node in enumerate(ops):
        if idx in skip:
            continue
        if node["op"] != "DEPTHWISE_CONV_2D":
            out.append(node)
            continue
        o = node["options"]
        dw_out = node["outputs"][0]
        cons = consumers.get(dw_out, [])
        ok = (o["activation"] == "NONE"
              and list(o.get("dilation", [1, 1])) == [1, 1]
              and o.get("depth_multiplier", 1) == 1
              and dw_out not in graph_outputs
              and len(cons) == 1 and cons[0] > idx)
        nxt = ops[cons[0]] if ok else None
        if nxt is not None:
            no = nxt["options"]
            pw_w = (consts[nxt["inputs"][1]]
                    if (nxt["op"] == "CONV_2D" and len(nxt["inputs"]) > 1
                        and nxt["inputs"][1] in consts) else None)
            ok = (pw_w is not None
                  and pw_w.shape[1] == 1 and pw_w.shape[2] == 1
                  and list(no.get("stride", [1, 1])) == [1, 1]
                  and list(no.get("dilation", [1, 1])) == [1, 1]
                  and nxt["inputs"][0] == dw_out)
        if not ok:
            out.append(node)
            continue
        dw_w, dw_b = weights(node)              # [1, kh, kw, C]
        pw_w, pw_b = weights(nxt)               # [Co, 1, 1, C]
        ci, co = dw_w.shape[3], pw_w.shape[0]
        oshape = tensors[nxt["outputs"][0]]["shape"]
        if pred is not None and not pred(ci, co, oshape[1]):
            out.append(node)
            continue
        dw64 = dw_w.astype(np.float64)
        pw64 = pw_w.astype(np.float64)
        k = (pw64 * dw64[0][None]).astype(np.float32)
        b = pw64[:, 0, 0, :] @ (dw_b.astype(np.float64)
                                if dw_b is not None else np.zeros(ci))
        if pw_b is not None:
            b = b + pw_b.astype(np.float64)
        b = b.astype(np.float32)
        w_id, b_id = next_id, next_id + 1
        next_id += 2
        consts[w_id], consts[b_id] = k, b
        tensors.append({"shape": list(k.shape), "name": "sep_w"})
        tensors.append({"shape": list(b.shape), "name": "sep_b"})
        out.append({
            "op": "CONV_2D",
            "inputs": [node["inputs"][0], w_id, b_id],
            "outputs": list(nxt["outputs"]),
            "options": {"stride": list(o["stride"]),
                        "dilation": [1, 1],
                        "padding": o["padding"],
                        "activation": nxt["options"]["activation"]},
        })
        skip.add(cons[0])
    return out


def graph_flops(graph, batch: int = 1) -> int:
    """MAC-based FLOP count (2*MACs) of the conv and matmul ops, as the
    JAX module counts them."""
    shapes = {i: t["shape"] for i, t in enumerate(graph.tensors)}
    total = 0
    for node in graph.ops:
        op, ins, outs = node["op"], node["inputs"], node["outputs"]
        if op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w = graph.consts[ins[1]].shape
            oshape = shapes[outs[0]]
            # CONV weight OHWI: O*kh*kw*I MACs per output pixel;
            # DW weight [1, kh, kw, C]: kh*kw*C
            per_pix = (w[0] * w[1] * w[2] * w[3] if op == "CONV_2D"
                       else w[1] * w[2] * w[3])
            total += 2 * per_pix * oshape[1] * oshape[2]
        elif op == "FULLY_CONNECTED":
            w = graph.consts[ins[1]].shape
            total += 2 * w[0] * w[1]
    return total * batch


def _consumers(ops):
    """{tensor id: the ops that read it}."""
    users = {}
    for node in ops:
        for i in node["inputs"]:
            users.setdefault(i, []).append(node)
    return users


def _block_at(dw, users, consts, graph_outputs):
    """The identity-skip residual block that starts at DEPTHWISE_CONV_2D
    ``dw``, as {"ops": [dw, pw, add(, relu)], "input", "output", "c"},
    or None.  A block is a stride-1 3x3 depthwise (dilation 1, depth
    multiplier 1, no activation, SAME or folded (1, 1) padding) feeding
    exactly one C -> C 1x1 CONV_2D (stride 1, no activation) feeding
    exactly one ADD whose other operand is the depthwise input (either
    order), with a fused RELU or exactly one RELU after it.  No
    intermediate may be a graph output or have another consumer."""
    o = dw["options"]
    wshape = np.shape(consts.get(dw["inputs"][1]))
    if (o["stride"] != [1, 1] or list(o.get("dilation", (1, 1))) != [1, 1]
            or o.get("depth_multiplier", 1) != 1
            or o["activation"] != "NONE" or len(wshape) != 4
            or tuple(wshape[:3]) != (1, 3, 3)
            or o["padding"] not in ("SAME", [(1, 1), (1, 1)])):
        return None
    c = wshape[3]
    x = dw["inputs"][0]

    def only_user(t):
        u = users.get(t, [])
        return u[0] if len(u) == 1 and t not in graph_outputs else None

    pw = only_user(dw["outputs"][0])
    if (pw is None or pw["op"] != "CONV_2D" or pw["inputs"][0] !=
            dw["outputs"][0]):
        return None
    po = pw["options"]
    if (np.shape(consts.get(pw["inputs"][1])) != (c, 1, 1, c)
            or po["stride"] != [1, 1] or po["activation"] != "NONE"
            or po["padding"] not in ("SAME", "VALID", [(0, 0), (0, 0)])):
        return None
    add = only_user(pw["outputs"][0])
    if (add is None or add["op"] != "ADD" or len(add["inputs"]) != 2
            or sorted(add["inputs"]) != sorted([x, pw["outputs"][0]])):
        return None
    if add["options"]["activation"] == "RELU":
        return {"ops": [dw, pw, add], "input": x,
                "output": add["outputs"][0], "c": c}
    relu = only_user(add["outputs"][0])
    if (add["options"]["activation"] != "NONE" or relu is None
            or relu["op"] != "RELU"):
        return None
    return {"ops": [dw, pw, add, relu], "input": x,
            "output": relu["outputs"][0], "c": c}


def _residual_runs(ops, consts, graph_outputs):
    """Runs of identity-skip residual blocks (``_block_at``) for
    ``ops.fused_block``: consecutive blocks of the same width, each
    reading the previous block's output, where that output feeds nothing
    but the next block (its depthwise and its ADD) and is no graph
    output.  Returns a list of runs, each a list of blocks in order."""
    users = _consumers(ops)
    blocks = [b for b in (_block_at(node, users, consts, graph_outputs)
                          for node in ops
                          if node["op"] == "DEPTHWISE_CONV_2D")
              if b is not None]
    by_input = {b["input"]: b for b in blocks}
    by_output = {b["output"]: b for b in blocks}
    runs = []
    for block in blocks:
        prev = by_output.get(block["input"])
        if prev is not None and _chains(prev, block, users, graph_outputs):
            continue                # inside a run that started earlier
        run = [block]
        while (run[-1]["output"] in by_input
               and _chains(run[-1], by_input[run[-1]["output"]], users,
                           graph_outputs)):
            run.append(by_input[run[-1]["output"]])
        runs.append(run)
    return runs


def _chains(prev, block, users, graph_outputs):
    """Whether ``block`` continues a run after ``prev``: same width, and
    ``prev``'s output is read by ``block`` alone (its depthwise and its
    ADD) and is no graph output."""
    t = prev["output"]
    return (block["input"] == t and block["c"] == prev["c"]
            and t not in graph_outputs
            and {id(u) for u in users.get(t, [])}
            == {id(block["ops"][0]), id(block["ops"][2])}
            and len(users[t]) == 2)


def _epilogue_at(conv, users, producers, consts, tensors, graph_outputs):
    """The epilogue chain that starts at CONV_2D ``conv``, as {"ops":
    [conv, ...], "conv", "skip", "skip_first", "act", "alpha", "output"}
    ("skip_first": the skip is the ADD's first operand), or None where
    the conv's own activation is none of NONE, RELU, RELU6 or where the
    chain would hold the conv alone with no activation (its bias is left
    to ``F.conv2d``: with such chains, Inductor's Triton 3.6 failed to
    compile the f32 ``FaceCascade`` as an AOTInductor executable, at the
    detector heads' decode).  The chain takes, while the tensor it ends at is no graph output and has exactly
    one user: one ADD (activation NONE, RELU or RELU6) whose other operand
    is an activation of the conv output's shape, or the output of a PAD
    that only appends zero channels, has that ADD as its only user and is
    absorbed (``skip`` is then the PAD's input); then one activation, the
    conv's or the ADD's own RELU/RELU6, or a following PRELU (one alpha a
    channel) or RELU op."""
    o = conv["options"]
    if conv["op"] != "CONV_2D" or o["activation"] not in ("NONE", "RELU",
                                                          "RELU6"):
        return None
    c = np.shape(consts[conv["inputs"][1]])[0]
    chain = {"ops": [conv], "conv": conv, "skip": None, "skip_first": False,
             "act": o["activation"], "alpha": None,
             "output": conv["outputs"][0]}

    def only_user(t):
        u = users.get(t, [])
        return u[0] if len(u) == 1 and t not in graph_outputs else None

    def shape(t):
        return list(tensors[t]["shape"])

    nxt = only_user(chain["output"]) if chain["act"] == "NONE" else None
    if (nxt is not None and nxt["op"] == "ADD" and len(nxt["inputs"]) == 2
            and nxt["options"]["activation"] in ("NONE", "RELU", "RELU6")
            and nxt["inputs"].count(chain["output"]) == 1):
        (other,) = [t for t in nxt["inputs"] if t != chain["output"]]
        out_shape = shape(chain["output"])
        if (other not in consts and len(out_shape) == 4
                and shape(other) == out_shape):
            pad = producers.get(other)
            if pad is not None and pad["op"] == "PAD" and only_user(
                    other) is nxt and pad["inputs"][1] in consts:
                spec = np.asarray(consts[pad["inputs"][1]]).tolist()
                narrow = shape(pad["inputs"][0])
                if (spec[:3] == [[0, 0]] * 3 and spec[3][0] == 0
                        and spec[3][1] > 0
                        and narrow == out_shape[:3] + [c - spec[3][1]]):
                    chain["ops"].append(pad)
                    other = pad["inputs"][0]
            chain["ops"].append(nxt)
            chain.update(skip=other, act=nxt["options"]["activation"],
                         output=nxt["outputs"][0],
                         skip_first=nxt["inputs"][0] != chain["output"])
    if chain["act"] == "NONE":
        nxt = only_user(chain["output"])
        if (nxt is not None and nxt["op"] == "PRELU"
                and nxt["inputs"][1] in consts
                and np.size(consts[nxt["inputs"][1]]) == c):
            chain.update(act="PRELU", alpha=nxt["inputs"][1])
        elif nxt is not None and nxt["op"] == "RELU":
            chain["act"] = "RELU"
        else:
            return chain if len(chain["ops"]) > 1 else None
        chain["ops"].append(nxt)
        chain["output"] = nxt["outputs"][0]
    return chain


def _epilogue_chains(ops, consts, tensors, graph_outputs, taken=()):
    """The epilogue chain (``_epilogue_at``) of every CONV_2D of ``ops``
    whose position is not in ``taken`` (the ops of the residual runs) and
    whose chain holds no op of ``taken``, in op order.  An ADD whose two
    operands are both single-user convolutions (a downsampling residual
    unit: the main path's last conv and the 1x1 shortcut) would end two
    chains; it belongs to the chain of the conv later in op order, and
    the earlier conv keeps its bias in ``F.conv2d``."""
    users = _consumers(ops)
    producers = {t: node for node in ops for t in node["outputs"]}
    pos = {id(node): i for i, node in enumerate(ops)}
    chains = []
    for i, node in enumerate(ops):
        if node["op"] != "CONV_2D" or i in taken:
            continue
        chain = _epilogue_at(node, users, producers, consts, tensors,
                             graph_outputs)
        if chain is not None and not any(pos[id(n)] in taken
                                         for n in chain["ops"]):
            ends = {id(n) for n in chain["ops"][1:]}
            chains = [c for c in chains
                      if not ends & {id(n) for n in c["ops"][1:]}]
            chains.append(chain)
    return chains


def _input_affine(conv, users, producers, consts, tensors, graph_outputs):
    """The per-channel affine in front of CONV_2D ``conv`` as {"input",
    "scale", "shift", "ops": [mul, add]} (tensor ids; the MUL and the ADD),
    or None: its input is ADD(t, shift) (either order, no activation), t
    is MUL(x, scale) (the same), x an activation of t's shape, scale and
    shift float constants of one value or one a channel (every axis but
    the last of size 1), and t and the ADD's output each read by the next
    op alone and no graph output."""
    def only_user(t):
        u = users.get(t, [])
        return u[0] if len(u) == 1 and t not in graph_outputs else None

    def split(node, op):
        """(activation, constant) of a two-operand ``op`` node, or None."""
        if (node is None or node["op"] != op or len(node["inputs"]) != 2
                or node["options"].get("activation", "NONE") != "NONE"):
            return None
        a, b = node["inputs"]
        if b not in consts:
            a, b = b, a
        if a in consts or b not in consts:
            return None
        c = np.asarray(consts[b])
        if (c.dtype.kind != "f" or c.ndim > 4
                or any(d != 1 for d in c.shape[:-1])
                or c.size not in (1, channels)):
            return None
        return a, b

    channels = tensors[conv["inputs"][0]]["shape"][-1]
    add = producers.get(conv["inputs"][0])
    shifted = split(add, "ADD")
    if shifted is None or only_user(add["outputs"][0]) is not conv:
        return None
    mul = producers.get(shifted[0])
    scaled = split(mul, "MUL")
    if (scaled is None or only_user(mul["outputs"][0]) is not add
            or tensors[scaled[0]]["shape"] != tensors[shifted[0]]["shape"]):
        return None
    return {"input": scaled[0], "scale": scaled[1], "shift": shifted[1],
            "ops": [mul, add]}


# the spans ``TFLiteNet.forward`` opens around a recognised mechanism
ATTENTION, LAYER_NORM, WINDOW = "net.attention", "net.layer_norm", "net.window"
# the TRANSPOSE of a window partition and of a window reverse: [B, H/w, w,
# W/w, w, C] <-> [B, H/w, W/w, w, w, C]
WINDOW_PERM = [0, 1, 3, 2, 4, 5]


def _last_axis(node, consts, tensors):
    """Whether MEAN ``node`` reduces its input's last axis alone and keeps
    it."""
    axes = np.asarray(consts.get(node["inputs"][1], [])).reshape(-1)
    rank = len(tensors[node["inputs"][0]]["shape"])
    return (node["options"].get("keep_dims") and axes.size == 1
            and int(axes[0]) % rank == rank - 1)


def _sole_user(users, t, op, graph_outputs):
    """The one op that reads ``t`` where it is an ``op`` and ``t`` no
    graph output, else None."""
    u = users.get(t, [])
    return (u[0] if len(u) == 1 and t not in graph_outputs
            and u[0]["op"] == op else None)


def _layer_norm_at(mean, users, producers, consts, tensors, graph_outputs):
    """The ops of the LayerNorm that starts at MEAN ``mean``, as the
    converter decomposes one over the last axis: MEAN(x) -> m, SUB(x, m)
    -> d, MUL(d, d), MEAN, ADD(eps), RSQRT -> r, MUL(d, r) (either order),
    then a MUL by a constant (gamma) and an ADD of one (beta) where they
    follow; or None.  Every intermediate but d (read by its square and by
    the normalizing MUL) has one user and is no graph output."""
    def only_user(t, op):
        return _sole_user(users, t, op, graph_outputs)

    def const_operand(node):
        return (node is not None and len(node["inputs"]) == 2
                and node["options"].get("activation", "NONE") == "NONE"
                and sum(i in consts for i in node["inputs"]) == 1)

    if mean["op"] != "MEAN" or not _last_axis(mean, consts, tensors):
        return None
    x = mean["inputs"][0]
    sub = only_user(mean["outputs"][0], "SUB")
    if sub is None or sub["inputs"] != [x, mean["outputs"][0]]:
        return None
    d = sub["outputs"][0]
    # the square reads d twice: once in ``users``' list for each read
    dusers = list({id(u): u for u in users.get(d, [])}.values())
    square = [u for u in dusers if u["op"] == "MUL" and u["inputs"] == [d, d]]
    if len(dusers) != 2 or len(square) != 1 or d in graph_outputs:
        return None
    var = only_user(square[0]["outputs"][0], "MEAN")
    if var is None or not _last_axis(var, consts, tensors):
        return None
    eps = only_user(var["outputs"][0], "ADD")
    if not const_operand(eps):
        return None
    rsqrt = only_user(eps["outputs"][0], "RSQRT")
    norm = rsqrt and only_user(rsqrt["outputs"][0], "MUL")
    if (norm is None or sorted(norm["inputs"]) != sorted(
            [d, rsqrt["outputs"][0]]) or norm not in dusers):
        return None
    ops = [mean, sub, square[0], var, eps, rsqrt, norm]
    for op in ("MUL", "ADD"):
        nxt = only_user(ops[-1]["outputs"][0], op)
        if not const_operand(nxt):
            break
        ops.append(nxt)
    return ops


def _const_add(node, consts):
    """The activation operand of ``node`` where it is an ADD of it and a
    constant with no activation, else None."""
    if (node is None or node["op"] != "ADD" or len(node["inputs"]) != 2
            or node["options"].get("activation", "NONE") != "NONE"
            or sum(i in consts for i in node["inputs"]) != 1):
        return None
    return next(i for i in node["inputs"] if i not in consts)


def _attention_at(softmax, users, producers, consts, graph_outputs):
    """The ops of the attention core around SOFTMAX ``softmax``: each head
    split (a RESHAPE, then a TRANSPOSE) of q, k and v, BATCH_MATMUL(q, k),
    a MUL by a constant (the scale) where there is one, an ADD of a
    constant (a relative position bias) where there is one, a RESHAPE, an
    ADD of a constant and a RESHAPE (the shifted windows' mask) where they
    are, the SOFTMAX, BATCH_MATMUL(p, v), and the head merge (a TRANSPOSE,
    then a RESHAPE), with whether the mask is among them; or None.  Every
    intermediate has one user and is no graph output; the qkv and output
    projections are outside."""
    def only_user(t, op):
        return _sole_user(users, t, op, graph_outputs)

    def split(t):
        """The RESHAPE and TRANSPOSE that make head tensor ``t``."""
        tr = producers.get(t)
        rs = tr and producers.get(tr["inputs"][0])
        if (tr is None or tr["op"] != "TRANSPOSE" or rs is None
                or rs["op"] != "RESHAPE"
                or only_user(rs["outputs"][0], "TRANSPOSE") is not tr
                or len(users.get(t, [])) != 1 or t in graph_outputs):
            return None
        return [rs, tr]

    def feeds(node, nxt):
        """Whether ``node``'s output is read by ``nxt`` alone."""
        return (node is not None
                and only_user(node["outputs"][0], nxt["op"]) is nxt)

    ops = [softmax]
    scores = producers.get(softmax["inputs"][0])
    # the mask: RESHAPE to the windows of each image, ADD, RESHAPE back
    masked = (scores is not None and scores["op"] == "RESHAPE"
              and feeds(scores, softmax))
    if masked:
        masked = producers.get(scores["inputs"][0])
        t = _const_add(masked, consts) if feeds(masked, scores) else None
        split_w = producers.get(t)
        if (split_w is None or split_w["op"] != "RESHAPE"
                or not feeds(split_w, masked)):
            return None
        ops[:0] = [split_w, masked, scores]
        scores = producers.get(split_w["inputs"][0])
    # the bias
    t = _const_add(scores, consts) if feeds(scores, ops[0]) else None
    if t is not None:
        ops.insert(0, scores)
        scores = producers.get(t)
    if (scores is not None and scores["op"] == "MUL"
            and feeds(scores, ops[0])):
        ops.insert(0, scores)
        scores = producers.get(next(
            (i for i in scores["inputs"] if i in producers), None))
    if (scores is None or scores["op"] != "BATCH_MATMUL"
            or len(users.get(scores["outputs"][0], [])) != 1):
        return None
    context = only_user(softmax["outputs"][0], "BATCH_MATMUL")
    if context is None or context["inputs"][0] != softmax["outputs"][0]:
        return None
    merge = only_user(context["outputs"][0], "TRANSPOSE")
    flat = merge and only_user(merge["outputs"][0], "RESHAPE")
    heads = [split(t) for t in (*scores["inputs"], context["inputs"][1])]
    if flat is None or None in heads:
        return None
    return ([n for h in heads for n in h] + [scores] + ops
            + [context, merge, flat], masked)


def _attention_operands(ops, consts, tensors, dtype):
    """The record of ``ops.attention_tc`` for the attention core whose ops
    are ``ops`` (the op range of a core ``_attention_at`` found) in a net
    computing in ``dtype``: {"q", "k", "v" (the tensors the head splits
    read), "output" (the head merge's), "heads", "scale", "bias", "mask"
    (the constants' ids, or None)}; or None where the kernel does not take
    the core (``attention_tc.routes``) or the core has another form than
    the kernel computes: the head splits and the merge over [., N, heads,
    d] with perm (0, 2, 1, 3), the first product q . k^T (``adj_y``), a
    one-element scale, a bias [heads, N, N], a mask [1, nW, 1, N, N] over
    each image's nW windows, SOFTMAX with beta 1, every target's leading
    axis the batch (1) or the windows (-1)."""
    producers = {t: node for node in ops for t in node["outputs"]}
    users = _consumers(ops)

    def const(i):
        return (np.asarray(consts[i]).reshape(-1).tolist() if i in consts
                else None)

    def target(rs, dims):
        """Whether RESHAPE ``rs``'s target is [1 or -1, *dims]."""
        tgt = list(rs["options"].get("new_shape") or const(rs["inputs"][1])
                   or [])
        return tgt[:1] in ([1], [-1]) and tgt[1:] == list(dims)

    softmax = next(n for n in ops if n["op"] == "SOFTMAX")
    context = users[softmax["outputs"][0]][0]
    node = producers[softmax["inputs"][0]]
    chain = [softmax]
    while node["op"] != "BATCH_MATMUL":
        chain.insert(0, node)
        node = producers[next(i for i in node["inputs"] if i in producers)]
    scores = node

    def head(t):
        """(the tensor head split ``t`` reads, [N, heads, d]) or None."""
        tr = producers[t]
        rs = producers[tr["inputs"][0]]
        shape = tensors[rs["outputs"][0]]["shape"][1:]
        if const(tr["inputs"][1]) != [0, 2, 1, 3] or not target(rs, shape):
            return None
        return rs["inputs"][0], shape

    split = [head(t) for t in (*scores["inputs"], context["inputs"][1])]
    if (None in split or any(s[1] != split[0][1] for s in split)
            or scores["options"].get("adj_x")
            or not scores["options"].get("adj_y")
            or context["options"].get("adj_x")
            or context["options"].get("adj_y")
            or softmax["options"].get("beta", 1.0) != 1.0):
        return None
    n, heads, d = split[0][1]
    merge = users[context["outputs"][0]][0]
    flat = users[merge["outputs"][0]][0]
    if (const(merge["inputs"][1]) != [0, 2, 1, 3]
            or not target(flat, [n, heads * d])):
        return None
    rec = {"q": split[0][0], "k": split[1][0], "v": split[2][0],
           "output": flat["outputs"][0], "heads": heads, "scale": None,
           "bias": None, "mask": None}
    # the ops between the products: [MUL] [ADD] [RESHAPE ADD RESHAPE]
    # (``_attention_at``), each ADD's constant padded to 5-D
    prev = scores
    for k, node in enumerate(chain[:-1]):
        c = next((i for i in node["inputs"] if i in consts), None)
        if c is None and node["op"] != "RESHAPE":
            return None
        shape = [1] * 5 + list(np.shape(consts.get(c)))
        if node["op"] == "MUL" and prev is scores and np.size(consts[c]) == 1:
            rec["scale"] = c
        elif node["op"] == "ADD" and prev["op"] != "RESHAPE":
            if shape[-4:] != [1, heads, n, n]:
                return None
            rec["bias"] = c
        elif node["op"] == "ADD":
            nw = shape[-4]
            if (shape[-5:] != [1, nw, 1, n, n]
                    or not target(prev, [nw, heads, n, n])
                    or not target(chain[k + 1], [heads, n, n])):
                return None
            rec["mask"] = c
        elif node["op"] != "RESHAPE":
            return None
        prev = node
    tables = (rec["bias"] is not None) + (rec["mask"] is not None)
    return rec if attention_tc.routes(n, heads, d, dtype, tables) else None


def _roll_before(t, users, producers, consts, graph_outputs):
    """The ops of the cyclic shift along one axis that makes ``t``: a
    CONCATENATION of two SLICEs of one tensor, each read by it alone; or
    None."""
    cat = producers.get(t)
    if (cat is None or cat["op"] != "CONCATENATION"
            or len(cat["inputs"]) != 2):
        return None
    parts = [producers.get(i) for i in cat["inputs"]]
    if (any(p is None or p["op"] != "SLICE"
            or _sole_user(users, p["outputs"][0], "CONCATENATION",
                          graph_outputs) is not cat for p in parts)
            or parts[0]["inputs"][0] != parts[1]["inputs"][0]
            or not all(i in consts for p in parts for i in p["inputs"][1:])):
        return None
    return parts + [cat]


def _window_at(transpose, users, producers, consts, tensors, graph_outputs):
    """The ops of the window partition or reverse around TRANSPOSE
    ``transpose`` (``WINDOW_PERM`` of a 6-D RESHAPE's output, read by a
    RESHAPE): before it the cyclic shifts (``_roll_before``) and a RESHAPE
    that feed it, after it those it feeds, each intermediate read by the
    next op alone and no graph output; or None."""
    def only_user(t, op):
        return _sole_user(users, t, op, graph_outputs)

    perm = np.asarray(consts.get(transpose["inputs"][1], [])).reshape(-1)
    grid = producers.get(transpose["inputs"][0])
    if (perm.tolist() != WINDOW_PERM or grid is None
            or grid["op"] != "RESHAPE"
            or len(tensors[grid["outputs"][0]]["shape"]) != 6
            or only_user(grid["outputs"][0], "TRANSPOSE") is not transpose):
        return None
    flat = only_user(transpose["outputs"][0], "RESHAPE")
    if flat is None:
        return None
    ops = [grid, transpose, flat]

    def read_by(t, group):
        """Whether ``t`` is read by ops of ``group`` alone."""
        u = users.get(t, [])
        return (bool(u) and t not in graph_outputs
                and {id(n) for n in u} <= {id(n) for n in group})

    head = [grid]                   # the shifts and the RESHAPE before
    while read_by(head[0]["inputs"][0], head):
        t = head[0]["inputs"][0]
        roll = _roll_before(t, users, producers, consts, graph_outputs)
        if roll is None:
            rs = producers.get(t)
            if rs is not None and rs["op"] == "RESHAPE":
                ops.insert(0, rs)
            break
        ops[:0] = roll
        head = roll[:2]
    while True:                     # the shifts and the RESHAPE after
        u = users.get(ops[-1]["outputs"][0], [])
        cat = (len(u) == 2 and all(n["op"] == "SLICE" for n in u)
               and only_user(u[0]["outputs"][0], "CONCATENATION"))
        roll = cat and _roll_before(cat["outputs"][0], users, producers,
                                    consts, graph_outputs)
        if (not roll or ops[-1]["outputs"][0] in graph_outputs
                or {id(n) for n in roll[:2]} != {id(n) for n in u}):
            break
        ops += roll
    rs = only_user(ops[-1]["outputs"][0], "RESHAPE")
    if rs is not None:
        ops.append(rs)
    return ops


def _mechanism_spans(ops, consts, tensors, graph_outputs, taken=()):
    """{first op position: (span name, last op position)} of each attention
    core (``_attention_at``: ``ATTENTION``), each LayerNorm
    (``_layer_norm_at``: ``LAYER_NORM``) and each window partition or
    reverse (``_window_at``: ``WINDOW``) of ``ops`` whose ops are one
    unbroken range of positions, none of them in ``taken`` (the ops that
    run elsewhere than they stand: in a residual run, an epilogue chain or
    a convolution's operand load); and the set of the first op positions
    of those attention cores that add a mask."""
    users = _consumers(ops)
    producers = {t: node for node in ops for t in node["outputs"]}
    pos = {id(node): i for i, node in enumerate(ops)}
    taken = set(taken)
    spans, masked = {}, set()
    for node in ops:
        mask = False
        if node["op"] == "MEAN":
            found = _layer_norm_at(node, users, producers, consts, tensors,
                                   graph_outputs)
            name = LAYER_NORM
        elif node["op"] == "SOFTMAX":
            found, mask = _attention_at(node, users, producers, consts,
                                        graph_outputs) or (None, False)
            name = ATTENTION
        elif node["op"] == "TRANSPOSE":
            found = _window_at(node, users, producers, consts, tensors,
                               graph_outputs)
            name = WINDOW
        else:
            continue
        at = sorted(pos[id(n)] for n in found or ())
        if at and at[-1] - at[0] + 1 == len(at) and not taken.intersection(at):
            spans[at[0]] = (name, at[-1])
            if mask:
                masked.add(at[0])
    return spans, masked


def _token_fcs(ops, consts, tensors, dtype):
    """The op positions of the FULLY_CONNECTED ops that ``fc_tc.routes``
    sends to the kernel in a net computing in ``dtype``: by the weights'
    shape, the input's shape in the graph, ``keep_num_dims`` and the
    fused activation."""
    out = []
    for i, node in enumerate(ops):
        if node["op"] != "FULLY_CONNECTED":
            continue
        o, ins = node["options"], node["inputs"]
        if fc_tc.routes(np.shape(consts.get(ins[1])),
                        tensors[ins[0]]["shape"], o.get("keep_num_dims"),
                        o["activation"], dtype):
            out.append(i)
    return out


def _dead_after(ops, graph_outputs, executed_at):
    """{op position: [tensor ids]}: each tensor an op reads, under the
    last position at which it is read (an op computed elsewhere than it
    stands, ``executed_at``, reads its inputs at the later of the two),
    graph outputs left out."""
    last = {}
    for i, node in enumerate(ops):
        at = max(i, executed_at.get(i, i))
        for t in node["inputs"]:
            last[t] = max(last.get(t, at), at)
    dead = {}
    for t, at in last.items():
        if t not in graph_outputs:
            dead.setdefault(at, []).append(t)
    return dead


def params_from_consts(ops, consts):
    """The graph's float constants as the module's tensors: conv weights
    OHWI -> OIHW, depthwise ``[1, kh, kw, C]`` -> ``[C, 1, kh, kw]``
    (``groups=C``), PReLU alpha -> ``[1, C, 1, 1]``, conv biases and
    FULLY_CONNECTED weights ``[out, in]`` and biases as they are, all
    keyed ``"t<id>"``; every other float constant an op reads (an operand
    of an elementwise op, of BATCH_MATMUL or CONCATENATION) in its own
    NHWC shape, keyed ``"c<id>"``.  f16 constants are upcast to f32, as
    ``tpu_face.compiler.build_jax_fn`` does.  Integer constants (PAD
    specs, shapes, axes) stay numpy: the module reads them as static
    values."""

    def f32(i):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(consts[i]).astype(np.float32)))

    params = {}
    for node in ops:
        op, ins = node["op"], node["inputs"]
        if op in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
            w = f32(ins[1])
            if op == "CONV_2D":
                w = w.permute(0, 3, 1, 2).contiguous()
            elif op == "DEPTHWISE_CONV_2D":
                w = w.permute(3, 0, 1, 2).contiguous()
            params[f"t{ins[1]}"] = w
            if len(ins) > 2 and ins[2] >= 0:
                params[f"t{ins[2]}"] = f32(ins[2])
        elif op == "PRELU":
            params[f"t{ins[1]}"] = f32(ins[1]).reshape(1, -1, 1, 1)
        else:
            for i in ins:
                if i in consts and np.issubdtype(np.asarray(consts[i]).dtype,
                                                 np.floating):
                    params[f"c{i}"] = f32(i)
    return params


def _stack_run(run, params):
    """A run's weights stacked for ``fused_block.fused_blocks``:
    wd [L, C, 3, 3], bd [L, C], wp [L, C_out, C_in], bp [L, C] (a
    missing bias is zeros)."""

    def bias(node, c):
        ins = node["inputs"]
        if len(ins) > 2 and ins[2] >= 0:
            return params[f"t{ins[2]}"]
        w = params[f"t{ins[1]}"]
        return torch.zeros(c, dtype=w.dtype, device=w.device)

    c = run[0]["c"]
    dws = [b["ops"][0] for b in run]
    pws = [b["ops"][1] for b in run]
    return {
        "wd": torch.stack([params[f"t{n['inputs'][1]}"][:, 0] for n in dws]),
        "bd": torch.stack([bias(n, c) for n in dws]),
        "wp": torch.stack([params[f"t{n['inputs'][1]}"][:, :, 0, 0]
                           for n in pws]),
        "bp": torch.stack([bias(n, c) for n in pws]),
    }


def _act(x, kind):
    if kind == "NONE":
        return x
    if kind == "RELU":
        return torch.relu(x)
    if kind == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
    if kind == "RELU_N1_TO_1":
        return torch.clamp(x, -1.0, 1.0)
    if kind == "TANH":
        return torch.tanh(x)
    raise NotImplementedError(f"activation {kind}")


def _mean(x, dims, keepdim):
    """Mean over ``dims``, summed in f32 and rounded once to ``x``'s type
    (JAX upcasts a bf16 mean the same way)."""
    return x.mean(dim=tuple(dims), keepdim=keepdim,
                  dtype=torch.float32).to(x.dtype)


def _prelu(x, alpha):
    """Per-channel PReLU in the JAX package's form, max + alpha*min."""
    return torch.clamp(x, min=0) + alpha * torch.clamp(x, max=0)


def _resize_bilinear(x, out_hw, align_corners, half_pixel_centers):
    """TFLite RESIZE_BILINEAR of NCHW ``x`` to ``out_hw``, in f32 with the
    JAX module's coordinates and order of operations: row gathers first,
    then column gathers on the two row sets, edges clamped to the last
    row/column (not ``F.interpolate``, whose edge rule differs)."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    dev = x.device
    if half_pixel_centers:
        ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * (
            h / oh) - 0.5
        xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * (
            w / ow) - 0.5
    elif align_corners and oh > 1 and ow > 1:
        ys = torch.arange(oh, dtype=torch.float32, device=dev) * (
            (h - 1) / (oh - 1))
        xs = torch.arange(ow, dtype=torch.float32, device=dev) * (
            (w - 1) / (ow - 1))
    else:
        ys = torch.arange(oh, dtype=torch.float32, device=dev) * (h / oh)
        xs = torch.arange(ow, dtype=torch.float32, device=dev) * (w / ow)
    y0 = torch.floor(ys).clamp(0, h - 1).long()
    x0 = torch.floor(xs).clamp(0, w - 1).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0.float()).clamp(0.0, 1.0)[:, None]
    wx = (xs - x0.float()).clamp(0.0, 1.0)
    x = x.float()
    ty0 = x[:, :, y0]
    ty1 = x[:, :, y1]
    top = ty0[..., x0] * (1 - wx) + ty0[..., x1] * wx
    bot = ty1[..., x0] * (1 - wx) + ty1[..., x1] * wx
    return top * (1 - wy) + bot * wy


def _depth_to_space(x, block):
    """TFLite DEPTH_TO_SPACE of NCHW ``x``: NHWC channel
    ``(i * block + j) * C' + k`` goes to row offset i, column offset j,
    channel k, as the JAX module's reshape and transpose order it."""
    n, c, h, w = x.shape
    cc = c // (block * block)
    x = x.reshape(n, block, block, cc, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, cc, h * block, w * block)


def _same_pads(size, k, stride, dilation):
    """TFLite/XLA "SAME": ceil(size/stride) outputs, the odd padding
    row/column on the high side."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _window_pads(padding, hw, kernel, stride, dilation):
    """((top, bottom), (left, right)) for a VALID / SAME / folded-list
    padding option."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tuple(_same_pads(hw[d], kernel[d], stride[d], dilation[d])
                     for d in range(2))
    return tuple(tuple(p) for p in padding)


class TFLiteNet(nn.Module):
    """``forward(x: [B, H, W, C]) -> tuple(outputs)`` of a TFLite graph,
    batched over the leading axis, outputs in the graph's own NHWC
    shapes with the batch in place of the graph's leading 1, in f32.

    ``params`` defaults to ``params_from_consts(graph.ops,
    graph.consts)``; the weights are buffers, so ``.to(device)`` moves
    them.

    With ``fuse_blocks`` (the default) every run of identity-skip
    residual blocks (``_residual_runs``) goes to
    ``ops.fused_block.fused_blocks`` as one call, with the run's weights
    stacked from ``params``: the CUDA kernel on the card, the same per-op
    arithmetic on the CPU.  Each run's weights are also kept in the form
    its kernel reads (``fused_block.kernel_weights``, buffers
    ``run<k>_kernel<i>``) and its tiling planned (``run_tilings``), both
    once, here.  ``fuse_blocks=False`` runs them op by op.

    ``compute_dtype`` is float32 or bfloat16.  In bf16 the input and
    every float constant are cast to bf16 and every op computes in bf16;
    a convolution's bias is added after it as a separate bf16 op, so the
    sum is rounded twice, as in JAX (``F.conv2d`` with the bias would
    round once on some backends and twice on others).  The residual runs
    get bf16 activations: the kernel's bf16 entry point on the card.  The
    f32 path is unchanged by the option.

    With ``fuse_epilogues`` (the default) an f32 net runs each chain that
    starts at a CONV_2D outside the residual runs (``_epilogue_chains``:
    the conv's bias, a residual ADD whose skip may be a channel PAD, an
    activation) as the convolution without its bias and one call of
    ``ops.conv_epilogue.conv_epilogue``: the CUDA kernel on the card,
    equal bit for bit to the op-by-op sequence there; on the CPU the same
    ops, the bias added after the convolution (oneDNN adds it inside, so
    the two paths differ there by the bias add's f32 rounding).  The
    chain runs where its last op stands.  ``epilogue_counts`` counts the
    graph ops the chains hold, by op (``CONV_2D``: the chains).  A bf16
    net has no chains (its double roundings are the JAX package's), and
    ``fuse_epilogues=False`` runs them op by op.

    In an f32 net every CONV_2D that ``ops.conv_tc.routes`` takes (by its
    weights' shape, its input's channels, stride, dilation and padding
    after the PAD folding) runs as ``ops.conv_tc.conv3x3_tc``: the
    split-TF32 kernel on the card, on its weights split here, once, into
    the kernel's hi and lo buffers (``tc<k>_hi``, ``tc<k>_lo``);
    ``F.conv2d`` on the CPU.  Where such a conv's input is a per-channel
    MUL then ADD that it alone reads (``_input_affine``: a BatchNorm in
    front of a zero-padded conv, which cannot fold into its weights), the
    conv reads the MUL's input and takes the two constants (buffers
    ``tc<k>_scale``, ``tc<k>_shift``, Cin each) into the kernel's operand
    load, bit-equal to the two ops on the card; the MUL and the ADD do not
    run.  ``tc_convs`` maps the routed convs' op positions to their
    records {"k", "input" (the tensor the conv reads), "affine" (the
    absorbed MUL's and ADD's op positions, or None)}.  A net with one
    holds every 4-D activation channels_last, the kernel's layout (the
    NHWC input's NCHW view already is); every other net keeps the layouts
    its ops give.

    In an f32 net every FULLY_CONNECTED that ``ops.fc_tc.routes`` takes
    (``_token_fcs``: by its weights' shape, its input's shape in the
    graph, ``keep_num_dims`` and its fused activation) runs as
    ``ops.fc_tc.fc_tc`` with its bias and activation: the split-TF32
    kernel on the card, on its weights split here, once, into the kernel's
    hi and lo buffers (``fc<k>_hi``, ``fc<k>_lo``); ``F.linear``, the bias
    and the activation as ops on the CPU.  ``tc_fcs`` maps the routed FCs'
    op positions to their records {"k"} (ViT-L: 144; R100 and every
    bundled net: none); every other FC stays on ``torch.matmul``.  Each
    RESHAPE's output is row-major, the kernel's layout (the tokens of a
    patch conv's NCHW output are otherwise a strided view that every op
    after it keeps).

    ``forward`` drops each activation once the last op that reads it has
    run (``_dead_after``; a run, a chain or an absorbed affine reads where
    it runs), so a call, and the pool of a graph captured from it, holds
    the live activations, not every one of the call.

    ``attention_cores``, ``layer_norms`` and ``window_ops`` list the
    (first, last) op positions of each attention core, LayerNorm and window
    partition or reverse ``_mechanism_spans`` recognises (insightface's
    ViT-L: 24, 49 and 0; Swin-S: 24, 53 and 48; no bundled net and no
    IR-ResNet has one); ``masked_cores`` those of the cores that add a
    shifted windows' mask (Swin-S: 11).  ``forward`` opens the span
    ``net.attention``, ``net.layer_norm`` or ``net.window`` around each,
    and their ops compute as any other, but those of an attention core in
    ``tc_cores``: {first op position: {"q", "k", "v", "output" (tensor
    ids), "heads", "scale", "bias", "mask" (constant ids or None), "last"
    (the last op position)}} of each core that ``_attention_operands``
    sends to ``ops.attention_tc`` (an f32 net's; ViT-L: 24, Swin-S: 24,
    11 with a mask; R100 and every bundled net: none), which runs as one
    call of ``attention_tc.attention_tc`` where its first op stands: the
    kernel on the card, the same ATen ops in the graph's order on the
    CPU."""

    def __init__(self, graph, params=None, fuse_blocks=True,
                 compute_dtype=torch.float32, fuse_epilogues=True):
        super().__init__()
        for node in graph.ops:
            if node["op"] not in _SUPPORTED:
                raise NotImplementedError(f"op {node['op']}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"compute_dtype {compute_dtype} (float32 and bfloat16 are "
                f"ported)")
        self.compute_dtype = compute_dtype
        if params is None:
            params = params_from_consts(graph.ops, graph.consts)
        params = {k: v.to(compute_dtype) for k, v in params.items()}
        for name, value in params.items():
            self.register_buffer(name, value)
        self.ops = graph.ops
        self.consts = graph.consts
        self.inputs = graph.inputs
        self.outputs = graph.outputs
        self.runs = (_residual_runs(graph.ops, graph.consts,
                                    set(graph.outputs))
                     if fuse_blocks else [])
        # op index -> run index for each run's first op; indices of the
        # others (positions, not object ids: torch.export swaps the
        # module's containers for copies while it traces)
        pos = {id(node): i for i, node in enumerate(graph.ops)}
        self._run_start = {pos[id(run[0]["ops"][0])]: k
                           for k, run in enumerate(self.runs)}
        self._in_run = {pos[id(node)] for run in self.runs for b in run
                        for node in b["ops"][1:]} | {
            pos[id(b["ops"][0])] for run in self.runs for b in run[1:]}
        # (C, H, W, layers) of each run, from the graph's tensor shapes
        self.run_shapes = [
            (run[0]["c"], *graph.tensors[run[0]["input"]]["shape"][1:3],
             len(run)) for run in self.runs]
        itemsize = torch.finfo(compute_dtype).bits // 8
        # each run's tiling, planned once for the net's activations
        self.run_tilings = [fused_block.plan(c, h, w, layers, itemsize)
                            for c, h, w, layers in self.run_shapes]
        taken = self._in_run | set(self._run_start)
        self.chains = (_epilogue_chains(graph.ops, graph.consts,
                                        graph.tensors, set(graph.outputs),
                                        taken)
                       if fuse_epilogues and compute_dtype == torch.float32
                       else [])
        # op index -> chain index for each chain's last op; indices of the
        # others
        self._chain_end = {max(pos[id(n)] for n in chain["ops"]): k
                           for k, chain in enumerate(self.chains)}
        self._in_chain = {pos[id(n)] for chain in self.chains
                          for n in chain["ops"]} - set(self._chain_end)
        self.epilogue_counts = {}
        for chain in self.chains:
            for n in chain["ops"]:
                self.epilogue_counts[n["op"]] = (
                    self.epilogue_counts.get(n["op"], 0) + 1)
        # each chain's convolution's op position
        self._chain_conv = [pos[id(chain["conv"])] for chain in self.chains]
        # op position -> record for each convolution on conv_tc, its
        # weights split into the buffers tc<k>_hi and tc<k>_lo
        self.tc_convs = {}
        users = _consumers(graph.ops)
        producers = {t: node for node in graph.ops for t in node["outputs"]}
        chained = self._in_chain | set(self._chain_end)
        for i, node in enumerate(graph.ops):
            if node["op"] != "CONV_2D" or i in taken:
                continue
            o, ins = node["options"], node["inputs"]
            wshape = np.shape(graph.consts.get(ins[1]))
            xshape = graph.tensors[ins[0]]["shape"]
            if (len(wshape) == 4 and len(xshape) == 4 and conv_tc.routes(
                    wshape, xshape[3], o["stride"], o.get("dilation", (1, 1)),
                    _window_pads(o["padding"], xshape[1:3], wshape[1:3],
                                 o["stride"], o.get("dilation", (1, 1))),
                    compute_dtype)):
                k = len(self.tc_convs)
                hi, lo = conv_tc.kernel_weights(params[f"t{ins[1]}"])
                self.register_buffer(f"tc{k}_hi", hi)
                self.register_buffer(f"tc{k}_lo", lo)
                rec = self.tc_convs[i] = {"k": k, "input": ins[0],
                                          "affine": None}
                aff = _input_affine(node, users, producers, graph.consts,
                                    graph.tensors, set(graph.outputs))
                at = aff and tuple(pos[id(n)] for n in aff["ops"])
                if at and not set(at) & (taken | chained):
                    rec.update(input=aff["input"], affine=at)
                    for name in ("scale", "shift"):
                        self.register_buffer(
                            f"tc{k}_{name}", torch.broadcast_to(
                                params[f"c{aff[name]}"].reshape(-1),
                                (xshape[3],)).contiguous())
        # op position -> record for each FULLY_CONNECTED on fc_tc, its
        # weights split into the buffers fc<k>_hi and fc<k>_lo
        self.tc_fcs = {}
        for k, i in enumerate(_token_fcs(graph.ops, graph.consts,
                                         graph.tensors, compute_dtype)):
            hi, lo = fc_tc.kernel_weights(
                params[f"t{graph.ops[i]['inputs'][1]}"])
            self.register_buffer(f"fc{k}_hi", hi)
            self.register_buffer(f"fc{k}_lo", lo)
            self.tc_fcs[i] = {"k": k}
        # op positions forward skips: inside a run or a chain (each runs
        # where its first or its last op stands), or absorbed by a conv
        self._skip = self._in_run | self._in_chain | {
            j for rec in self.tc_convs.values() for j in rec["affine"] or ()}
        # op position -> (span name, last op position) of each recognised
        # attention core, LayerNorm and window partition or reverse, for
        # the spans forward opens
        self._spans, masked = _mechanism_spans(
            graph.ops, graph.consts, graph.tensors, set(graph.outputs),
            self._skip | set(self._chain_end) | set(self._run_start))
        self.attention_cores, self.layer_norms, self.window_ops = (
            [(a, b) for a, (name, b) in sorted(self._spans.items())
             if name == kind] for kind in (ATTENTION, LAYER_NORM, WINDOW))
        self.masked_cores = [(a, b) for a, b in self.attention_cores
                             if a in masked]
        # first op position -> record of each attention core on
        # attention_tc, which runs where its first op stands
        self.tc_cores = {}
        for a, b in self.attention_cores:
            rec = _attention_operands(graph.ops[a:b + 1], graph.consts,
                                      graph.tensors, compute_dtype)
            if rec is not None:
                self.tc_cores[a] = dict(rec, last=b)
                self._skip |= set(range(a + 1, b + 1))
        # op position -> the activations that no op after it reads, which
        # forward drops once it is done: a call holds what is live, not
        # every activation (a captured graph's pool likewise)
        self._dead_after = _dead_after(
            graph.ops, set(graph.outputs), self._executed_at(pos))
        self._run_weights = []   # names of each run's kernel-ready buffers
        for k, run in enumerate(self.runs):
            stacked = _stack_run(run, params)
            for name, value in stacked.items():
                self.register_buffer(f"run{k}_{name}", value)
            names = []
            for i, value in enumerate(fused_block.kernel_weights(
                    **stacked, dtype=compute_dtype)):
                names.append(f"run{k}_kernel{i}")
                self.register_buffer(names[-1], value)
            self._run_weights.append(names)

    def _executed_at(self, pos):
        """{op position: the position where forward computes it} of the
        ops that do not run where they stand: a residual run's at its
        first op, an epilogue chain's at its last, an affine absorbed by a
        routed conv where that conv runs, a routed attention core's at its
        first op."""
        at = {}
        for run in self.runs:
            start = pos[id(run[0]["ops"][0])]
            at.update({pos[id(n)]: start for b in run for n in b["ops"]})
        for end, k in self._chain_end.items():
            at.update({pos[id(n)]: end for n in self.chains[k]["ops"]})
        for i, rec in self.tc_convs.items():
            at.update({j: at.get(i, i) for j in rec["affine"] or ()})
        for a, rec in self.tc_cores.items():
            at.update({j: a for j in range(a, rec["last"] + 1)})
        return at

    def fused_launches(self, itemsize=None) -> int:
        """Kernel launches of one ``forward`` on the card: those the
        wrapper's tiling plan makes for each run at activations of
        ``itemsize`` bytes (default: the net's compute dtype's, 2 for a
        bf16 net, whose tilings were planned at construction)."""
        if itemsize is None:
            return sum(len(chunks) for _, chunks in self.run_tilings)
        return sum(len(fused_block.plan(c, h, w, layers, itemsize)[1])
                   for c, h, w, layers in self.run_shapes)

    def _run(self, k, x):
        return fused_block.fused_blocks(
            x, *(getattr(self, f"run{k}_{n}") for n in ("wd", "bd", "wp",
                                                        "bp")),
            tiling=self.run_tilings[k],
            weights=tuple(getattr(self, n) for n in self._run_weights[k]))

    def _bias(self, node):
        ins = node["inputs"]
        return (getattr(self, f"t{ins[2]}")
                if len(ins) > 2 and ins[2] >= 0 else None)

    def _chain(self, k, env):
        """Chain ``k``'s output: its convolution without the bias, then
        its epilogue.  Its skip is 4-D, so ``env`` holds it NCHW, as
        every 4-D activation."""
        chain = self.chains[k]
        conv = chain["conv"]
        y = self._conv(env, conv, False, epilogue=True,
                       pos=self._chain_conv[k])
        return conv_epilogue.conv_epilogue(
            y, self._bias(conv),
            None if chain["skip"] is None else env[chain["skip"]],
            None if chain["alpha"] is None else getattr(
                self, f"t{chain['alpha']}"), chain["act"],
            chain["skip_first"])

    def _conv(self, env, node, depthwise, epilogue=False, pos=None):
        """The convolution ``node`` (at op position ``pos``) of its NCHW
        input in ``env`` (through its absorbed affine where it has one)
        with its bias and activation, or (``epilogue``) without either, for
        its chain's epilogue."""
        o, ins = node["options"], node["inputs"]
        rec = self.tc_convs.get(pos)
        x = env[ins[0] if rec is None else rec["input"]]
        scale = shift = None
        if rec is not None and rec["affine"] is not None:
            scale = getattr(self, f"tc{rec['k']}_scale")
            shift = getattr(self, f"tc{rec['k']}_shift")
        w = getattr(self, f"t{ins[1]}")
        b = None if epilogue else self._bias(node)
        stride = tuple(o["stride"])
        dilation = tuple(o.get("dilation", (1, 1)))
        (pt, pb), (pl, pr) = _window_pads(o["padding"], x.shape[2:],
                                          w.shape[2:], stride, dilation)
        # a SAME padding's pads follow the input's size: where they come
        # out uneven (a stride-2 conv on an even size), F.conv2d takes it,
        # after the affine as its two ops
        if rec is not None and pt == pb == pl == pr:
            k = rec["k"]
            y = conv_tc.conv3x3_tc(x, w, getattr(self, f"tc{k}_hi"),
                                   getattr(self, f"tc{k}_lo"), stride[0], pt,
                                   scale, shift)
            if b is not None:
                y = y + b[:, None, None]
            return y if epilogue else _act(y, o["activation"])
        if scale is not None:
            x = x * scale[:, None, None] + shift[:, None, None]
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            pad = (0, 0)
        bf16 = self.compute_dtype == torch.bfloat16
        y = F.conv2d(x, w, None if bf16 else b, stride=stride, padding=pad,
                     dilation=dilation,
                     groups=x.shape[1] if depthwise else 1)
        if bf16 and b is not None:
            y = y + b[:, None, None]
        return y if epilogue else _act(y, o["activation"])

    @staticmethod
    def _max_pool(x, o):
        fh, fw = o["filter"]
        stride = tuple(o["stride"])
        (pt, pb), (pl, pr) = _window_pads(o["padding"], x.shape[2:],
                                          (fh, fw), stride, (1, 1))
        if pt or pb or pl or pr:
            x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
        return _act(F.max_pool2d(x, (fh, fw), stride), o["activation"])

    def _const(self, i, as_nchw):
        """Float constant ``i`` (buffer ``c<i>``, NHWC-shaped): as it is,
        or where the op computes NCHW as a view that broadcasts the same
        way (padded with leading 1s to 4-D, then NHWC -> NCHW)."""
        c = getattr(self, f"c{i}")
        if not as_nchw:
            return c
        return c.reshape((1,) * (4 - c.dim()) + tuple(c.shape)).permute(
            0, 3, 1, 2)

    @staticmethod
    def _avg_pool(x, o):
        fh, fw = o["filter"]
        sh, sw = o["stride"]
        n, c, h, w = x.shape
        if (fh, fw) == (sh, sw) and h % fh == 0 and w % fw == 0:
            y = _mean(x.reshape(n, c, h // fh, fh, w // fw, fw), (3, 5),
                      False)
        elif o["padding"] != "VALID":
            raise NotImplementedError(
                "SAME avg-pool edge renorm not implemented")
        else:
            y = F.avg_pool2d(x, (fh, fw), (sh, sw))
        return _act(y, o["activation"])

    def _core_const(self, rec, name):
        """Constant ``name`` of routed attention core ``rec`` in the form
        ``attention_tc`` takes: the scale as it is, the bias [heads, N,
        N], the mask [nW, N, N]."""
        c = getattr(self, f"c{rec[name]}")
        if name == "scale":
            return c
        n = c.shape[-1]
        return c.reshape(-1 if name == "mask" else rec["heads"], n, n)

    def _ops_in_spans(self):
        """(position, op) of each op in order, those of a recognised
        mechanism inside its span (``profiling.stage``, the null context
        unless tracing is on): the span opens before its first op and
        closes once its last op is done."""
        i = 0
        while i < len(self.ops):
            if i not in self._spans:
                yield i, self.ops[i]
                i += 1
                continue
            name, last = self._spans[i]
            with profiling.stage(name):
                for j in range(i, last + 1):
                    yield j, self.ops[j]
            i = last + 1

    def forward(self, x):
        batch = x.shape[0]
        # env holds 4-D activations NCHW (ids in `nchw`; channels_last in
        # a net with a conv_tc convolution), anything else in the graph's
        # own layout
        cl = torch.channels_last if self.tc_convs else None

        def held(y):
            return y if cl is None else y.contiguous(memory_format=cl)

        x = x.to(self.compute_dtype)
        if x.dim() == 4:
            env = {self.inputs[0]: held(x.permute(0, 3, 1, 2))}
            nchw = {self.inputs[0]}
        else:                   # tokens [B, N, C]: the graph's own layout
            env, nchw = {self.inputs[0]: x}, set()

        def nhwc(i):
            v = env[i]
            return v.permute(0, 2, 3, 1) if i in nchw else v

        def arg(i, as_nchw):
            """Operand ``i`` for an op computing NCHW (``as_nchw``) or in
            the graph's own layout: an activation or a constant."""
            if i in env:
                return env[i] if as_nchw else nhwc(i)
            return self._const(i, as_nchw)

        for i, node in self._ops_in_spans():
            for t in self._dead_after.get(i - 1, ()):
                env.pop(t, None)
            if i in self._skip:
                continue
            if i in self._chain_end:
                k = self._chain_end[i]
                env[self.chains[k]["output"]] = held(self._chain(k, env))
                nchw.add(self.chains[k]["output"])
                continue
            if i in self.tc_cores:
                rec = self.tc_cores[i]
                env[rec["output"]] = attention_tc.attention_tc(
                    *(env[rec[t]] for t in "qkv"),
                    *(None if rec[c] is None else self._core_const(rec, c)
                      for c in ("scale", "bias", "mask")), rec["heads"])
                continue
            if i in self._run_start:
                run = self.runs[self._run_start[i]]
                env[run[-1]["output"]] = held(self._run(
                    self._run_start[i], env[run[0]["input"]]))
                nchw.add(run[-1]["output"])
                continue
            op, ins, o = node["op"], node["inputs"], node["options"]
            layout_nchw = all(i in nchw for i in ins if i in env)
            if op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                y = self._conv(env, node, op == "DEPTHWISE_CONV_2D", pos=i)
            elif op == "MAX_POOL_2D":
                y = self._max_pool(env[ins[0]], o)
            elif op == "AVERAGE_POOL_2D":
                y = self._avg_pool(env[ins[0]], o)
            elif op in _BINARY:
                y = _act(_BINARY[op](arg(ins[0], layout_nchw),
                                     arg(ins[1], layout_nchw)),
                         o.get("activation", "NONE"))
            elif op in _UNARY:
                y = _UNARY[op](env[ins[0]])
            elif op == "GELU":
                y = F.gelu(env[ins[0]], approximate="tanh" if o.get(
                    "approximate") else "none")
            elif op == "PRELU":
                y = _prelu(env[ins[0]], getattr(self, f"t{ins[1]}"))
            elif op == "PAD":
                p = np.asarray(self.consts[ins[1]]).tolist()
                # F.pad takes (lo, hi) pairs last dim first; the spec
                # is NHWC, the body NCHW
                order = ((2, 1, 3, 0) if layout_nchw
                         else range(len(p) - 1, -1, -1))
                y = F.pad(env[ins[0]], [v for d in order for v in p[d]])
            elif op == "RESHAPE":
                tgt = list(o.get("new_shape")
                           or np.asarray(self.consts[ins[1]]).tolist())
                # a leading 1 is the batch; a leading -1 (a window axis
                # over the batch's images) stays
                if tgt and tgt[0] == 1:
                    tgt[0] = batch
                # row-major: a reshape of an NCHW conv's output (ViT's
                # tokens) is otherwise a strided view, which every op
                # after it keeps; where it copied already, a no-op
                y = nhwc(ins[0]).reshape(tgt).contiguous()
                layout_nchw = False
            elif op in ("RESIZE_BILINEAR", "DEPTH_TO_SPACE"):
                xin = env[ins[0]]
                if op == "DEPTH_TO_SPACE":
                    y = _depth_to_space(xin, o["block_size"])
                else:
                    # f32 arithmetic over (exactly widened) activations;
                    # JAX promotes a bf16 net's resize to f32 in the same
                    # way and rounds it to bf16 where the next op reads it
                    y = _resize_bilinear(
                        xin, np.asarray(self.consts[ins[1]]).tolist(),
                        o["align_corners"], o["half_pixel_centers"]
                    ).to(self.compute_dtype)
            elif op == "CONCATENATION":
                parts = [arg(i, layout_nchw) for i in ins]
                axis = o["axis"] % parts[0].dim()
                y = _act(torch.cat(parts, dim=_TO_NCHW_AXIS[axis]
                                   if layout_nchw else axis),
                         o["activation"])
            elif op == "MEAN":
                xin = env[ins[0]]
                axes = [a % xin.dim() for a in np.asarray(
                    self.consts[ins[1]]).reshape(-1).tolist()]
                if layout_nchw and o["keep_dims"]:
                    y = _mean(xin, [_TO_NCHW_AXIS[a] for a in axes], True)
                else:
                    y = _mean(nhwc(ins[0]), axes, o["keep_dims"])
                    layout_nchw = False
            elif op in ("SOFTMAX", "L2_NORMALIZATION"):
                # over the graph's last axis: the channels of an NCHW body
                dim = 1 if layout_nchw else -1
                xin = env[ins[0]]
                if op == "SOFTMAX":
                    xin = xin * o.get("beta", 1.0)
                    e = torch.exp(xin - xin.amax(dim, keepdim=True))
                    y = e / e.sum(dim, keepdim=True)
                else:
                    sq = torch.sum(xin * xin, dim, keepdim=True)
                    y = xin * torch.rsqrt(torch.clamp(sq, min=1e-12))
            elif op == "FULLY_CONNECTED":
                w = getattr(self, f"t{ins[1]}")        # [out, in]
                xin = nhwc(ins[0])
                bias = self._bias(node)
                if i in self.tc_fcs:
                    k = self.tc_fcs[i]["k"]
                    y = fc_tc.fc_tc(xin, w, getattr(self, f"fc{k}_hi"),
                                    getattr(self, f"fc{k}_lo"), bias,
                                    o["activation"])
                else:
                    if not o.get("keep_num_dims"):
                        # TFLite flattens all but the contraction dim, in
                        # the graph's NHWC order
                        xin = xin.reshape(-1, w.shape[1])
                    y = torch.matmul(xin, w.t())
                    if bias is not None:
                        y = y + bias
                    y = _act(y, o["activation"])
                layout_nchw = False
            elif op == "BATCH_MATMUL":
                a, b = arg(ins[0], False), arg(ins[1], False)
                if o.get("adj_x"):
                    a = a.transpose(-1, -2)
                if o.get("adj_y"):
                    b = b.transpose(-1, -2)
                y = torch.matmul(a, b)
                layout_nchw = False
            elif op == "SLICE":
                begin, size = (np.asarray(self.consts[t]).reshape(-1).tolist()
                               for t in ins[1:3])
                # the first axis is the batch, as RESHAPE's leading 1:
                # begin 0 with size 1 or -1 keeps every image
                if begin[0] != 0 or size[0] not in (1, -1):
                    raise NotImplementedError(
                        f"SLICE of the batch axis: begin {begin}, size "
                        f"{size}")
                y = nhwc(ins[0])[(slice(None),) + tuple(
                    slice(b, None if n == -1 else b + n)
                    for b, n in zip(begin[1:], size[1:]))]
                layout_nchw = False
            elif op == "TRANSPOSE":
                perm = np.asarray(self.consts[ins[1]]).reshape(-1).tolist()
                if perm[0] != 0:
                    raise ValueError(f"TRANSPOSE must preserve the batch "
                                     f"axis, got {perm}")
                y = nhwc(ins[0]).permute(perm)
                layout_nchw = False
            else:
                raise NotImplementedError(f"op {op}")
            if not layout_nchw and y.dim() == 4:
                # the body holds every 4-D activation NCHW
                y = y.permute(0, 3, 1, 2)
                layout_nchw = True
            if layout_nchw:
                y = held(y) if y.dim() == 4 else y
                nchw.add(node["outputs"][0])
            env[node["outputs"][0]] = y

        return tuple(nhwc(i).contiguous().float() for i in self.outputs)


def build_torch_fn(graph, device=None, fuse_blocks=True,
                   compute_dtype=torch.float32):
    """The graph as a ``TFLiteNet`` in eval mode on ``device``, computing
    in ``compute_dtype``.  Its constants go to ``device`` first, so the
    kernels' forms of its weights (the split-TF32 hi and lo parts: 1.36
    GB for ViT-L) are made there, not on the host and copied."""
    params = {k: v.to(device) for k, v in
              params_from_consts(graph.ops, graph.consts).items()}
    return TFLiteNet(graph, params, fuse_blocks=fuse_blocks,
                     compute_dtype=compute_dtype).to(device).eval()


def load_model_fn(npz_path, compute_dtype=torch.float32, device=None):
    """Load a converted model: ``(graph, net)``, the net a ``TFLiteNet``
    on ``device`` (None: the card, raising without one) computing in
    ``compute_dtype``."""
    from .. import resolve_device
    graph = Graph(npz_path)
    return graph, build_torch_fn(graph, resolve_device(device),
                                 compute_dtype=compute_dtype)
