"""Plain PyTorch interpreter of a converted TFLite graph (``.npz``).

A frozen copy of the port's plain lowering, trimmed to the ops of the
BlazeFace, Face Mesh and Iris graphs (CONV_2D, DEPTHWISE_CONV_2D, ADD,
RELU, PRELU, MAX_POOL_2D, PAD, RESHAPE, CONCATENATION, RESIZE_BILINEAR,
DEPTH_TO_SPACE), in float32 only, op by op: no fused kernel, no cache.
It imports nothing of the program.  The graph is NHWC; the body holds
4-D activations NCHW and keeps the graph's NHWC semantics at its edges,
as the program's lowering does, so that the two call the same
convolutions.
"""

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

_TO_NCHW_AXIS = {0: 0, 1: 2, 2: 3, 3: 1}


class Graph:
    """The op list, tensor table and constants of one ``.npz`` graph, with
    each zero PAD that feeds only VALID convolutions folded into them."""

    def __init__(self, path):
        payload = np.load(path, allow_pickle=False)
        meta = json.loads(str(payload["__graph__"]))
        self.inputs = meta["inputs"]
        self.outputs = meta["outputs"]
        self.tensors = meta["tensors"]
        self.consts = {int(k[1:]): payload[k] for k in payload.files
                       if k.startswith("t")}
        self.ops = _fold_pads(meta["ops"], self.consts, set(self.outputs))

    @property
    def input_shape(self):
        return tuple(self.tensors[self.inputs[0]]["shape"])


def _fold_pads(ops, consts, graph_outputs):
    users = {}
    for node in ops:
        for i in node["inputs"]:
            users.setdefault(i, []).append(node)
    folded = []
    for node in ops:
        pad = None
        if node["op"] == "PAD" and node["inputs"][1] in consts:
            p = np.asarray(consts[node["inputs"][1]])
            if p.shape == (4, 2) and not p[0].any() and not p[3].any():
                pad = [(int(p[1][0]), int(p[1][1])),
                       (int(p[2][0]), int(p[2][1]))]
        out = node["outputs"][0] if node["outputs"] else None
        cons = users.get(out, [])
        if (pad is not None and out not in graph_outputs and cons
                and all(u["op"] in ("CONV_2D", "DEPTHWISE_CONV_2D")
                        and u["options"]["padding"] == "VALID"
                        and u["inputs"][0] == out for u in cons)):
            for u in cons:
                u["inputs"] = [node["inputs"][0]] + u["inputs"][1:]
                u["options"] = dict(u["options"], padding=pad)
            continue
        folded.append(node)
    return folded


def _act(x, kind):
    if kind in (None, "NONE"):
        return x
    if kind == "RELU":
        return torch.relu(x)
    if kind == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
    raise NotImplementedError(f"activation {kind}")


def _same_pads(size, k, stride, dilation):
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _window_pads(padding, hw, kernel, stride, dilation):
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return tuple(_same_pads(hw[d], kernel[d], stride[d], dilation[d])
                     for d in range(2))
    return tuple(tuple(p) for p in padding)


def _resize_bilinear(x, out_hw, align_corners, half_pixel_centers):
    """TFLite RESIZE_BILINEAR of NCHW ``x``: row gathers, then column
    gathers, edges clamped to the last row and column."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    dev = x.device
    ar_h = torch.arange(oh, dtype=torch.float32, device=dev)
    ar_w = torch.arange(ow, dtype=torch.float32, device=dev)
    if half_pixel_centers:
        ys = (ar_h + 0.5) * (h / oh) - 0.5
        xs = (ar_w + 0.5) * (w / ow) - 0.5
    elif align_corners and oh > 1 and ow > 1:
        ys = ar_h * ((h - 1) / (oh - 1))
        xs = ar_w * ((w - 1) / (ow - 1))
    else:
        ys = ar_h * (h / oh)
        xs = ar_w * (w / ow)
    y0 = torch.floor(ys).clamp(0, h - 1).long()
    x0 = torch.floor(xs).clamp(0, w - 1).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0.float()).clamp(0.0, 1.0)[:, None]
    wx = (xs - x0.float()).clamp(0.0, 1.0)
    ty0 = x[:, :, y0]
    ty1 = x[:, :, y1]
    top = ty0[..., x0] * (1 - wx) + ty0[..., x1] * wx
    bot = ty1[..., x0] * (1 - wx) + ty1[..., x1] * wx
    return top * (1 - wy) + bot * wy


def _depth_to_space(x, block):
    n, c, h, w = x.shape
    cc = c // (block * block)
    x = x.reshape(n, block, block, cc, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, cc, h * block, w * block)


class PlainNet:
    """``net(x [B, H, W, C]) -> tuple of outputs`` (NHWC, f32) of a
    ``Graph`` on ``device``, every op a plain PyTorch call."""

    def __init__(self, graph, device):
        self.g = graph
        self.w = {}
        for node in graph.ops:
            op, ins = node["op"], node["inputs"]
            if op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                w = torch.from_numpy(np.asarray(
                    graph.consts[ins[1]], np.float32))
                w = (w.permute(0, 3, 1, 2) if op == "CONV_2D"
                     else w.permute(3, 0, 1, 2))
                self.w[ins[1]] = w.contiguous().to(device)
                if len(ins) > 2 and ins[2] >= 0:
                    self.w[ins[2]] = torch.from_numpy(np.asarray(
                        graph.consts[ins[2]], np.float32)).to(device)
            elif op == "PRELU":
                self.w[ins[1]] = torch.from_numpy(np.asarray(
                    graph.consts[ins[1]], np.float32)).reshape(
                        1, -1, 1, 1).to(device)
            elif op not in ("ADD", "RELU", "MAX_POOL_2D", "PAD", "RESHAPE",
                            "CONCATENATION", "RESIZE_BILINEAR",
                            "DEPTH_TO_SPACE"):
                raise NotImplementedError(f"op {op}")

    def _conv(self, x, node, depthwise):
        o, ins = node["options"], node["inputs"]
        w = self.w[ins[1]]
        b = self.w.get(ins[2]) if len(ins) > 2 and ins[2] >= 0 else None
        stride = tuple(o["stride"])
        dilation = tuple(o.get("dilation", (1, 1)))
        (pt, pb), (pl, pr) = _window_pads(o["padding"], x.shape[2:],
                                          w.shape[2:], stride, dilation)
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            pad = (0, 0)
        y = F.conv2d(x, w, b, stride=stride, padding=pad, dilation=dilation,
                     groups=x.shape[1] if depthwise else 1)
        return _act(y, o["activation"])

    def __call__(self, x):
        g = self.g
        batch = x.shape[0]
        env = {g.inputs[0]: x.permute(0, 3, 1, 2).float()}
        nchw = {g.inputs[0]}

        def nhwc(i):
            return env[i].permute(0, 2, 3, 1) if i in nchw else env[i]

        for node in g.ops:
            op, ins, o = node["op"], node["inputs"], node["options"]
            layout_nchw = all(i in nchw for i in ins if i in env)
            if op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                y = self._conv(env[ins[0]], node, op == "DEPTHWISE_CONV_2D")
            elif op == "MAX_POOL_2D":
                fh, fw = o["filter"]
                stride = tuple(o["stride"])
                (pt, pb), (pl, pr) = _window_pads(
                    o["padding"], env[ins[0]].shape[2:], (fh, fw), stride,
                    (1, 1))
                xin = env[ins[0]]
                if pt or pb or pl or pr:
                    xin = F.pad(xin, (pl, pr, pt, pb), value=-math.inf)
                y = _act(F.max_pool2d(xin, (fh, fw), stride),
                         o["activation"])
            elif op == "ADD":
                y = _act(env[ins[0]] + env[ins[1]],
                         o.get("activation", "NONE"))
            elif op == "RELU":
                y = torch.relu(env[ins[0]])
            elif op == "PRELU":
                y = (torch.clamp(env[ins[0]], min=0)
                     + self.w[ins[1]] * torch.clamp(env[ins[0]], max=0))
            elif op == "PAD":
                p = np.asarray(g.consts[ins[1]]).tolist()
                order = ((2, 1, 3, 0) if layout_nchw
                         else range(len(p) - 1, -1, -1))
                y = F.pad(env[ins[0]], [v for d in order for v in p[d]])
            elif op == "RESHAPE":
                tgt = list(o.get("new_shape")
                           or np.asarray(g.consts[ins[1]]).tolist())
                if tgt and tgt[0] == 1:
                    tgt[0] = batch
                y = nhwc(ins[0]).reshape(tgt)
                layout_nchw = False
            elif op == "RESIZE_BILINEAR":
                y = _resize_bilinear(env[ins[0]],
                                     np.asarray(g.consts[ins[1]]).tolist(),
                                     o["align_corners"],
                                     o["half_pixel_centers"])
            elif op == "DEPTH_TO_SPACE":
                y = _depth_to_space(env[ins[0]], o["block_size"])
            elif op == "CONCATENATION":
                parts = [env[i] if layout_nchw else nhwc(i) for i in ins]
                axis = o["axis"] % parts[0].dim()
                y = _act(torch.cat(parts, dim=_TO_NCHW_AXIS[axis]
                                   if layout_nchw else axis),
                         o["activation"])
            else:
                raise NotImplementedError(f"op {op}")
            if not layout_nchw and y.dim() == 4:
                y = y.permute(0, 3, 1, 2)
                layout_nchw = True
            env[node["outputs"][0]] = y
            if layout_nchw:
                nchw.add(node["outputs"][0])
        return tuple(nhwc(i).contiguous().float() for i in g.outputs)
