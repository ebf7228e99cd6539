"""ArcFace's IR-ResNet (insightface ``recognition/arcface_torch/backbones/
iresnet.py``; arXiv:1801.07698 §3) with seeded weights, written as two
files into a directory:

* ``face_embeddings.npz``: the net as a converted TFLite graph, in the
  schema of ``tools/convert_tflite.py`` (NHWC, OHWI weights), as the
  TFLite converter emits it: the input map (0, 1) -> (-1, 1) as a MUL and
  an ADD; each BatchNorm that follows a convolution folded into its
  weights and bias; each BatchNorm that precedes one a per-channel MUL and
  ADD; each stride-2 3x3 convolution an explicit symmetric PAD (PyTorch's
  ``padding=1``) before a VALID convolution; the flatten a RESHAPE in the
  graph's HWC order, the FC's columns permuted to match, and the last
  BatchNorm1d folded into the FC.  Output: the raw 512-d embedding.
* ``iresnet_weights.npz``: the same weights unfolded, under insightface's
  state-dict names, for a plain reference of the published equations.

Plain numpy: no TensorFlow, no torch.  The same seed and shape give the
same bytes (the zip members carry a fixed date): ``write(out_dir, seed)``.

Weights: He-normal convolutions, PReLU slopes near insightface's 0.25,
and BatchNorm statistics drawn around the scale each BN sees when the
input is O(1): so activations stay O(1) through all 49 units of R100, and
each unit's last BN has a small scale, so that a unit adds a small
residual (as in a trained net, whose units are near the identity).
"""

import json
import os
import zipfile
from pathlib import Path

import numpy as np

# iresnet100: units per stage, stage widths, embedding width, input side
PUBLISHED = {"blocks": [3, 13, 30, 3], "widths": [64, 128, 256, 512],
             "embedding": 512, "input": 112}
EPS = 1e-5                                  # every BN's eps (iresnet.py)
GRAPH_FILE = "face_embeddings.npz"
WEIGHTS_FILE = "iresnet_weights.npz"
# the weights files' directory under a checkout, by configuration name
BUILD_DIR = Path("build") / "benchmark"


def _bn(rng, name, c, var, gamma=(0.8, 1.2)):
    """A BatchNorm's four tensors: running variance drawn within
    [0.8, 1.25] x ``var`` (the variance its input has), mean and shift
    small beside it, scale from ``gamma``."""
    return {f"{name}.weight": rng.uniform(*gamma, c),
            f"{name}.bias": rng.normal(0.0, 0.05, c),
            f"{name}.running_mean": rng.normal(0.0, 0.05, c)
            * np.sqrt(var),
            f"{name}.running_var": rng.uniform(0.8, 1.25, c) * var}


def _conv(rng, name, co, ci, k):
    return {name: rng.standard_normal((co, ci, k, k))
            * np.sqrt(2.0 / (ci * k * k))}


def _prelu(rng, name, c):
    return {name: 0.25 + 0.02 * rng.standard_normal(c)}


def draw_weights(seed, blocks, widths, embedding, size):
    """{insightface name: float32 array} of an IR-ResNet with ``blocks``
    units per stage at ``widths``, from ``seed``."""
    rng = np.random.default_rng(seed)
    w = {}
    w.update(_conv(rng, "conv1.weight", widths[0], 3, 3))
    # inputs in (-1, 1): the stem's output has about a third of the
    # He-normal unit variance
    w.update(_bn(rng, "bn1", widths[0], 0.7))
    w.update(_prelu(rng, "prelu.weight", widths[0]))
    inplanes = widths[0]
    for s, (n, planes) in enumerate(zip(blocks, widths)):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            # the unit's input grows by each residual added to it
            w.update(_bn(rng, f"{p}.bn1", inplanes, 1.0 + 0.05 * b))
            w.update(_conv(rng, f"{p}.conv1.weight", planes, inplanes, 3))
            w.update(_bn(rng, f"{p}.bn2", planes, 2.0))
            w.update(_prelu(rng, f"{p}.prelu.weight", planes))
            w.update(_conv(rng, f"{p}.conv2.weight", planes, planes, 3))
            w.update(_bn(rng, f"{p}.bn3", planes, 1.0, gamma=(0.1, 0.3)))
            if b == 0:
                w.update(_conv(rng, f"{p}.downsample.0.weight", planes,
                               inplanes, 1))
                w.update(_bn(rng, f"{p}.downsample.1", planes,
                             2.0 * (1.0 + 0.05 * blocks[max(s - 1, 0)])))
            inplanes = planes
    w.update(_bn(rng, "bn2", inplanes, 1.0 + 0.05 * blocks[-1]))
    side = size // 16
    feat = inplanes * side * side
    w["fc.weight"] = rng.standard_normal((embedding, feat)) / np.sqrt(feat)
    w["fc.bias"] = rng.normal(0.0, 0.05, embedding)
    w.update(_bn(rng, "features", embedding, 1.0))
    w["features.weight"] = np.ones(embedding)   # fixed at 1 in iresnet.py
    return {k: np.ascontiguousarray(v, np.float32) for k, v in w.items()}


class _Writer:
    """Tensors, constants and ops of a graph in the converter's schema,
    from weights ``w`` under insightface's names."""

    def __init__(self, w):
        self.w = w
        self.tensors, self.consts, self.ops = [], {}, []

    def tensor(self, shape, name, dtype="float32"):
        self.tensors.append({"shape": list(shape), "dtype": dtype,
                             "name": name})
        return len(self.tensors) - 1

    def const(self, array, name):
        array = np.asarray(array)
        i = self.tensor(array.shape, name, array.dtype.name)
        self.consts[f"t{i}"] = array
        return i

    def op(self, op, inputs, shape, name, **options):
        out = self.tensor(shape, name)
        self.ops.append({"op": op, "inputs": list(inputs), "outputs": [out],
                         "options": options})
        return out

    def graph(self, inputs, outputs):
        return ({"inputs": inputs, "outputs": outputs,
                 "tensors": self.tensors, "ops": self.ops}, self.consts)

    def scale_shift(self, bn):
        """A BN's inference form y = x * scale + shift, in float64."""
        g, b, m, v = (self.w[f"{bn}.{k}"].astype(np.float64) for k in
                      ("weight", "bias", "running_mean", "running_var"))
        scale = g / np.sqrt(v + EPS)
        return scale, b - m * scale

    def conv_bn(self, x, hw, conv, bn, stride, name):
        """CONV_2D with ``bn`` folded in, and its output side; a stride-2
        3x3 gets PyTorch's symmetric padding as a PAD before a VALID
        conv."""
        w = self.w[conv]
        k, ci = w.shape[2], w.shape[1]
        scale, shift = self.scale_shift(bn)
        wt = w.astype(np.float64) * scale[:, None, None, None]
        wt = np.ascontiguousarray(wt.transpose(0, 2, 3, 1), np.float32)
        padding = "VALID" if k == 1 else "SAME"
        if k == 3 and stride == 2:
            x = self.op("PAD", [x, self.const(np.array(
                [[0, 0], [1, 1], [1, 1], [0, 0]], np.int32), f"{name}/pads")],
                [1, hw + 2, hw + 2, ci], f"{name}/pad")
            padding = "VALID"
        out = hw // stride
        y = self.op("CONV_2D", [x, self.const(wt, conv), self.const(
            shift.astype(np.float32), f"{name}/bias")],
            [1, out, out, wt.shape[0]], name, stride=[stride, stride],
            dilation=[1, 1], padding=padding, activation="NONE")
        return y, out

    def bn(self, x, shape, bn):
        """A BN before a convolution: a per-channel MUL and ADD."""
        scale, shift = self.scale_shift(bn)
        x = self.op("MUL", [x, self.const(scale.astype(np.float32),
                                          f"{bn}/scale")], shape,
                    f"{bn}/mul", activation="NONE")
        return self.op("ADD", [x, self.const(shift.astype(np.float32),
                                             f"{bn}/shift")], shape,
                       f"{bn}/add", activation="NONE")

    def prelu(self, x, hw, name):
        alpha = self.w[name]
        return self.op("PRELU", [x, self.const(alpha.reshape(1, 1, -1),
                                               name)],
                       [1, hw, hw, alpha.size], name)

    def unit(self, x, hw, p, stride):
        """``IBasicBlock``: returns (output, its side)."""
        c = self.w[f"{p}.conv1.weight"].shape[1]
        planes = self.w[f"{p}.conv1.weight"].shape[0]
        y = self.bn(x, [1, hw, hw, c], f"{p}.bn1")
        y, _ = self.conv_bn(y, hw, f"{p}.conv1.weight", f"{p}.bn2", 1,
                            f"{p}.conv1")
        y = self.prelu(y, hw, f"{p}.prelu.weight")
        y, out = self.conv_bn(y, hw, f"{p}.conv2.weight", f"{p}.bn3", stride,
                              f"{p}.conv2")
        if f"{p}.downsample.0.weight" in self.w:
            x, _ = self.conv_bn(x, hw, f"{p}.downsample.0.weight",
                                f"{p}.downsample.1", stride,
                                f"{p}.downsample")
        return self.op("ADD", [y, x], [1, out, out, planes], f"{p}.add",
                       activation="NONE"), out


def graph_from_weights(w, blocks, widths, embedding, size):
    """(graph JSON dict, {"t<id>": constant}) of the converted net."""
    g = _Writer(w)
    x = inputs = g.tensor([1, size, size, 3], "input")
    x = g.op("MUL", [x, g.const(np.array(2.0, np.float32), "in_scale")],
             [1, size, size, 3], "input_map/mul", activation="NONE")
    x = g.op("ADD", [x, g.const(np.array(-1.0, np.float32), "in_shift")],
             [1, size, size, 3], "input_map/add", activation="NONE")
    x, hw = g.conv_bn(x, size, "conv1.weight", "bn1", 1, "conv1")
    x = g.prelu(x, hw, "prelu.weight")
    for s, n in enumerate(blocks):
        for b in range(n):
            x, hw = g.unit(x, hw, f"layer{s + 1}.{b}", 2 if b == 0 else 1)
    c = widths[len(blocks) - 1]
    x = g.bn(x, [1, hw, hw, c], "bn2")
    feat = hw * hw * c
    x = g.op("RESHAPE", [x, g.const(np.array([1, feat], np.int32),
                                    "flatten/shape")], [1, feat], "flatten")
    # the FC reads the graph's HWC flatten; insightface's reads CHW
    fc = w["fc.weight"].reshape(embedding, c, hw, hw).transpose(0, 2, 3, 1)
    scale, shift = g.scale_shift("features")
    fc = fc.reshape(embedding, feat).astype(np.float64) * scale[:, None]
    bias = w["fc.bias"].astype(np.float64) * scale + shift
    x = g.op("FULLY_CONNECTED", [x, g.const(fc.astype(np.float32), "fc"),
                                 g.const(bias.astype(np.float32),
                                         "fc/bias")],
             [1, embedding], "fc", activation="NONE", keep_num_dims=False)
    return g.graph([inputs], [x])


def unit_graph(w, prefix, hw, stride):
    """(graph JSON dict, constants) of the one unit ``prefix`` (e.g.
    "layer3.0") of ``w`` on an input of side ``hw``."""
    g = _Writer(w)
    c = w[f"{prefix}.conv1.weight"].shape[1]
    x = g.tensor([1, hw, hw, c], "input")
    y, _ = g.unit(x, hw, prefix, stride)
    return g.graph([x], [y])


def save_npz(path, arrays):
    """``np.savez`` with a fixed date on every member, written to a
    temporary name and moved into place: the same arrays give the same
    bytes, and a reader never sees half a file."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for name, value in arrays.items():
            info = zipfile.ZipInfo(f"{name}.npy", (1980, 1, 1, 0, 0, 0))
            with z.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value),
                                          allow_pickle=False)
    os.replace(tmp, path)


def write(out_dir, seed, blocks=None, widths=None, embedding=None,
          size=None, files=(GRAPH_FILE, WEIGHTS_FILE)):
    """Write ``files`` of the seeded net (by default both: the program's
    graph and the reference's weights) into ``out_dir``; returns it.
    Unset sizes are the published ones."""
    blocks = list(blocks or PUBLISHED["blocks"])
    widths = list(widths or PUBLISHED["widths"])
    embedding = embedding or PUBLISHED["embedding"]
    size = size or PUBLISHED["input"]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    w = draw_weights(seed, blocks, widths, embedding, size)
    if GRAPH_FILE in files:
        graph, consts = graph_from_weights(w, blocks, widths, embedding,
                                           size)
        save_npz(out / GRAPH_FILE,
                 {"__graph__": np.array(json.dumps(graph)), **consts})
    if WEIGHTS_FILE in files:
        save_npz(out / WEIGHTS_FILE, w)
    return out


def model_dir(config, root):
    """The directory of a configuration's files under the checkout
    ``root`` (git-ignored)."""
    return Path(root) / BUILD_DIR / config["name"]


def write_config(config, root, files=(GRAPH_FILE, WEIGHTS_FILE)):
    """Write ``files`` of a configuration's net (its ``weights_seed`` and
    published ``widths``) into ``model_dir``; returns the directory."""
    shape = config["widths"]
    return write(model_dir(config, root), config["weights_seed"],
                 shape["blocks"], shape["stage_widths"],
                 shape["embedding"], shape["input"][0], files)
