"""The IR-ResNet generator (``benchmark/models/iresnet.py``) against the
TFLite converter, on the CPU (skips where ``tensorflow`` is absent).

A Keras IR-ResNet (insightface's ``IResNet``: Conv2D without bias,
BatchNormalization, PReLU shared over space, ZeroPadding2D before each
stride-2 3x3, Flatten, Dense, BatchNormalization) with blocks [1, 1, 1, 1]
at widths / 8 and the generator's weights goes through
``tf.lite.TFLiteConverter`` and ``tools/convert_tflite.py``.  Its graph
holds the generator's ops in the generator's order, with the same options
and shapes, and runs in ``TFLiteNet`` to the generator's outputs: the
generated graph is what the converter emits.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "benchmark", ROOT / "tools"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

from models import iresnet as gen  # noqa: E402

SEED = 2**31 + 23
BLOCKS, WIDTHS, EMBEDDING, SIZE = [1, 1, 1, 1], [8, 16, 32, 64], 64, 112


def keras_iresnet(tf, w):
    """The Keras model of ``w`` (insightface names) and its outputs'
    layer weights set."""
    layers = tf.keras.layers
    sets = []

    def conv(x, name, stride):
        kernel = w[name].transpose(2, 3, 1, 0)           # OIHW -> HWIO
        k = kernel.shape[0]
        padding = "same" if k == 3 else "valid"
        if k == 3 and stride == 2:
            x, padding = layers.ZeroPadding2D(1)(x), "valid"
        layer = layers.Conv2D(kernel.shape[3], k, strides=stride,
                              padding=padding, use_bias=False)
        sets.append((layer, [kernel]))
        return layer(x)

    def bn(x, name):
        layer = layers.BatchNormalization(epsilon=gen.EPS)
        sets.append((layer, [w[f"{name}.{k}"] for k in (
            "weight", "bias", "running_mean", "running_var")]))
        return layer(x)

    def prelu(x, name):
        layer = layers.PReLU(shared_axes=[1, 2])
        sets.append((layer, [w[name].reshape(1, 1, -1)]))
        return layer(x)

    inp = tf.keras.Input((SIZE, SIZE, 3), batch_size=1)
    x = layers.Rescaling(2.0, offset=-1.0)(inp)
    x = prelu(bn(conv(x, "conv1.weight", 1), "bn1"), "prelu.weight")
    for s, n in enumerate(BLOCKS):
        for b in range(n):
            p, stride = f"layer{s + 1}.{b}", 2 if b == 0 else 1
            y = bn(x, f"{p}.bn1")
            y = prelu(bn(conv(y, f"{p}.conv1.weight", 1), f"{p}.bn2"),
                      f"{p}.prelu.weight")
            y = bn(conv(y, f"{p}.conv2.weight", stride), f"{p}.bn3")
            if f"{p}.downsample.0.weight" in w:
                x = bn(conv(x, f"{p}.downsample.0.weight", stride),
                       f"{p}.downsample.1")
            x = layers.Add()([y, x])
    x = layers.Flatten()(bn(x, "bn2"))
    side, c = SIZE // 16, WIDTHS[-1]
    # Keras flattens HWC; insightface's FC reads CHW
    kernel = w["fc.weight"].reshape(EMBEDDING, c, side, side).transpose(
        2, 3, 1, 0).reshape(-1, EMBEDDING)
    dense = layers.Dense(EMBEDDING)
    sets.append((dense, [kernel, w["fc.bias"]]))
    model = tf.keras.Model(inp, bn(dense(x), "features"))
    for layer, values in sets:
        layer.set_weights(values)
    return model


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    from convert_tflite import convert

    tmp = tmp_path_factory.mktemp("iresnet_converter")
    made = gen.write(tmp / "generated", SEED, BLOCKS, WIDTHS, EMBEDDING,
                     SIZE)
    w = dict(np.load(made / gen.WEIGHTS_FILE))
    flat = tf.lite.TFLiteConverter.from_keras_model(
        keras_iresnet(tf, w)).convert()
    (tmp / "iresnet.tflite").write_bytes(flat)
    convert(str(tmp / "iresnet.tflite"), str(tmp / "converted.npz"))
    return Graph(tmp / "converted.npz"), Graph(made / gen.GRAPH_FILE)


def _pattern(graph):
    """Each op's name, options, operand and result shapes, and its
    integer constants (PAD specs, shapes)."""
    shapes = [t["shape"] for t in graph.tensors]

    def ints(i):
        c = graph.consts.get(i)
        return (None if c is None or np.asarray(c).dtype.kind == "f"
                else np.asarray(c).tolist())

    return [(n["op"], n["options"], [shapes[i] for i in n["inputs"]],
             [shapes[i] for i in n["outputs"]],
             [ints(i) for i in n["inputs"]]) for n in graph.ops]


def test_generated_ops_are_the_converters(graphs):
    converted, generated = graphs
    assert _pattern(generated) == _pattern(converted)


def test_generated_graph_runs_as_the_converted_one(graphs):
    converted, generated = graphs
    nets = [TFLiteNet(g).eval() for g in graphs]
    assert [len(n.chains) for n in nets] == [9, 9]
    x = torch.rand(2, SIZE, SIZE, 3,
                   generator=torch.Generator().manual_seed(11))
    with torch.inference_mode():
        (got,), (want,) = nets[1](x), nets[0](x)
    # the same ops over constants the two folded in f32 and f64: a few
    # units in the last place of outputs of O(1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
