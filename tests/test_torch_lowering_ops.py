"""The rest of the TFLite op set in tpu_face_torch's lowering, on the CPU
against tpu_face.compiler.build_jax_fn.

Each case is a tiny graph written as the converter's ``.npz`` (JSON op
list + constants), read by both packages, and run on the same seeded
input at batch 2:

* the binary elementwise ops (ADD, SUB, MUL, DIV, MINIMUM, MAXIMUM) with
  a constant operand of each TFLite shape ``[]``, ``[1]``, ``[C]`` and
  ``[1, 1, 1, C]`` (on either side), between two activations, with a
  fused activation, and on a 2-D activation;
* the unary ops (SQRT, RSQRT, NEG, EXP, TANH, HARD_SWISH, LOGISTIC,
  RELU), MEAN (axes, ``keep_dims``, negative axes), SOFTMAX (``beta``)
  and L2_NORMALIZATION on 4-D and 2-D tensors;
* FULLY_CONNECTED on a 4-D input (which pins the NHWC flatten order),
  with and without a bias and with ``keep_num_dims``; BATCH_MATMUL with
  ``adj_x``/``adj_y`` and a broadcast constant; TRANSPOSE; and
  AVERAGE_POOL_2D (the whole-window reshape, VALID windows, and SAME
  where it is a reshape).

f32 within 1e-5 of max|JAX output| (and 1e-5 relative), bf16 within
2e-2 * max|JAX output| (tests/test_torch_bf16.py's rule for the nets).
A SAME AVERAGE_POOL_2D that is no reshape raises in both packages
(``NotImplementedError`` here; JAX asserts), as does a TRANSPOSE that
moves the batch axis (``ValueError`` here).  The demo embedding graph
(``tpu_face/data/demo``, a MobileFaceNet) is in
tests/test_torch_embeddings.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import build_jax_fn
from tpu_face_torch.compiler import Graph, TFLiteNet

SHAPE = (1, 4, 6, 3)          # the graphs' NHWC input, C = 3
F32_TOL = 1e-5
BF16_TOL = 2e-2               # x max|JAX output|


class _Builder:
    """A converted-graph payload: tensor 0 is the input."""

    def __init__(self, shape=SHAPE):
        self.tensors = [{"shape": list(shape), "dtype": "float32"}]
        self.ops, self.consts = [], {}

    def const(self, value, dtype=np.float32):
        self.tensors.append({"shape": list(np.shape(value))})
        self.consts[len(self.tensors) - 1] = np.asarray(value, dtype)
        return len(self.tensors) - 1

    def op(self, name, inputs, **options):
        self.tensors.append({"shape": [1]})
        out = len(self.tensors) - 1
        self.ops.append({"op": name, "inputs": list(inputs),
                         "outputs": [out], "options": options})
        return out

    def save(self, path, outputs):
        meta = {"inputs": [0], "outputs": list(outputs),
                "tensors": self.tensors, "ops": self.ops}
        np.savez(path, __graph__=np.array(json.dumps(meta)),
                 **{f"t{k}": v for k, v in self.consts.items()})
        return path


def _const(rng, shape, positive):
    v = rng.uniform(0.5, 2.0, shape) if positive else rng.uniform(
        -2.0, 2.0, shape)
    return np.asarray(v, np.float32)


def _binary(op, shape, const_first=False, act=None):
    def build(g, rng):
        c = g.const(_const(rng, shape, positive=op == "DIV"))
        ins = [c, 0] if const_first else [0, c]
        opts = {} if op in ("MINIMUM", "MAXIMUM") else {
            "activation": act or "NONE"}
        return [g.op(op, ins, **opts)]
    return build


def _two_activations(op):
    def build(g, rng):
        other = g.op("LOGISTIC", [0])        # > 0, so DIV is safe
        opts = {} if op in ("MINIMUM", "MAXIMUM") else {
            "activation": "NONE"}
        return [g.op(op, [0, other], **opts)]
    return build


def _on_2d(op, shape):
    def build(g, rng):
        flat = g.op("RESHAPE", [0], new_shape=[1, 72])
        return [g.op(op, [flat, g.const(_const(rng, shape, op == "DIV"))],
                     activation="NONE")]
    return build


def _unary(op):
    return lambda g, rng: [g.op(op, [0])]


def _mean(axes, keep):
    return lambda g, rng: [g.op("MEAN", [0, g.const(axes, np.int32)],
                                keep_dims=keep)]


def _softmax_l2(op, flat, **options):
    def build(g, rng):
        x = g.op("RESHAPE", [0], new_shape=[1, 24, 3]) if flat else 0
        return [g.op(op, [x], **options)]
    return build


def _fully_connected(bias=True, keep=False):
    def build(g, rng):
        din = SHAPE[-1] if keep else int(np.prod(SHAPE[1:]))
        ins = [0, g.const(rng.normal(size=(5, din)) * 0.3)]
        if bias:
            ins.append(g.const(rng.normal(size=(5,))))
        return [g.op("FULLY_CONNECTED", ins, activation="RELU" if bias
                     else "NONE", keep_num_dims=keep)]
    return build


def _batch_matmul(kind):
    def build(g, rng):
        r = g.op("RESHAPE", [0], new_shape=[1, 24, 3])
        if kind == "const":          # [B, 24, 3] @ [3, 4], broadcast
            return [g.op("BATCH_MATMUL",
                         [r, g.const(rng.normal(size=(3, 4)))])]
        if kind == "const_adj_y":    # [B, 24, 3] @ [4, 3]^T
            return [g.op("BATCH_MATMUL",
                         [r, g.const(rng.normal(size=(1, 4, 3)))],
                         adj_y=True)]
        if kind == "adj_x":          # [B, 24, 3]^T @ [B, 24, 3]
            return [g.op("BATCH_MATMUL", [r, r], adj_x=True)]
        if kind == "adj_y":          # [B, 24, 3] @ [B, 24, 3]^T
            return [g.op("BATCH_MATMUL", [r, r], adj_y=True)]
        # 4-D: the NHWC activation @ [C, 2]; the result is 4-D again
        return [g.op("BATCH_MATMUL", [0, g.const(rng.normal(size=(3, 2)))])]
    return build


def _transpose(perm, then_mean=False):
    def build(g, rng):
        t = g.op("TRANSPOSE", [0, g.const(perm, np.int32)])
        if not then_mean:
            return [t]
        # the 4-D transposed activation is held NCHW again: an op that
        # maps NHWC axes must see the transposed layout
        return [t, g.op("MEAN", [t, g.const([1, 2], np.int32)],
                        keep_dims=True)]
    return build


def _avg_pool(filt, stride, padding):
    return lambda g, rng: [g.op("AVERAGE_POOL_2D", [0], filter=list(filt),
                                stride=list(stride), padding=padding,
                                activation="NONE")]


def _prelu_as_exported(g, rng):
    """The embedding graph's PReLU: RELU(x) + MUL(MINIMUM(x, [0]),
    alpha[C]), then a squeeze-excite gate: MEAN keep_dims, LOGISTIC,
    MUL."""
    pos = g.op("RELU", [0])
    neg = g.op("MINIMUM", [0, g.const([0.0])])
    scaled = g.op("MUL", [neg, g.const(rng.uniform(0.1, 0.4, (3,)))],
                  activation="NONE")
    y = g.op("ADD", [pos, scaled], activation="NONE")
    gate = g.op("LOGISTIC", [g.op("MEAN", [y, g.const([1, 2], np.int32)],
                                  keep_dims=True)])
    return [g.op("MUL", [y, gate], activation="NONE")]


CONST_SHAPES = {"scalar": (), "one": (1,), "c": (3,), "1x1x1xc": (1, 1, 1, 3)}
CASES = {}
for _op in ("ADD", "SUB", "MUL", "DIV", "MINIMUM", "MAXIMUM"):
    for _name, _shape in CONST_SHAPES.items():
        CASES[f"{_op}-{_name}"] = _binary(_op, _shape)
    CASES[f"{_op}-activations"] = _two_activations(_op)
CASES.update({
    "SUB-c-first": _binary("SUB", (3,), const_first=True),
    "DIV-1x1x1xc-first": _binary("DIV", (1, 1, 1, 3), const_first=True),
    "MUL-relu": _binary("MUL", (3,), act="RELU"),
    "ADD-relu6": _binary("ADD", (), act="RELU6"),
    "SUB-2d": _on_2d("SUB", (72,)),
    "MUL-2d-scalar": _on_2d("MUL", ()),
    "prelu-as-exported": _prelu_as_exported,
    "MEAN-hw-keep": _mean([1, 2], True),
    "MEAN-hw": _mean([1, 2], False),
    "MEAN-c": _mean([3], False),
    "MEAN-neg-keep": _mean([-1], True),
    "MEAN-h-keep": _mean([1], True),
    "SOFTMAX-4d": _softmax_l2("SOFTMAX", False, beta=1.0),
    "SOFTMAX-3d-beta": _softmax_l2("SOFTMAX", True, beta=0.5),
    "L2_NORMALIZATION-4d": _softmax_l2("L2_NORMALIZATION", False),
    "L2_NORMALIZATION-3d": _softmax_l2("L2_NORMALIZATION", True),
    "FULLY_CONNECTED-4d-bias": _fully_connected(),
    "FULLY_CONNECTED-4d": _fully_connected(bias=False),
    "FULLY_CONNECTED-keep": _fully_connected(keep=True),
    "BATCH_MATMUL-const": _batch_matmul("const"),
    "BATCH_MATMUL-const-adj_y": _batch_matmul("const_adj_y"),
    "BATCH_MATMUL-adj_x": _batch_matmul("adj_x"),
    "BATCH_MATMUL-adj_y": _batch_matmul("adj_y"),
    "BATCH_MATMUL-4d": _batch_matmul("4d"),
    "TRANSPOSE-hw": _transpose([0, 2, 1, 3]),
    "TRANSPOSE-chw": _transpose([0, 3, 1, 2], then_mean=True),
    "AVERAGE_POOL_2D-reshape": _avg_pool((2, 3), (2, 3), "VALID"),
    "AVERAGE_POOL_2D-same-reshape": _avg_pool((2, 2), (2, 2), "SAME"),
    "AVERAGE_POOL_2D-valid": _avg_pool((3, 3), (1, 1), "VALID"),
    "AVERAGE_POOL_2D-valid-strided": _avg_pool((2, 2), (2, 1), "VALID"),
})
for _op in ("SQRT", "RSQRT", "NEG", "EXP", "TANH", "HARD_SWISH", "LOGISTIC",
            "RELU"):
    CASES[_op] = _unary(_op)
POSITIVE_INPUT = {"SQRT", "RSQRT"}


def _graphs(tmp_path, name, build):
    g = _Builder()
    outputs = build(g, np.random.default_rng(len(name)))
    path = g.save(tmp_path / f"{name}.npz", outputs)
    return JaxGraph(path), Graph(path)


def _input(name):
    rng = np.random.default_rng(7)
    lo, hi = (0.25, 4.0) if name in POSITIVE_INPUT else (-3.0, 3.0)
    return rng.uniform(lo, hi, (2,) + SHAPE[1:]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_build_jax_fn(tmp_path, name, dtype):
    jg, tg = _graphs(tmp_path, name, CASES[name])
    x = _input(name)
    want = jax.jit(build_jax_fn(jg, compute_dtype=getattr(jnp, dtype)))(x)
    net = TFLiteNet(tg, compute_dtype=getattr(torch, dtype)).eval()
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (name, g.shape, w.shape)
        scale = float(np.abs(w).max())
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL,
                                       atol=F32_TOL * scale)
        else:
            assert float(np.abs(g.numpy() - w).max()) <= BF16_TOL * scale


def test_fully_connected_flattens_in_nhwc_order(tmp_path):
    """The weight's column k reads NHWC element k: with a one-hot row the
    product picks exactly that input element."""
    g = _Builder()
    din = int(np.prod(SHAPE[1:]))
    w = np.zeros((2, din), np.float32)
    w[0, 17] = w[1, din - 1] = 1.0
    out = g.op("FULLY_CONNECTED", [0, g.const(w)], activation="NONE",
               keep_num_dims=False)
    path = g.save(tmp_path / "fc.npz", [out])
    x = _input("fc")
    with torch.inference_mode():
        (got,) = TFLiteNet(Graph(path)).eval()(torch.from_numpy(x))
    flat = x.reshape(2, -1)
    np.testing.assert_array_equal(got.numpy(), flat[:, [17, din - 1]])


def test_same_average_pool_raises_as_in_jax(tmp_path):
    jg, tg = _graphs(tmp_path, "avg-same",
                     _avg_pool((3, 3), (1, 1), "SAME"))
    x = _input("avg-same")
    with pytest.raises(AssertionError, match="SAME avg-pool"):
        build_jax_fn(jg)(x)
    with pytest.raises(NotImplementedError, match="SAME avg-pool"):
        TFLiteNet(tg)(torch.from_numpy(x))


def test_transpose_of_the_batch_axis_raises(tmp_path):
    jg, tg = _graphs(tmp_path, "tr", _transpose([1, 0, 2, 3]))
    x = _input("tr")
    with pytest.raises(AssertionError, match="batch axis"):
        build_jax_fn(jg)(x)
    with pytest.raises(ValueError, match="batch axis"):
        TFLiteNet(tg)(torch.from_numpy(x))


def test_constants_are_module_buffers(tmp_path):
    """Elementwise constants are registered once, as buffers in their NHWC
    shape (so ``.to(device)`` moves them), rounded to bf16 in a bf16 net
    as JAX rounds them."""
    _, tg = _graphs(tmp_path, "prelu", _prelu_as_exported)
    net = TFLiteNet(tg, compute_dtype=torch.bfloat16)
    consts = {k: v for k, v in net.named_buffers() if k.startswith("c")}
    assert sorted(tuple(v.shape) for v in consts.values()) == [(1,), (3,)]
    assert {v.dtype for v in consts.values()} == {torch.bfloat16}
    for key, v in consts.items():
        np.testing.assert_array_equal(
            v.float().numpy(), torch.from_numpy(tg.consts[int(key[1:])])
            .to(torch.bfloat16).float().numpy())
