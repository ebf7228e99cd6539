"""tpu_face_torch's graph lowering against tpu_face.compiler.build_jax_fn.

Both packages run the same graph on the same weights (the JAX Graph's
constant pool carried across with ``params_from_consts``) and the same
random NHWC input.  Tolerances are the net-parity contracts of
tests/test_net_parity.py: max abs 2e-4 for the detector, 2e-3 for the
mesh and iris nets (their outputs are pixel-scale).
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import build_jax_fn
from tpu_face_torch.compiler import Graph, TFLiteNet, params_from_consts
from tpu_face_torch.compiler.lowering import _same_pads
from tpu_face_torch.models.face_detection import _DATA_DIR

NETS = {"face_detection_back": 2e-4, "face_landmark": 2e-3,
        "iris_landmark": 2e-3}


@pytest.fixture(scope="module")
def graphs():
    return {n: (JaxGraph(_DATA_DIR / f"{n}.npz"),
                Graph(_DATA_DIR / f"{n}.npz")) for n in NETS}


@pytest.mark.parametrize("name", sorted(NETS))
def test_graph_matches_jax_graph(graphs, name):
    """Same folded op list, same constant pool, same I/O."""
    jg, tg = graphs[name]
    assert tg.ops == jg.ops
    assert tg.inputs == jg.inputs and tg.outputs == jg.outputs
    assert tg.input_shape == jg.input_shape
    assert sorted(tg.consts) == sorted(jg.consts)
    for k, v in jg.consts.items():
        np.testing.assert_array_equal(tg.consts[k], v)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", sorted(NETS))
def test_net_matches_build_jax_fn(graphs, name, batch):
    jg, tg = graphs[name]
    net = TFLiteNet(tg, params_from_consts(jg.ops, jg.consts)).eval()
    rng = np.random.default_rng(batch)
    x = rng.uniform(-1.0, 1.0, (batch,) + tuple(jg.input_shape[1:])
                    ).astype(np.float32)
    want = jax.jit(build_jax_fn(jg))(x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        diff = float(np.max(np.abs(g.numpy() - np.asarray(w))))
        assert diff <= NETS[name], (name, g.shape, diff)


def test_params_from_consts_layouts():
    """OHWI -> OIHW, DW [1,kh,kw,C] -> [C,1,kh,kw], PReLU alpha ->
    [1,C,1,1], f16 -> f32."""
    consts = {
        1: np.arange(2 * 3 * 3 * 4, dtype=np.float16).reshape(2, 3, 3, 4),
        2: np.ones(2, np.float32),
        3: np.arange(3 * 3 * 5, dtype=np.float32).reshape(1, 3, 3, 5),
        4: np.arange(5, dtype=np.float32).reshape(1, 1, 5),
    }
    ops = [{"op": "CONV_2D", "inputs": [0, 1, 2], "outputs": [5],
            "options": {}},
           {"op": "DEPTHWISE_CONV_2D", "inputs": [5, 3, -1],
            "outputs": [6], "options": {}},
           {"op": "PRELU", "inputs": [6, 4], "outputs": [7],
            "options": {}}]
    p = params_from_consts(ops, consts)
    assert set(p) == {"t1", "t2", "t3", "t4"}
    assert p["t1"].dtype == torch.float32
    np.testing.assert_array_equal(p["t1"].numpy(),
                                  consts[1].astype(np.float32)
                                  .transpose(0, 3, 1, 2))
    assert tuple(p["t3"].shape) == (5, 1, 3, 3)
    np.testing.assert_array_equal(p["t3"][:, 0].numpy(),
                                  consts[3][0].transpose(2, 0, 1))
    assert tuple(p["t4"].shape) == (1, 5, 1, 1)


def test_back_model_f16_weights_upcast(graphs):
    jg, _ = graphs["face_detection_back"]
    n_f16 = sum(v.dtype == np.float16 for v in jg.consts.values())
    assert n_f16 == 138
    params = params_from_consts(jg.ops, jg.consts)
    assert all(v.dtype == torch.float32 for v in params.values())


def test_same_padding_is_asymmetric_for_strided_even_windows():
    # stride 2, 3x3 on 256: 128 outputs, one pad row/col at the bottom
    assert _same_pads(256, 3, 2, 1) == (0, 1)
    # stride 1 odd kernel: symmetric
    assert _same_pads(64, 5, 1, 1) == (2, 2)
    # even window, stride 2 on an even size: no padding (max pools)
    assert _same_pads(128, 2, 2, 1) == (0, 0)


def test_unsupported_op_raises(graphs):
    _, tg = graphs["iris_landmark"]

    class Fake:
        ops = tg.ops + [{"op": "SQUARED_DIFFERENCE",
                         "inputs": [tg.outputs[0], tg.outputs[0]],
                         "outputs": [9999], "options": {}}]
        consts, inputs, outputs = tg.consts, tg.inputs, tg.outputs

    with pytest.raises(NotImplementedError, match="SQUARED_DIFFERENCE"):
        TFLiteNet(Fake())
