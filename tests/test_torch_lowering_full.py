"""The lowering's full-range ops and the rest of the compiler surface, on
the CPU against tpu_face.compiler.

* RESIZE_BILINEAR (``_resize_bilinear``) against JAX's at the FULL
  graph's three shapes (6->12 at C=96, 12->24 at C=64, 24->48 at C=48,
  half-pixel centres) and at the two other flag settings (align corners;
  neither), and at a non-integer ratio: max abs 1e-6 on unit-scale
  inputs.
* DEPTH_TO_SPACE against JAX's at FULL_SPARSE's two shapes: bit-exact.
* The FULL and FULL_SPARSE nets against ``build_jax_fn`` on the same
  seeded input at batch 2: max abs 2e-4 in f32 (tests/test_net_parity.py's
  detector tolerance), 2e-2 * max|JAX output| in bf16 (as
  tests/test_torch_bf16.py holds BACK); neither graph has a residual run
  for the fused kernel.
* ``graph_flops`` equal to JAX's, as integers, on all seven graphs.
* ``Graph(collapse_separable=True)`` and with a predicate: JAX's op list
  (40 collapsed pairs in each full-range graph), and the collapsed nets
  within 2e-4 of JAX's collapsed nets; a collapsed BACK graph has no run
  left for the fused kernel.
* ``load_model_fn`` gives the graph and a net on the asked device, and
  needs the card unless told otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import build_jax_fn
from tpu_face.compiler import graph_flops as jax_graph_flops
from tpu_face.compiler import lowering as jlow
from tpu_face_torch.compiler import (Graph, TFLiteNet, graph_flops,
                                     load_model_fn)
from tpu_face_torch.compiler import lowering as tlow
from tpu_face_torch.models.face_detection import _DATA_DIR

FULL = ("face_detection_full_range", "face_detection_full_range_sparse")
GRAPHS = ("face_detection_back", "face_detection_front",
          "face_detection_short_range") + FULL + ("face_landmark",
                                                  "iris_landmark")
F32_TOL = 2e-4
BF16_TOL = 2e-2          # x max|JAX output|


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("hw,out,c,flags", [
    ((6, 6), (12, 12), 96, (False, True)),
    ((12, 12), (24, 24), 64, (False, True)),
    ((24, 24), (48, 48), 48, (False, True)),
    ((6, 6), (12, 12), 8, (True, False)),
    ((6, 6), (12, 12), 8, (False, False)),
    ((5, 7), (12, 9), 4, (False, True)),
    ((5, 7), (12, 9), 4, (True, False)),
])
def test_resize_bilinear_matches_jax(hw, out, c, flags):
    x = np.random.default_rng(c).uniform(-1, 1, (2,) + hw + (c,)).astype(
        np.float32)
    want = np.asarray(jlow._resize_bilinear(jnp.asarray(x), out, *flags))
    got = tlow._resize_bilinear(_nchw(x), out, *flags)
    assert tuple(got.shape) == (2, c) + out
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("c", [4, 64])
def test_depth_to_space_matches_jax(c):
    x = np.random.default_rng(c).normal(size=(2, 24, 24, c)).astype(
        np.float32)
    want = np.asarray(jlow._depth_to_space(jnp.asarray(x), 2))
    got = tlow._depth_to_space(_nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def full_graphs():
    return {n: (JaxGraph(_DATA_DIR / f"{n}.npz"),
                Graph(_DATA_DIR / f"{n}.npz")) for n in FULL}


def _input(graph, seed=0):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (2,) + tuple(graph.input_shape[1:])).astype(np.float32)


def _net_err(tnet, jg, x, compute_dtype=jnp.float32):
    want = jax.jit(build_jax_fn(jg, compute_dtype=compute_dtype))(x)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x))
    assert len(got) == len(want)
    errs = []
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        errs.append((float(np.abs(g.numpy() - w).max()),
                     float(np.abs(w).max())))
    return errs


@pytest.mark.parametrize("name", FULL)
def test_full_range_net_matches_build_jax_fn(full_graphs, name):
    jg, tg = full_graphs[name]
    net = TFLiteNet(tg).eval()
    assert net.runs == [] and net.fused_launches() == 0
    for err, _ in _net_err(net, jg, _input(jg)):
        assert err <= F32_TOL, (name, err)


@pytest.mark.parametrize("name", FULL)
def test_full_range_net_matches_build_jax_fn_bf16(full_graphs, name):
    jg, tg = full_graphs[name]
    net = TFLiteNet(tg, compute_dtype=torch.bfloat16).eval()
    for err, top in _net_err(net, jg, _input(jg, 1), jnp.bfloat16):
        assert err <= BF16_TOL * top, (name, err, top)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_flops_match_jax(name):
    path = _DATA_DIR / f"{name}.npz"
    want = jax_graph_flops(JaxGraph(path), batch=3)
    got = graph_flops(Graph(path), batch=3)
    assert isinstance(got, int) and got == want > 0


def _pairs_pred(ci, co, h_out):
    """Collapse only the pairs at the high-resolution layers."""
    return h_out >= 24


@pytest.mark.parametrize("name", FULL + ("face_detection_back",))
@pytest.mark.parametrize("collapse", [True, _pairs_pred])
def test_collapse_separable_matches_jax(name, collapse):
    path = _DATA_DIR / f"{name}.npz"
    jg = JaxGraph(path, collapse_separable=collapse)
    tg = Graph(path, collapse_separable=collapse)
    assert tg.ops == jg.ops
    assert [t["shape"] for t in tg.tensors] == [t["shape"]
                                                for t in jg.tensors]
    folded = len(Graph(path).ops)
    if collapse is True and name in FULL:
        assert folded - len(tg.ops) == 40
    assert len(tg.ops) < folded
    net = TFLiteNet(tg).eval()
    if collapse is True:
        # no depthwise is left to start a run: a collapsed graph runs op
        # by op
        assert net.runs == []
    for err, _ in _net_err(net, jg, _input(jg, 2)):
        assert err <= F32_TOL, (name, err)


def test_load_model_fn(full_graphs):
    path = _DATA_DIR / "face_detection_full_range.npz"
    graph, net = load_model_fn(path, device="cpu")
    assert isinstance(graph, Graph) and isinstance(net, TFLiteNet)
    assert graph.input_shape == (1, 192, 192, 3)
    assert not net.training and net.compute_dtype == torch.float32
    jg, _ = full_graphs["face_detection_full_range"]
    for err, _ in _net_err(net, jg, _input(jg, 3)):
        assert err <= F32_TOL, err
    _, net16 = load_model_fn(path, compute_dtype=torch.bfloat16,
                             device="cpu")
    assert {b.dtype for b in net16.buffers()} == {torch.bfloat16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_model_fn(path)
