"""The split-TF32 3x3 convolution kernel (``csrc/conv3x3_tc.cu``) on a CUDA
card (each test skips without one; run on the card with ``python -m
pytest tests/test_torch_conv_tc_card.py -q``).

* At every shape R100 routes to it at 128 crops (``SHAPES``), against an
  f64 convolution: its largest error, over the largest magnitude of the
  f64 output, is at most ``ERR_RATIO`` times cuDNN's f32 convolution's
  (TF32 off) at that shape; a 1xTF32 convolution (the kernel with TF32
  allowed, one product a step) fails that same bound.
* Layout, borders and stride 2: on integer operands, whose products and
  sums f32 holds exactly, it equals the f64 convolution bit for bit at
  strides 1 and 2, paddings 0 and 1, odd sizes and ragged last tiles,
  its output channels_last.
* The input affine, at the shape of each of R100's 49 first convs
  (``CONV1_SHAPES``), in the split and the TF32 mode: the kernel reading
  x through scale and shift equals ATen's ``x * scale``, then ``+
  shift``, then the kernel, bit for bit, the padding zero under a large
  shift.
* Launches: one ``EmbedCascade`` call on R100 adds 98 to ``LAUNCHES`` (one
  a routed conv), a ``FaceCascade`` call none.
* Captured in a CUDA graph, its replay equals the eager call, alone and
  in a net whose first conv absorbs its BatchNorm.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch import exact_f32
from tpu_face_torch.compiler.lowering import TFLiteNet, _fold_pads_into_convs
from tpu_face_torch.models.face_detection import FaceDetectionModel
from tpu_face_torch.ops import conv_tc
from tpu_face_torch.pipeline import EmbedCascade, FaceCascade

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from models import iresnet as gen  # noqa: E402

SEED = 2**31 + 31
CL = torch.channels_last
CROPS = 128
# (side, Cin, Cout, stride) of each conv R100 routes (its 98 in 12 shapes)
SHAPES = [(112, 64, 64, 1), (112, 64, 64, 2), (56, 64, 64, 1),
          (56, 64, 128, 1), (56, 128, 128, 2), (28, 128, 128, 1),
          (28, 128, 256, 1), (28, 256, 256, 2), (14, 256, 256, 1),
          (14, 256, 512, 1), (14, 512, 512, 2), (7, 512, 512, 1)]
# (side, Cin, Cout) of R100's first conv of a unit (stride 1), each of
# which reads its unit's BatchNorm through the input affine
CONV1_SHAPES = [(112, 64, 64), (56, 64, 64), (56, 64, 128), (28, 128, 128),
                (28, 128, 256), (14, 256, 256), (14, 256, 512),
                (7, 512, 512)]
# the kernel's error against cuDNN's f32 one: split TF32 drops a_lo*b_lo
# (~2^-22 of a product) and the tensor cores sum each k8 step in their
# own order, so its error is of f32's size, not TF32's (~2^-11, ~1000x)
ERR_RATIO = 4.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with exact_f32():
        yield torch.device("cuda", 0)


def _operands(b, side, ci, co, device, seed):
    gen_ = torch.Generator(device).manual_seed(seed)
    x = torch.randn(b, ci, side, side, device=device, generator=gen_)
    w = torch.randn(co, ci, 3, 3, device=device, generator=gen_)
    return x.contiguous(memory_format=CL), w / (3 * ci ** 0.5)


def _rel_err(y, want):
    return float((y.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("side,ci,co,stride", SHAPES)
def test_error_within_cudnn_f32(card, side, ci, co, stride):
    x, w = _operands(CROPS, side, ci, co, card, side + ci + co + stride)
    hi, lo = conv_tc.kernel_weights(w)
    with torch.inference_mode():
        want = F.conv2d(x.double(), w.double(), None, stride, 1)
        got = conv_tc.conv3x3_tc(x, w, hi, lo, stride, 1)
        cudnn = F.conv2d(x, w, None, stride, 1)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            tf32 = conv_tc.conv3x3_tc(x, w, hi, lo, stride, 1)
    torch.cuda.synchronize()
    errs = {name: _rel_err(y, want) for name, y in
            (("kernel", got), ("cudnn_f32", cudnn), ("tf32", tf32))}
    bound = ERR_RATIO * errs["cudnn_f32"]
    assert errs["kernel"] <= bound, errs
    assert errs["tf32"] > bound, errs


@pytest.mark.parametrize("b,side,ci,co", [(3, 13, 64, 64), (2, 7, 96, 192),
                                          (1, 20, 128, 128)])
def test_exact_on_integers_borders_and_stride(card, b, side, ci, co):
    gen_ = torch.Generator(card).manual_seed(b * side)
    x = torch.randint(-4, 5, (b, ci, side, side + 1), device=card,
                      generator=gen_).float().contiguous(memory_format=CL)
    w = torch.randint(-4, 5, (co, ci, 3, 3), device=card,
                      generator=gen_).float()
    hi, lo = conv_tc.kernel_weights(w)
    assert not lo.any()
    for stride in (1, 2):
        for pad in (0, 1):
            with torch.inference_mode():
                got = conv_tc.conv3x3_tc(x, w, hi, lo, stride, pad)
                want = F.conv2d(x.double(), w.double(), None, stride, pad)
            assert got.is_contiguous(memory_format=CL)
            assert torch.equal(got.double(), want), (stride, pad)


@pytest.mark.parametrize("side,ci,co", CONV1_SHAPES)
def test_affine_equals_the_two_ops_then_the_kernel(card, side, ci, co):
    x, w = _operands(CROPS, side, ci, co, card, side * ci + co)
    hi, lo = conv_tc.kernel_weights(w)
    gen_ = torch.Generator(card).manual_seed(co)
    scale = torch.rand(ci, device=card, generator=gen_) + 0.5
    # a border tap that took the shift in place of 0 would move the
    # output by ~3 * |w|
    shift = 3.0 + torch.rand(ci, device=card, generator=gen_)
    with torch.inference_mode():
        for tf32 in (False, True):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                t = x * scale[:, None, None]
                want = conv_tc.conv3x3_tc(t + shift[:, None, None], w, hi,
                                          lo, 1, 1)
                got = conv_tc.conv3x3_tc(x, w, hi, lo, 1, 1, scale, shift)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=CL)
            assert torch.equal(got, want), (tf32, float(
                (got - want).abs().max()))


def test_launches_a_routed_conv_each(card, tmp_path):
    made = gen.write(tmp_path, SEED, files=(gen.GRAPH_FILE,))
    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 360, 640, 3), dtype=np.uint8)).to(card)
    size = (640, 360)
    embed = EmbedCascade(FaceDetectionModel.FULL_SPARSE,
                         embed_model_path=str(made), max_faces=4,
                         device=card)
    assert len(embed._embed_net.tc_convs) == 98
    cascade = FaceCascade(device=card)
    for program, routed in ((embed, 98), (cascade, 0)):
        before = conv_tc.LAUNCHES
        with torch.inference_mode():
            program._forward(frames, size)
        torch.cuda.synchronize()
        assert conv_tc.LAUNCHES - before == routed


def _replay(fn):
    """fn's result from a CUDA graph's replay, captured after a warm-up
    on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for t in out if isinstance(out, tuple) else (out,):
        t.zero_()
    graph.replay()
    return out


def test_graph_replay_equals_eager(card):
    x, w = _operands(32, 28, 128, 256, card, 5)
    hi, lo = conv_tc.kernel_weights(w)
    with torch.inference_mode():
        eager = conv_tc.conv3x3_tc(x, w, hi, lo, 1, 1)
        out = _replay(lambda: conv_tc.conv3x3_tc(x, w, hi, lo, 1, 1))
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    # R100's second stage's first unit (64 -> 128, stride 2) as a net:
    # its first conv reads the unit's input through bn1's affine
    p = gen.PUBLISHED
    wts = gen.draw_weights(SEED, [1, 1, 1, 1], p["widths"], p["embedding"],
                           p["input"])
    meta, consts = gen.unit_graph(wts, "layer2.0", 56, 2)
    consts = {int(k[1:]): v for k, v in consts.items()}
    graph = SimpleNamespace(
        tensors=meta["tensors"], consts=consts, inputs=meta["inputs"],
        outputs=meta["outputs"],
        ops=_fold_pads_into_convs(meta["ops"], consts, set(meta["outputs"])))
    net = TFLiteNet(graph).to(card).eval()
    assert [rec["affine"] is not None for rec in net.tc_convs.values()] == [
        True, False]
    x = torch.randn(16, 56, 56, 64, device=card,
                    generator=torch.Generator(card).manual_seed(6))
    with torch.inference_mode():
        eager = net(x)
        out = _replay(lambda: net(x))
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0])
