"""The convolution epilogue kernel (``csrc/conv_epilogue.cu``) on a CUDA
card (each test skips without one; run on the card with ``python -m
pytest tests/test_torch_epilogue_card.py -q``).

* Every bundled f32 graph gives bit-identical outputs with its chains on
  the kernel and op by op, at batch 1 and at an odd batch, its input
  NHWC (the nets' body channels_last) and channel-major (NCHW).
* The kernel alone equals its plain version (ATen's op-by-op sequence on
  the card), values and output strides, on a skip narrower than y, on
  channel counts that are no multiple of 4, on y and skip in different
  layouts, with each activation.
* A tensor of more than 2^31 elements runs as launches of whole images
  that each index fewer, and equals the plain version throughout.
* A ``FaceCascade``'s captured program replays the eager call bit for
  bit, and the replay of the f32 mesh and iris nets runs no ATen clamp
  or mul kernel.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch import exact_f32
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet
from tpu_face_torch.ops import conv_epilogue as ce
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

DATA = Path(__file__).resolve().parents[1] / "tpu_face" / "data"
GRAPHS = ("face_detection_back", "face_detection_front",
          "face_detection_short_range", "face_detection_full_range",
          "face_detection_full_range_sparse", "face_landmark",
          "iris_landmark", "demo/face_embeddings")
ROT = Path(__file__).resolve().parents[1] / "assets" / "rotated"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with exact_f32():
        yield torch.device("cuda", 0)


@pytest.mark.parametrize("name", GRAPHS)
def test_net_bit_identical_to_op_by_op(card, name):
    graph = Graph(DATA / f"{name}.npz")
    fused = TFLiteNet(graph).to(card).eval()
    plain = TFLiteNet(graph, fuse_epilogues=False).to(card).eval()
    assert fused.chains and not plain.chains
    rng = np.random.default_rng(7)
    for batch in (1, 7):
        for channel_major in (False, True):
            x = torch.from_numpy(rng.random(
                (batch,) + graph.input_shape[1:], dtype=np.float32)).to(card)
            if channel_major:
                x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            before = ce.LAUNCHES
            with torch.inference_mode():
                got, want = fused(x), plain(x)
            torch.cuda.synchronize()
            assert ce.LAUNCHES - before == len(fused.chains)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, batch, channel_major)


def _operands(b, c, cs, h, w, y_cl, s_cl, seed):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(b, c, h, w, generator=gen).cuda()
    skip = torch.randn(b, cs, h, w, generator=gen).cuda()
    bias = torch.randn(c, generator=gen).cuda()
    alpha = torch.randn(c, generator=gen).cuda()
    y[0, 0, 0, 0] = float("nan")
    fmt = {True: torch.channels_last, False: torch.contiguous_format}
    return (y.contiguous(memory_format=fmt[y_cl]),
            skip.contiguous(memory_format=fmt[s_cl]), bias, alpha)


@pytest.mark.parametrize("shape", [(3, 64, 64, 17, 19), (2, 7, 5, 9, 11),
                                   (4, 24, 24, 16, 16), (5, 12, 8, 1, 1)],
                         ids=["wide", "odd", "square", "pixel"])
@pytest.mark.parametrize("y_cl,s_cl", [(False, False), (True, True),
                                       (True, False), (False, True)])
def test_kernel_matches_plain(card, shape, y_cl, s_cl):
    b, c, cs, h, w = shape
    y, skip, bias, alpha = _operands(b, c, cs, h, w, y_cl, s_cl, sum(shape))
    cases = [(bias, skip, None, "NONE", False),
             (bias, skip, alpha, "PRELU", False),
             (bias, skip, alpha, "PRELU", True),
             (None, skip, None, "RELU", True),
             (bias, None, None, "RELU6", False),
             (bias, None, alpha, "PRELU", False)]
    for bi, sk, al, act, first in cases:
        got = ce.conv_epilogue(y, bi, sk, al, act, first)
        want = ce.conv_epilogue_plain(y, bi, sk, al, ce.ACTS[act], first)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan()), (act, first)
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), (
            act, first)
        assert got.stride() == want.stride(), (act, first)


@pytest.mark.parametrize("y_cl", [False, True], ids=["flat", "tiled"])
def test_kernel_over_2_31_elements(card, y_cl):
    # 4,097 images of 8 x 256 x 256: 2^31 + 2^19 elements, a launch of
    # 4,095 images and one of two from a 64-bit offset
    b, c, h = 4097, 8, 256
    gen = torch.Generator(device=card).manual_seed(11)
    y = torch.randn(b, c, h, h, device=card, generator=gen)
    if y_cl:
        y = y.contiguous(memory_format=torch.channels_last)
    skip = torch.randn(b, c // 2, h, h, device=card, generator=gen)
    bias = torch.randn(c, device=card, generator=gen)
    alpha = torch.randn(c, device=card, generator=gen)
    out = ce.conv_epilogue(y, bias, skip, alpha, "PRELU")
    for n0 in range(0, b, 512):
        part = slice(n0, n0 + 512)
        want = ce.conv_epilogue_plain(y[part], bias, skip[part], alpha,
                                      ce.ACTS["PRELU"])
        assert torch.equal(out[part], want), n0


def test_kernel_refuses_bad_operands(card):
    y = torch.zeros(2, 8, 4, 4, device=card)
    with pytest.raises(ValueError):
        ce.conv_epilogue(y, skip=torch.zeros(2, 9, 4, 4, device=card))
    with pytest.raises(ValueError):
        ce.conv_epilogue(y[:, :, :, :3])
    with pytest.raises(ValueError):
        ce.conv_epilogue(y, act="PRELU")


def test_cascade_replay_matches_eager_without_prelu_kernels(card,
                                                            monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv("TEARDOWN_CUPTI", "1")
    imgs = [load_image(ROT / n) for n in ("man_rotm15.png", "man_rotp30.png")]
    x = torch.from_numpy(np.stack(imgs * 2)).to(card)
    cascade = FaceCascade(device=card)
    first = cascade(x)
    with torch.inference_mode():
        eager = cascade._forward(x, (x.shape[2], x.shape[1]))
    for res in (first, cascade(x)):
        for f in res._fields:
            a, e = getattr(res, f), getattr(eager, f)
            assert torch.equal(torch.nan_to_num(a, nan=7.0),
                               torch.nan_to_num(e, nan=7.0)), f
    nets = {"mesh": (cascade._mesh_net, cascade.mesh_h, cascade.mesh_w),
            "iris": (cascade._iris_net, cascade.iris_h, cascade.iris_w)}
    for name, (net, h, w) in nets.items():
        xin = torch.rand(8, h, w, 3, device=card)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode():
            net(xin)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                net(xin)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any("epilogue_kernel" in k for k in kernels), name
        assert not [k for k in kernels
                    if "clamp" in k.lower() or "MulFunctor" in k], name
