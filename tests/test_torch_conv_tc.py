"""The split-TF32 3x3 convolution (``ops.conv_tc``,
``csrc/conv3x3_tc.cu``) and its route in the lowered nets, on the CPU:

* the operator's plain version is ``F.conv2d`` at strides 1 and 2 and
  paddings 0 and 1, its output channels_last, from either input layout,
  and with the input affine ``F.conv2d`` of ``x * scale + shift``, bit
  for bit (the padding zero, not the shift); the operand checks;
* the routing rule (``conv_tc.routes``): a net's ``tc_convs`` holds 98
  convolutions on ArcFace's R100 (``benchmark/models/iresnet.py``, both
  3x3 of each of its 49 units; the stem and the four 1x1 shortcuts stay
  on ``F.conv2d``), none on any bundled graph or on a bf16 net, and the
  rule's bounds one by one;
* the absorbed affines (``lowering._input_affine``): R100's 49 leading
  BatchNorms (each unit's ``bn1`` MUL and ADD) ride in their conv, no
  other net's MUL or ADD does, and the forward runs none of the 49
  pairs; on small graphs, which pairs qualify and that the net still
  computes the two ops' values, also where the conv falls back to
  ``F.conv2d``;
* a net with routed convolutions hands each one a channels_last input
  and still equals the plain reference; a routed SAME-padded stride-2
  convolution at a size where its pads come out uneven goes to
  ``F.conv2d``;
* every public entry point (the pipeline's cached call, the standalone
  model, an ``aot`` artifact loaded and attached) runs the routed
  convolutions with TF32 off, whatever cuDNN's flag is outside, so the
  kernel's one-product mode is never taken on the port's own paths;
* the weight split: ``hi + lo`` is w within 2^-22 relative, both parts
  TF32 values, and ``kernel_weights`` holds every weight once, where the
  kernel's tile order puts it;
* the tile plan at R100's shapes and others;
* the fake implementation gives ``torch.export`` the channels_last
  strides, and the exported program runs as the live call.
The kernel itself is held to an f64 convolution on the card by
``tests/test_torch_conv_tc_card.py``.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_kernel_abi import ENTRIES
from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch import aot
from tpu_face_torch.compiler.lowering import (Graph, TFLiteNet,
                                              _fold_pads_into_convs)
from tpu_face_torch.models.face_detection import FaceDetectionModel
from tpu_face_torch.models.face_embeddings import FaceEmbeddings
from tpu_face_torch.ops import conv_tc, wgmma_tf32
from tpu_face_torch.pipeline import EmbedCascade

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tpu_face" / "data"
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from models import iresnet as gen  # noqa: E402
from reference import iresnet as ref  # noqa: E402

SEED = 2**31 + 20
GRAPHS = ("face_detection_back", "face_detection_front",
          "face_detection_short_range", "face_detection_full_range",
          "face_detection_full_range_sparse", "face_landmark",
          "iris_landmark", "demo/face_embeddings")
CL = torch.channels_last


def _operands(b, ci, co, h, w, seed=0):
    gen_ = torch.Generator().manual_seed(seed)
    x = torch.randn(b, ci, h, w, generator=gen_).contiguous(memory_format=CL)
    wt = torch.randn(co, ci, 3, 3, generator=gen_) / (3 * ci ** 0.5)
    return x, wt


@pytest.mark.parametrize("stride,pad", [(1, 0), (1, 1), (2, 0), (2, 1)])
@pytest.mark.parametrize("channels_last", [True, False])
def test_plain_is_conv2d(stride, pad, channels_last):
    x, w = _operands(2, 64, 128, 9, 8)
    if not channels_last:
        x = x.contiguous()
    hi, lo = conv_tc.kernel_weights(w)
    got = conv_tc.conv3x3_tc(x, w, hi, lo, stride, pad)
    want = F.conv2d(x, w, None, stride, pad)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=CL)
    assert got.shape[2:] == (conv_tc.out_size(9, stride, pad),
                             conv_tc.out_size(8, stride, pad))


@pytest.mark.parametrize("stride,pad", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_plain_with_affine_is_conv2d_of_the_two_ops(stride, pad):
    x, w = _operands(2, 64, 128, 9, 8, seed=stride + 2 * pad)
    hi, lo = conv_tc.kernel_weights(w)
    gen_ = torch.Generator().manual_seed(7)
    scale = torch.rand(64, generator=gen_) + 0.5
    # a border tap that took the shift in place of 0 would move the
    # output by ~3 * |w|
    shift = torch.full((64,), 3.0) + torch.rand(64, generator=gen_)
    got = conv_tc.conv3x3_tc(x, w, hi, lo, stride, pad, scale, shift)
    t = x * scale[:, None, None]
    want = F.conv2d(t + shift[:, None, None], w, None, stride, pad)
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=CL)
    if pad:
        # the affine applied to the zero padding too
        padded = F.pad(x, (1, 1, 1, 1)) * scale[:, None, None]
        wrong = F.conv2d(padded + shift[:, None, None], w, None, stride, 0)
        assert not torch.allclose(got, wrong, atol=1e-2)


def test_operand_checks():
    x, w = _operands(1, 64, 64, 5, 5)
    hi, lo = conv_tc.kernel_weights(w)
    with pytest.raises(ValueError, match="stride"):
        conv_tc.conv3x3_tc(x, w, hi, lo, 3, 1)
    with pytest.raises(ValueError, match="stride"):
        conv_tc.conv3x3_tc(x, w, hi, lo, 1, 2)
    with pytest.raises(ValueError, match="Cout"):
        conv_tc.conv3x3_tc(x, w[:32], hi, lo, 1, 1)
    with pytest.raises(ValueError, match="w_hi"):
        conv_tc.conv3x3_tc(x, w, hi[:, :32], lo, 1, 1)
    with pytest.raises(ValueError, match="w_lo"):
        conv_tc.conv3x3_tc(x, w, hi, lo.transpose(0, 1), 1, 1)
    with pytest.raises(ValueError, match="smaller"):
        conv_tc.conv3x3_tc(x[:, :, :2, :2], w, hi, lo, 1, 0)
    with pytest.raises(ValueError, match="f32"):
        conv_tc.conv3x3_tc(x.double(), w, hi, lo, 1, 1)
    scale, shift = torch.ones(64), torch.zeros(64)
    for bad, name in ((torch.ones(32), "scale"), (torch.ones(65), "scale"),
                      (torch.ones(64).double(), "scale"),
                      (torch.ones(64, device="meta"), "scale"),
                      (torch.ones(64, 2)[:, 0], "scale")):
        with pytest.raises(ValueError, match=name):
            conv_tc.conv3x3_tc(x, w, hi, lo, 1, 1, bad, shift)
        with pytest.raises(ValueError, match="shift"):
            conv_tc.conv3x3_tc(x, w, hi, lo, 1, 1, scale, bad)
    with pytest.raises(ValueError, match="together"):
        conv_tc.conv3x3_tc(x, w, hi, lo, 1, 1, scale, None)


# (OHWI weights, input channels, stride, dilation, pads, dtype) -> routed
RULE = {
    "r100_body": (((256, 3, 3, 256), 256, (1, 1), (1, 1), ((1, 1), (1, 1)),
                   torch.float32), True),
    "stride2_valid": (((128, 3, 3, 64), 64, (2, 2), (1, 1),
                       ((0, 0), (0, 0)), torch.float32), True),
    "bf16": (((256, 3, 3, 256), 256, (1, 1), (1, 1), ((1, 1), (1, 1)),
              torch.bfloat16), False),
    "cin_32": (((64, 3, 3, 32), 32, (1, 1), (1, 1), ((1, 1), (1, 1)),
                torch.float32), False),
    "cin_48": (((64, 3, 3, 48), 48, (1, 1), (1, 1), ((1, 1), (1, 1)),
                torch.float32), False),
    "cout_96": (((96, 3, 3, 64), 64, (1, 1), (1, 1), ((1, 1), (1, 1)),
                 torch.float32), False),
    "one_by_one": (((64, 1, 1, 64), 64, (1, 1), (1, 1), ((0, 0), (0, 0)),
                    torch.float32), False),
    "five_by_five": (((64, 5, 5, 64), 64, (1, 1), (1, 1), ((2, 2), (2, 2)),
                      torch.float32), False),
    "grouped": (((64, 3, 3, 64), 128, (1, 1), (1, 1), ((1, 1), (1, 1)),
                 torch.float32), False),
    "mixed_stride": (((64, 3, 3, 64), 64, (1, 2), (1, 1), ((1, 1), (1, 1)),
                      torch.float32), False),
    "stride_3": (((64, 3, 3, 64), 64, (3, 3), (1, 1), ((1, 1), (1, 1)),
                  torch.float32), False),
    "dilation_2": (((64, 3, 3, 64), 64, (1, 1), (2, 2), ((2, 2), (2, 2)),
                    torch.float32), False),
    "asymmetric_same": (((64, 3, 3, 64), 64, (2, 2), (1, 1),
                         ((0, 1), (0, 1)), torch.float32), False),
    "pad_2": (((64, 3, 3, 64), 64, (1, 1), (1, 1), ((2, 2), (2, 2)),
               torch.float32), False),
}


@pytest.mark.parametrize("case", RULE)
def test_routing_rule(case):
    args, routed = RULE[case]
    assert conv_tc.routes(*args) is routed


@pytest.fixture(scope="module")
def r100_view():
    """R100 at the published sizes as a graph (PADs folded), in memory."""
    p = gen.PUBLISHED
    w = gen.draw_weights(SEED, p["blocks"], p["widths"], p["embedding"],
                         p["input"])
    graph, consts = gen.graph_from_weights(w, p["blocks"], p["widths"],
                                           p["embedding"], p["input"])
    consts = {int(k[1:]): v for k, v in consts.items()}
    return SimpleNamespace(
        tensors=graph["tensors"], consts=consts, inputs=graph["inputs"],
        outputs=graph["outputs"],
        ops=_fold_pads_into_convs(graph["ops"], consts,
                                  set(graph["outputs"])))


@pytest.mark.parametrize("name,dtype,routed", [
    ("r100", torch.float32, 98), ("r100", torch.bfloat16, 0),
    *((g, torch.float32, 0) for g in GRAPHS),
    ("face_landmark", torch.bfloat16, 0)])
def test_routed_convolutions_counted(request, name, dtype, routed):
    graph = (request.getfixturevalue("r100_view") if name == "r100"
             else Graph(DATA / f"{name}.npz"))
    net = TFLiteNet(graph, compute_dtype=dtype)
    assert len(net.tc_convs) == routed
    # each R100 unit's leading BN (bn1) rides in its first conv; no other
    # net absorbs a MUL or an ADD
    affine = [rec for rec in net.tc_convs.values() if rec["affine"]]
    assert len(affine) == (49 if routed else 0)
    names = [graph.tensors[graph.ops[i]["outputs"][0]].get("name", "")
             for i, n in enumerate(graph.ops)
             if i not in net._skip and n["op"] in ("MUL", "ADD")]
    absorbed = {graph.tensors[graph.ops[j]["outputs"][0]]["name"]
                for rec in affine for j in rec["affine"]}
    if name == "r100" and routed:
        assert not any(".bn1/" in n for n in names)
        assert absorbed == {f"layer{s + 1}.{b}.bn1/{op}"
                            for s, n in enumerate(gen.PUBLISHED["blocks"])
                            for b in range(n) for op in ("mul", "add")}
        # the input map's pair (before the stem, which does not route)
        # and the last BN's (before the flatten) still run
        assert {"input_map/mul", "input_map/add", "bn2/mul",
                "bn2/add"} <= set(names)
        for rec in affine:
            mul = graph.ops[rec["affine"][0]]
            assert rec["input"] in mul["inputs"]
    if name == "r100" and routed:
        # both 3x3 convs of every unit; the stem (3 -> 64) and the four 1x1
        # shortcuts stay on F.conv2d
        convs = [i for i, n in enumerate(graph.ops) if n["op"] == "CONV_2D"]
        left = [graph.consts[graph.ops[i]["inputs"][1]].shape
                for i in convs if i not in net.tc_convs]
        assert sorted(left) == sorted([(64, 3, 3, 3), (64, 1, 1, 64),
                                       (128, 1, 1, 64), (256, 1, 1, 128),
                                       (512, 1, 1, 256)])
        for i in net.tc_convs:
            assert graph.consts[graph.ops[i]["inputs"][1]].shape[1:3] == (
                3, 3)


def test_routed_net_holds_channels_last_and_matches_reference(
        tmp_path, monkeypatch):
    # widths / 4: three convs qualify (the stride-2 64 -> 64 of the third
    # stage, both of the fourth); Cin 16 and 32 do not
    shape = {"blocks": [1, 1, 1, 1], "widths": [16, 32, 64, 128],
             "embedding": 64, "size": 32}
    d = gen.write(tmp_path, SEED, shape["blocks"], shape["widths"],
                  shape["embedding"], shape["size"])
    net = TFLiteNet(Graph(d / gen.GRAPH_FILE)).eval()
    assert len(net.tc_convs) == 3
    # the fourth stage's first conv (64 -> 128) takes its bn1
    assert sum(rec["affine"] is not None
               for rec in net.tc_convs.values()) == 1
    seen = []
    real = conv_tc.conv3x3_tc

    def spy(x, *args):
        seen.append(x.is_contiguous(memory_format=CL))
        return real(x, *args)

    monkeypatch.setattr(conv_tc, "conv3x3_tc", spy)
    x = torch.rand(2, 32, 32, 3)
    with torch.inference_mode():
        (got,) = net(x)
        want = ref.forward(ref.load(d / gen.WEIGHTS_FILE, "cpu"),
                           x.permute(0, 3, 1, 2).contiguous())
    assert seen == [True] * 3
    torch.testing.assert_close(F.normalize(got, dim=-1),
                               F.normalize(want, dim=-1), atol=2e-5, rtol=0)


def _same_stride2_graph(path, side):
    """One SAME-padded 3x3 stride-2 CONV_2D, 64 -> 64 channels, on a
    [1, side, side, 64] input."""
    rng = np.random.default_rng(side)
    meta = {
        "inputs": [0], "outputs": [3],
        "tensors": [{"shape": s, "dtype": "float32"} for s in (
            [1, side, side, 64], [64, 3, 3, 64], [64],
            [1, -(-side // 2), -(-side // 2), 64])],
        "ops": [{"op": "CONV_2D", "inputs": [0, 1, 2], "outputs": [3],
                 "options": {"stride": [2, 2], "dilation": [1, 1],
                             "padding": "SAME", "activation": "RELU"}}]}
    np.savez(path, __graph__=json.dumps(meta),
             t1=rng.standard_normal((64, 3, 3, 64), dtype=np.float32) / 24,
             t2=rng.standard_normal(64, dtype=np.float32))
    return Graph(path)


@pytest.mark.parametrize("side,routed", [(9, 1), (10, 0)])
def test_same_padding_routes_only_even_pads(tmp_path, monkeypatch, side,
                                            routed):
    # routed by the graph's odd size, where SAME pads (1, 1); at an even
    # size it pads (0, 1), which the kernel cannot take
    graph = _same_stride2_graph(tmp_path / "g.npz", 9)
    net = TFLiteNet(graph).eval()
    assert len(net.tc_convs) == 1
    calls = []
    real = conv_tc.conv3x3_tc
    monkeypatch.setattr(conv_tc, "conv3x3_tc",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(2, side, side, 64, generator=torch.Generator()
                    .manual_seed(side))
    with torch.inference_mode():
        (got,) = net(x)
    total = (-(-side // 2) - 1) * 2 + 3 - side        # SAME's whole pad
    want = F.relu(F.conv2d(
        F.pad(x.permute(0, 3, 1, 2), (total // 2, total - total // 2) * 2),
        torch.from_numpy(graph.consts[1]).permute(0, 3, 1, 2),
        torch.from_numpy(graph.consts[2]), stride=2)).permute(0, 2, 3, 1)
    assert len(calls) == routed
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


class _TF32Flags(TorchDispatchMode):
    """Records cuDNN's TF32 flag, which the kernel reads at its launch,
    at each call of the ``conv3x3_tc`` operator."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.tpu_face_torch.conv3x3_tc.default:
            self.seen.append(torch.backends.cudnn.allow_tf32)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def entry_points(tmp_path_factory):
    """{name: call} of each public entry point over a small net with
    three routed convolutions (widths / 4 of R100's)."""
    tmp = tmp_path_factory.mktemp("conv_tc_entries")
    d = gen.write(tmp, SEED, [1, 1, 1, 1], [16, 32, 64, 128], 64, 32)
    frames = np.random.default_rng(0).integers(0, 256, (1, 96, 128, 3),
                                               dtype=np.uint8)

    def cascade():
        return EmbedCascade(FaceDetectionModel.FULL_SPARSE,
                            embed_model_path=str(d), max_faces=2,
                            device="cpu")

    live = cascade()
    saved = aot.save(live, tmp / "embed.aot", batch=1, height=96, width=128)
    loaded = aot.load(saved)
    attached = cascade()
    aot.attach(attached, saved)
    model = FaceEmbeddings(str(d), device="cpu")
    return {"pipeline": lambda: live.infer_batch(frames),
            "model": lambda: model.infer_batch(frames, [(8, 8, 72, 80)]),
            "aot_load": lambda: loaded(torch.from_numpy(frames)),
            "aot_attach": lambda: attached.infer_batch(frames)}


@pytest.mark.parametrize("name", ["pipeline", "model", "aot_load",
                                  "aot_attach"])
def test_entry_points_run_routed_convs_without_tf32(entry_points, name):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True       # cuDNN's own default
    try:
        with _TF32Flags() as flags:
            entry_points[name]()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert flags.seen == [False] * 3, (name, flags.seen)


def test_weight_split():
    gen_ = torch.Generator().manual_seed(1)
    w = torch.randn(128, 64, 3, 3, generator=gen_) * torch.exp(
        4 * torch.randn(128, 64, 3, 3, generator=gen_))
    hi, lo = wgmma_tf32.split_tf32(w)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
    # hi alone is TF32's rounding: within 2^-11 relative
    assert bool(((hi.double() - w.double()).abs()
                 <= 2.0 ** -11 * w.double().abs()).all())


@pytest.mark.parametrize("co", [128, 64, 192])
def test_tile_order(co):
    """Each buffer holds every weight's part once, where the kernel reads
    it: undone here by the index formula of ``kernel_weights``."""
    gen_ = torch.Generator().manual_seed(co)
    w = torch.randn(co, 64, 3, 3, generator=gen_)
    hi, lo = wgmma_tf32.split_tf32(w)
    thi, tlo = conv_tc.kernel_weights(w)
    assert thi.shape == tlo.shape == (18, co, 32)
    # K step k, output channel n, slot s of the row: channel
    # 32 (k % 2) + 8 (s % 4) + ((s // 4) ^ (n % 8)) of tap k // 2
    k, n, s = torch.meshgrid(torch.arange(18), torch.arange(co),
                             torch.arange(32), indexing="ij")
    ci = 32 * (k % 2) + 8 * (s % 4) + ((s // 4) ^ (n % 8))
    tap = k // 2
    assert torch.equal(thi, hi[n, ci, tap // 3, tap % 3])
    assert torch.equal(tlo, lo[n, ci, tap // 3, tap % 3])
    assert torch.equal(thi.flatten().sort().values,
                       hi.flatten().sort().values)


@pytest.mark.parametrize("m,cout,bn", [
    (128 * 112 * 112, 64, 64), (128 * 56 * 56, 64, 64),
    (128 * 28 * 28, 128, 128), (128 * 14 * 14, 256, 128),
    (128 * 7 * 7, 512, 128), (5, 128, 128), (0, 64, 64), (300, 192, 64)])
def test_plan(m, cout, bn):
    got_bn, grid = wgmma_tf32.plan(m, cout, 132)
    assert got_bn == bn and cout % got_bn == 0
    tiles = -(-m // wgmma_tf32.TILES[got_bn]) * (cout // got_bn)
    assert grid == min(tiles, 132)


def test_export_gives_channels_last_strides():
    x, w = _operands(2, 64, 64, 6, 7)
    hi, lo = conv_tc.kernel_weights(w)

    class Conv(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name, t in (("w", w), ("hi", hi), ("lo", lo)):
                self.register_buffer(name, t)

        def forward(self, x):
            return conv_tc.conv3x3_tc(x, self.w, self.hi, self.lo, 2, 1)

    with torch.no_grad():
        prog = torch.export.export(Conv(), (x,))
    nodes = [n for n in prog.graph.nodes if n.op == "call_function"
             and "conv3x3_tc" in str(n.target)]
    assert len(nodes) == 1
    val = nodes[0].meta["val"]
    assert tuple(val.shape) == (2, 64, 3, 4)
    assert val.is_contiguous(memory_format=CL) and not val.is_contiguous()
    got = prog.module()(x)
    assert torch.equal(got, Conv()(x))


def test_abi_test_covers_the_entry_point():
    assert ("conv3x3_tc", "conv3x3_tc_f32") in ENTRIES
    # the input affine's operands follow the weights'
    src = (ROOT / "tpu_face_torch" / "csrc" / "conv3x3_tc.cu").read_text()
    assert ("conv3x3_tc_f32(const float* x, const float* w_hi,\n"
            "                              const float* w_lo, const float* "
            "scale,\n                              const float* shift,"
            in src)


def _affine_graph(path, scale_shape=(64,), shift_shape=(64,),
                  add_act="NONE", mul_output=False, shift_first=False,
                  hw=(6, 7), stride=1):
    """x [1, *hw, 64] -> MUL(x, scale) -> ADD(t, shift) -> a SAME 3x3
    CONV_2D 64 -> 64 of ``stride`` with a bias: the conv routes;
    ``mul_output`` makes the MUL's output a graph output too."""
    rng = np.random.default_rng(11)
    act = [1, *hw, 64]
    out = [1, *(-(-d // stride) for d in hw), 64]
    shapes = (act, list(scale_shape), act, list(shift_shape), act,
              [64, 3, 3, 64], [64], out)
    add_in = [3, 2] if shift_first else [2, 3]
    meta = {
        "inputs": [0], "outputs": [7, 2] if mul_output else [7],
        "tensors": [{"shape": s, "dtype": "float32"} for s in shapes],
        "ops": [{"op": "MUL", "inputs": [0, 1], "outputs": [2],
                 "options": {"activation": "NONE"}},
                {"op": "ADD", "inputs": add_in, "outputs": [4],
                 "options": {"activation": add_act}},
                {"op": "CONV_2D", "inputs": [4, 5, 6], "outputs": [7],
                 "options": {"stride": [stride, stride], "dilation": [1, 1],
                             "padding": "SAME", "activation": "NONE"}}]}
    np.savez(path, __graph__=json.dumps(meta),
             t1=rng.uniform(0.5, 1.5, scale_shape).astype(np.float32),
             t3=(3.0 + rng.uniform(0, 1, shift_shape)).astype(np.float32),
             t5=rng.standard_normal((64, 3, 3, 64), dtype=np.float32) / 24,
             t6=rng.standard_normal(64, dtype=np.float32))
    return Graph(path)


# graph variant -> whether the MUL and ADD ride in the conv
AFFINE_CASES = {
    "per_channel": ({}, True),
    "nhwc_shaped": ({"scale_shape": (1, 1, 1, 64),
                     "shift_shape": (1, 1, 64)}, True),
    "scalar": ({"scale_shape": (), "shift_shape": (1,)}, True),
    "shift_first": ({"shift_first": True}, True),
    "per_pixel": ({"scale_shape": (1, 6, 7, 64)}, False),
    "add_relu": ({"add_act": "RELU"}, False),
    "mul_read_twice": ({"mul_output": True}, False),
}


@pytest.mark.parametrize("case", AFFINE_CASES)
def test_input_affine_absorbed_where_it_qualifies(tmp_path, case):
    kwargs, absorbed = AFFINE_CASES[case]
    graph = _affine_graph(tmp_path / "g.npz", **kwargs)
    net = TFLiteNet(graph).eval()
    (rec,) = net.tc_convs.values()
    assert (rec["affine"] is not None) is absorbed
    assert rec["input"] == (0 if absorbed else 4)
    x = torch.randn(2, 6, 7, 64, generator=torch.Generator().manual_seed(2))
    c = {i: torch.from_numpy(graph.consts[i]) for i in (1, 3, 5, 6)}
    t = x * c[1]
    t = c[3] + t if kwargs.get("shift_first") else t + c[3]
    if kwargs.get("add_act") == "RELU":
        t = torch.relu(t)
    want = F.conv2d(t.permute(0, 3, 1, 2), c[5].permute(0, 3, 1, 2), c[6],
                    padding=1).permute(0, 2, 3, 1)
    with torch.inference_mode():
        got = net(x)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)



def test_input_affine_runs_before_the_uneven_fallback(tmp_path, monkeypatch):
    # routed by the graph's odd size; at an even size SAME pads (0, 1), so
    # F.conv2d takes the conv, after the absorbed MUL and ADD as two ops
    graph = _affine_graph(tmp_path / "g.npz", hw=(7, 7), stride=2)
    net = TFLiteNet(graph).eval()
    (rec,) = net.tc_convs.values()
    assert rec["affine"] is not None
    calls = []
    real = conv_tc.conv3x3_tc
    monkeypatch.setattr(conv_tc, "conv3x3_tc",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(2, 8, 8, 64, generator=torch.Generator().manual_seed(4))
    c = {i: torch.from_numpy(graph.consts[i]) for i in (1, 3, 5, 6)}
    t = (x * c[1] + c[3]).permute(0, 3, 1, 2)
    want = F.conv2d(F.pad(t, (0, 1, 0, 1)), c[5].permute(0, 3, 1, 2), c[6],
                    stride=2).permute(0, 2, 3, 1)
    with torch.inference_mode():
        (got,) = net(x)
    assert not calls
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
