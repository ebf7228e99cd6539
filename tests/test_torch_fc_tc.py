"""The split-TF32 token FC (``ops.fc_tc``, ``csrc/fc_tc.cu``) and its route
in the lowered nets, on the CPU:

* the routing rule (``fc_tc.routes``) case by case; ViT-L's 144 token FCs
  route (``benchmark/models/vit.py``: q, k, v, proj, fc1 and fc2 of each
  block, six in its ``block_graph``, 144 in the full graph at the
  published sizes), its two ``feature`` FCs (a row a
  sample) do not, nor R100's FC, nor any FC of a bf16 net or of the
  bundled nets (``TFLiteNet.tc_fcs`` empty);
* the weight split: ``hi + lo`` is w within 2^-22 relative, and
  ``kernel_weights`` holds every weight once, where the kernel's tile
  order puts it;
* the operator's plain version is ``F.linear``, then ``+ bias``, then the
  activation (NONE, RELU, RELU6), bit for bit, over rows of any leading
  shape; the operand checks;
* the fake implementation gives ``torch.export`` the output's shape, and
  the exported program runs as the live call;
* a ``TFLiteNet`` of the ViT block on the CPU computes the outputs it
  computed with every FC on ``torch.matmul``, bit for bit; in a whole
  ViT the tokens reach each routed FC row-major, also where the patch
  conv's output is NCHW;
* every public entry point (the pipeline's cached call, the standalone
  model, an ``aot`` artifact loaded and attached) runs the routed FCs
  with TF32 off in matmuls, whatever the flag is outside, so the kernel's
  one-product mode is never taken on the port's own paths.
The kernel itself is held to an f64 product on the card by
``tests/test_torch_fc_tc_card.py``.
"""

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
from tpu_face_torch.compiler import lowering
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet
from tpu_face_torch.models.face_detection import FaceDetectionModel
from tpu_face_torch.models.face_embeddings import FaceEmbeddings
from tpu_face_torch.ops import fc_tc, wgmma_tf32
from tpu_face_torch.pipeline import EmbedCascade

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tpu_face" / "data"
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from models import iresnet  # noqa: E402
from models import vit as gen  # noqa: E402

SEED = 2**31 + 24
GRAPHS = ("face_detection_back", "face_detection_front",
          "face_detection_short_range", "face_detection_full_range",
          "face_detection_full_range_sparse", "face_landmark",
          "iris_landmark", "demo/face_embeddings")
F32, BF16 = torch.float32, torch.bfloat16
# a ViT whose every token FC routes (widths multiples of 64), small enough
# for the CPU's entry points
ROUTED = {"depth": 1, "dim": 128, "heads": 8, "mlp": 256, "embedding": 64}


def _view(graph, consts):
    """A graph dict and its constants as ``lowering``'s functions read a
    ``Graph``."""
    return SimpleNamespace(tensors=graph["tensors"], ops=graph["ops"],
                           inputs=graph["inputs"], outputs=graph["outputs"],
                           consts={int(k[1:]): v for k, v in consts.items()})


# (weights [out, in], input shape in the graph, keep_num_dims, activation,
#  dtype) -> routed
RULE = {
    "vit_qkv": (((768, 768), [1, 144, 768], True, "NONE", F32), True),
    "vit_fc1": (((3072, 768), [1, 144, 768], True, "RELU6", F32), True),
    "vit_fc2": (((768, 3072), [1, 144, 3072], True, "NONE", F32), True),
    "relu": (((64, 32), [1, 4, 4, 32], True, "RELU", F32), True),
    "bf16": (((768, 768), [1, 144, 768], True, "NONE", BF16), False),
    "flattened": (((768, 768), [1, 144, 768], False, "NONE", F32), False),
    "row_a_sample": (((768, 768), [1, 1, 768], True, "NONE", F32), False),
    "vit_feature": (((768, 110592), [1, 110592], False, "NONE", F32),
                    False),
    "r100_fc": (((512, 25088), [1, 7, 7, 512], False, "NONE", F32), False),
    "k_48": (((64, 48), [1, 144, 48], True, "NONE", F32), False),
    "n_96": (((96, 64), [1, 144, 64], True, "NONE", F32), False),
    "tanh": (((64, 64), [1, 144, 64], True, "TANH", F32), False),
    "k_mismatch": (((64, 64), [1, 144, 128], True, "NONE", F32), False),
}


@pytest.mark.parametrize("case", RULE)
def test_routing_rule(case):
    args, routed = RULE[case]
    assert fc_tc.routes(*args) is routed


@pytest.fixture(scope="module")
def vit_published():
    """ViT-L's full graph at the published sizes, in memory."""
    w = gen.draw_weights(SEED, **gen.PUBLISHED)
    return _view(*gen.graph_from_weights(w, gen.PUBLISHED["heads"],
                                         gen.PUBLISHED["input"]))


def test_vit_routes_its_144_token_fcs(vit_published):
    g = vit_published
    fcs = [i for i, n in enumerate(g.ops) if n["op"] == "FULLY_CONNECTED"]
    routed = lowering._token_fcs(g.ops, g.consts, g.tensors, F32)
    assert len(fcs) == 146 and len(routed) == 144
    # q, k, v, proj, fc1, fc2 of each block; the two feature FCs not
    names = [g.tensors[g.ops[i]["outputs"][0]]["name"] for i in routed]
    assert names == [f"blocks.{b}.{n}" for b in range(24) for n in (
        "attn.q", "attn.k", "attn.v", "attn.proj", "mlp.fc1", "mlp.fc2")]
    assert {g.tensors[g.ops[i]["outputs"][0]]["name"]
            for i in set(fcs) - set(routed)} == {"feature.0", "feature.2"}
    assert lowering._token_fcs(g.ops, g.consts, g.tensors, BF16) == []


def _block_view():
    """ViT-L's first block at the published widths as a graph view."""
    w = gen.draw_weights(SEED, **gen._sizes(depth=1))
    return _view(*gen.block_graph(w, gen.PUBLISHED["heads"]))


def test_block_net_records_its_fcs():
    view = _block_view()
    net = TFLiteNet(view)
    assert sorted(net.tc_fcs) == [i for i, n in enumerate(view.ops)
                                  if n["op"] == "FULLY_CONNECTED"]
    assert [rec["k"] for rec in net.tc_fcs.values()] == list(range(6))
    for i, rec in net.tc_fcs.items():
        w = getattr(net, f"t{view.ops[i]['inputs'][1]}")
        for part, want in zip(("hi", "lo"), fc_tc.kernel_weights(w)):
            assert torch.equal(getattr(net, f"fc{rec['k']}_{part}"), want)
    assert TFLiteNet(view, compute_dtype=BF16).tc_fcs == {}


def test_r100_routes_no_fc():
    p = iresnet.PUBLISHED
    w = iresnet.draw_weights(SEED, p["blocks"], p["widths"], p["embedding"],
                             p["input"])
    g = _view(*iresnet.graph_from_weights(w, p["blocks"], p["widths"],
                                          p["embedding"], p["input"]))
    assert any(n["op"] == "FULLY_CONNECTED" for n in g.ops)
    assert lowering._token_fcs(g.ops, g.consts, g.tensors, F32) == []


@pytest.mark.parametrize("name", GRAPHS)
def test_bundled_nets_route_no_fc(name):
    assert TFLiteNet(Graph(DATA / f"{name}.npz")).tc_fcs == {}


def test_weight_split_inverts_to_the_weights():
    gen_ = torch.Generator().manual_seed(1)
    w = torch.randn(192, 96, generator=gen_) * torch.exp(
        4 * torch.randn(192, 96, generator=gen_))
    hi, lo = fc_tc.kernel_weights(w)
    assert hi.shape == lo.shape == (3, 192, 32)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # K step k, row n, slot s: column 32k + 8 (s % 4) + ((s // 4) ^ (n % 8))
    k, n, s = torch.meshgrid(torch.arange(3), torch.arange(192),
                             torch.arange(32), indexing="ij")
    col = 32 * k + 8 * (s % 4) + ((s // 4) ^ (n % 8))
    back = torch.zeros(192, 96, dtype=torch.float64)
    back[n, col] = hi.double() + lo.double()
    # every weight once, within 2^-22 of itself
    assert torch.equal(torch.zeros_like(back).index_put_(
        (n, col), torch.ones_like(hi, dtype=torch.float64),
        accumulate=True), torch.ones_like(back))
    assert bool(((back - w.double()).abs()
                 <= 2.0 ** -22 * w.double().abs()).all())
    assert torch.equal(hi, wgmma_tf32.split_tf32(w)[0][n, col])


@pytest.mark.parametrize("act", ["NONE", "RELU", "RELU6"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_is_linear_bias_then_activation(act, with_bias):
    gen_ = torch.Generator().manual_seed(2)
    x = 3 * torch.randn(2, 36, 64, generator=gen_)
    w = torch.randn(128, 64, generator=gen_) / 8
    bias = torch.randn(128, generator=gen_) if with_bias else None
    hi, lo = fc_tc.kernel_weights(w)
    got = fc_tc.fc_tc(x, w, hi, lo, bias, act)
    want = F.linear(x.reshape(72, 64), w)
    if bias is not None:
        want = want + bias
    want = {"NONE": want, "RELU": torch.relu(want),
            "RELU6": torch.clamp(want, 0.0, 6.0)}[act]
    assert got.shape == (2, 36, 128)
    assert torch.equal(got.reshape(72, 128), want)
    before = fc_tc.LAUNCHES
    fc_tc.fc_tc(x, w, hi, lo, bias, act)
    assert fc_tc.LAUNCHES == before


def test_operand_checks():
    x, w = torch.randn(10, 64), torch.randn(128, 64)
    hi, lo = fc_tc.kernel_weights(w)
    with pytest.raises(ValueError, match="activation"):
        fc_tc.fc_tc(x, w, hi, lo, None, "TANH")
    with pytest.raises(ValueError, match="N a multiple of 64"):
        fc_tc.fc_tc(x, w[:96], hi, lo)
    with pytest.raises(ValueError, match="N a multiple of 64"):
        fc_tc.fc_tc(x[:, :48], w[:, :48], hi, lo)
    with pytest.raises(ValueError, match="f32"):
        fc_tc.fc_tc(x.double(), w, hi, lo)
    with pytest.raises(ValueError, match="w_hi"):
        fc_tc.fc_tc(x, w, hi[:, :64], lo)
    with pytest.raises(ValueError, match="w_lo"):
        fc_tc.fc_tc(x, w, hi, lo.transpose(0, 1))
    for bad in (torch.ones(64), torch.ones(128).double(),
                torch.ones(128, 2)[:, 0], torch.ones(128, device="meta")):
        with pytest.raises(ValueError, match="bias"):
            fc_tc.fc_tc(x, w, hi, lo, bad)


def test_export_gives_the_shape():
    gen_ = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 64, generator=gen_)
    w = torch.randn(192, 64, generator=gen_)
    hi, lo = fc_tc.kernel_weights(w)

    class Fc(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name, t in (("w", w), ("hi", hi), ("lo", lo),
                            ("b", torch.randn(192, generator=gen_))):
                self.register_buffer(name, t)

        def forward(self, x):
            return fc_tc.fc_tc(x, self.w, self.hi, self.lo, self.b, "RELU6")

    fc = Fc()
    with torch.no_grad():
        prog = torch.export.export(fc, (x,))
    nodes = [n for n in prog.graph.nodes if n.op == "call_function"
             and "fc_tc" in str(n.target)]
    assert len(nodes) == 1
    assert tuple(nodes[0].meta["val"].shape) == (18, 192)
    got = prog.module()(x)
    assert got.shape == (2, 9, 192)
    assert torch.equal(got, fc(x))


def test_block_net_computes_as_with_matmul(monkeypatch):
    net = TFLiteNet(_block_view()).eval()
    assert len(net.tc_fcs) == 6
    x = torch.randn(3, 144, 768, generator=torch.Generator().manual_seed(4))
    calls = []
    real = fc_tc.fc_tc
    monkeypatch.setattr(fc_tc, "fc_tc",
                        lambda *a: calls.append(1) or real(*a))
    with torch.inference_mode():
        (routed,) = net(x)
        net.tc_fcs = {}          # every FC on torch.matmul, as before
        (before,) = net(x)
    assert len(calls) == 6
    assert torch.equal(routed, before)


def test_token_rows_reach_the_kernel_row_major(tmp_path, monkeypatch):
    # an input whose NCHW view is contiguous: the patch conv's output is
    # NCHW, and its tokens a strided view that the RESHAPE makes row-major
    d = gen.write(tmp_path, SEED, files=(gen.GRAPH_FILE,), **ROUTED)
    net = TFLiteNet(Graph(d / gen.GRAPH_FILE)).eval()
    x = torch.rand(2, 3, 112, 112, generator=torch.Generator().manual_seed(
        5)).permute(0, 2, 3, 1)
    rows = []
    real = fc_tc.fc_tc
    monkeypatch.setattr(fc_tc, "fc_tc", lambda x, *a: rows.append(
        x.is_contiguous()) or real(x, *a))
    with torch.inference_mode():
        (routed,) = net(x)
        net.tc_fcs = {}
        (before,) = net(x)
    assert rows == [True] * 6
    torch.testing.assert_close(routed, before, rtol=1e-5, atol=1e-5)


def test_abi_test_covers_the_entry_point():
    assert ("fc_tc", "fc_tc_f32") in ENTRIES


class _TF32Flags(TorchDispatchMode):
    """Records the matmul TF32 flag, which the kernel reads at its launch,
    at each call of the ``fc_tc`` operator."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.tpu_face_torch.fc_tc.default:
            self.seen.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def entry_points(tmp_path_factory):
    """{name: call} of each public entry point over a one-block ViT whose
    six token FCs route."""
    tmp = tmp_path_factory.mktemp("fc_tc_entries")
    d = gen.write(tmp, SEED, files=(gen.GRAPH_FILE,), **ROUTED)
    frames = np.random.default_rng(0).integers(0, 256, (1, 96, 128, 3),
                                               dtype=np.uint8)

    def cascade():
        return EmbedCascade(FaceDetectionModel.FULL_SPARSE,
                            embed_model_path=str(d), max_faces=2,
                            device="cpu")

    live = cascade()
    assert len(live._embed_net.tc_fcs) == 6
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
def test_entry_points_run_routed_fcs_without_tf32(entry_points, name):
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        with _TF32Flags() as flags:
            entry_points[name]()
    finally:
        matmul.allow_tf32 = saved
    assert flags.seen == [False] * 6, (name, flags.seen)
