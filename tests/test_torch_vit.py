"""insightface's face-recognition ViT (``benchmark/models/vit.py``, the
benchmark's seeded generator) through the port on the CPU, against the
plain references ``benchmark/reference/vit.py`` and
``benchmark/reference/vit_embed_cascade.py``:

* the generator: the same seed gives the same bytes, and the program's
  graph and the reference's weights written apart are the bytes written
  together; at the published sizes (112², patch 9, 144 tokens, 768 wide,
  24 blocks of 8 heads of 96, MLP 3,072, 512-d) ``vit_costs`` counts
  50,675,589,120 operations a face and the net holds 255,683,584
  parameters; its embeddings depend on the input and its attention is
  peaked, not near-uniform;
* ``TFLiteNet`` on a small ViT (2 blocks, 96 wide, 8 heads, 144 tokens
  kept) and on one block at the published widths against the
  reference's published equations (BN1d unfolded, one qkv product split
  into heads), and against the JAX package's ``build_jax_fn`` on the same
  graph file;
* the lowering's recognised mechanisms: 2 attention cores and 5
  LayerNorms in the small net, 24 and 49 in the published graph, each one
  unbroken range of ops; none in R100 or in any bundled net; ops that
  interleave are no range;
* ``forward`` drops each activation once no later op reads it (where a
  residual run, a chain or an absorbed affine reads it), and computes the
  same as when it keeps them all;
* ``EmbedCascade`` (FULL_SPARSE, K=4) on the small net against the plain
  reference on two gallery canvases, by the benchmark's comparison, and
  the net's spans inside its ``embed`` span;
* the reference's net runs with TF32 off.

The full net against the reference and the controls on the card:
``tests/test_torch_vit_card.py``.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import build_jax_fn
from tpu_face_torch.compiler import lowering
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet
from tpu_face_torch.models.face_detection import _DATA_DIR, FaceDetectionModel
from tpu_face_torch.pipeline import EmbedCascade
from tpu_face_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from entries import vit_embed_cascade as entry  # noqa: E402
from harness import frames, vit_costs  # noqa: E402
from models import iresnet  # noqa: E402
from models import vit as gen  # noqa: E402
from reference import vit as ref  # noqa: E402
from reference import vit_embed_cascade as ref_cascade  # noqa: E402

SEED = 2**31 + 23
SMALL = {"depth": 2, "dim": 96, "heads": 8, "mlp": 384, "embedding": 64}
# f32 rounding of two orders of the same sums: the graph folds each BN1d
# into its Linear (one rounding of w * scale) and the reference applies it
# after (two roundings); the graph's q, k and v are three products where
# the reference has one, and oneDNN's and ATen's summation orders differ.
# The small net's unit-norm embeddings lie within 4e-7 of each other;
# 2e-5 leaves room and still fails a single flipped uint8 input level.
EMB_ATOL = 2e-5
# the port's f32 against ``build_jax_fn``'s, as the demo net's test in
# test_torch_embeddings.py holds them: XLA's and oneDNN's products sum in
# other orders, within 1e-4 of the largest JAX output
JAX_RTOL = 1e-4
# one block at the published widths, values O(1): the two sides' 768- and
# 3,072-long sums in other orders, the softmax's exp and the LayerNorm's
# rsqrt against torch's fused kernels, a few f32 ulps of the largest value
BLOCK_ATOL = 2e-5


def _crops(n, side=112):
    """``n`` crops [n, side, side, 3] in (0, 1): the benchmark's
    portraits, resized, then uniform noise."""
    from PIL import Image

    out = []
    photos = sorted((BENCH / "traffic" / "photos").glob("*.png"))
    for p in photos[4:4 + n]:
        with Image.open(p) as im:
            out.append(np.asarray(im.convert("RGB").resize((side, side)),
                                  np.float32) / 255.0)
    rng = np.random.default_rng(3)
    while len(out) < n:
        out.append(rng.random((side, side, 3), dtype=np.float32))
    return torch.from_numpy(np.stack(out))


def _unit_norm(x):
    return torch.nn.functional.normalize(x, dim=-1)


def _planes(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _view(graph, consts):
    """A graph dict and its constants as ``lowering``'s functions read a
    ``Graph``."""
    return SimpleNamespace(tensors=graph["tensors"], ops=graph["ops"],
                           outputs=graph["outputs"],
                           consts={int(k[1:]): v for k, v in consts.items()})


@pytest.fixture(scope="module")
def published():
    """(weights, graph view) of ViT-L at the published sizes, in memory
    (drawn in float32: 1.02 GB)."""
    w = gen.draw_weights(SEED, **gen.PUBLISHED)
    graph, consts = gen.graph_from_weights(w, gen.PUBLISHED["heads"],
                                           gen.PUBLISHED["input"])
    return w, _view(graph, consts)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small net's directory (both files)."""
    return gen.write(tmp_path_factory.mktemp("vit_small"), SEED, **SMALL)


def test_same_seed_same_bytes(tmp_path, small):
    again = gen.write(tmp_path / "again", SEED, **SMALL)
    other = gen.write(tmp_path / "other", SEED + 1, **SMALL)
    for name in (gen.GRAPH_FILE, gen.WEIGHTS_FILE):
        assert (again / name).read_bytes() == (small / name).read_bytes()
        assert (other / name).read_bytes() != (small / name).read_bytes()


def test_files_written_apart_equal_written_together(tmp_path, small):
    for name in (gen.GRAPH_FILE, gen.WEIGHTS_FILE):
        apart = gen.write(tmp_path / name, SEED, files=(name,), **SMALL)
        assert [p.name for p in apart.iterdir()] == [name]
        assert (apart / name).read_bytes() == (small / name).read_bytes()


def test_published_size_operations_and_parameters(published):
    w, view = published
    meta = {"tensors": view.tensors, "ops": view.ops}
    # 2 x MACs: the patch conv 26,873,856; a block's FCs 1,019,215,872 and
    # attention products 31,850,496; feature 85,327,872
    assert vit_costs.graph_flops(meta) == 50_675_589_120
    assert round(vit_costs.graph_flops(meta) / 1e9, 2) == 50.68
    shapes = gen.param_shapes(**gen.PUBLISHED)
    assert gen.parameters(shapes) == 255_683_584
    assert {k: v.shape for k, v in w.items()} == shapes
    by_op = {}
    for node in view.ops:
        by_op[node["op"]] = by_op.get(node["op"], 0) + 1
    # a block: q, k, v, proj, fc1, fc2; 2 BATCH_MATMUL; 2 LayerNorms of
    # 2 MEANs each; the final LayerNorm; the two feature FCs
    assert by_op["FULLY_CONNECTED"] == 24 * 6 + 2
    assert by_op["BATCH_MATMUL"] == 48 and by_op["SOFTMAX"] == 24
    assert by_op["MEAN"] == 2 * 49 and by_op["RSQRT"] == 49
    assert by_op["CONV_2D"] == 1


def test_published_size_embeddings_depend_on_the_input_and_attention_peaks(
        published, monkeypatch):
    w, _ = published
    peaks = []
    softmax = torch.Tensor.softmax

    def spy(self, dim):
        out = softmax(self, dim=dim)
        peaks.append(float(out.amax(-1).mean()))
        return out

    monkeypatch.setattr(torch.Tensor, "softmax", spy)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    with torch.inference_mode():
        emb = _unit_norm(ref.forward(tw, _planes(_crops(4)),
                                     gen.PUBLISHED["heads"]))
    assert torch.isfinite(emb).all()
    cos = (emb @ emb.T).abs()
    n = cos.shape[0]
    assert float((cos.sum() - cos.diagonal().sum()) / (n * n - n)) < 0.9
    # each block's heads put on average 0.09-0.15 of their weight on one
    # token, a uniform softmax over 144 tokens 0.0069
    assert len(peaks) == 24
    assert min(peaks) > 8.0 / 144


@pytest.mark.parametrize("fuse", [True, False])
def test_net_matches_the_reference(small, fuse):
    graph = Graph(small / gen.GRAPH_FILE)
    net = TFLiteNet(graph, fuse_epilogues=fuse).eval()
    # the patch conv is followed by a RESHAPE: no chain, no routed conv
    assert not net.chains and not net.tc_convs
    w = ref.load(small / gen.WEIGHTS_FILE, "cpu")
    crops = _crops(2)
    with torch.inference_mode():
        (got,) = net(crops)
        want = ref.forward(w, _planes(crops), SMALL["heads"])
    assert got.shape == (2, SMALL["embedding"])
    torch.testing.assert_close(_unit_norm(got), _unit_norm(want),
                               atol=EMB_ATOL, rtol=0)


def _published_block(tmp_path):
    """(weights, graph file) of one block at the published widths: 144
    tokens of 768, 8 heads of 96, MLP 3,072."""
    sizes = dict(gen.PUBLISHED, depth=1)
    w = gen.draw_weights(SEED, **sizes)
    graph, consts = gen.block_graph(w, sizes["heads"])
    gen.save_npz(tmp_path / "block.npz",
                 {"__graph__": np.array(json.dumps(graph)), **consts})
    return w, tmp_path / "block.npz"


def test_published_block_matches_the_reference(tmp_path):
    w, path = _published_block(tmp_path)
    net = TFLiteNet(Graph(path)).eval()
    assert len(net.attention_cores) == 1 and len(net.layer_norms) == 2
    x = torch.randn(2, 144, 768, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        (got,) = net(x)
        want = ref.block({k: torch.from_numpy(v) for k, v in w.items()},
                         "blocks.0", x, gen.PUBLISHED["heads"])
    assert got.shape == (2, 144, 768)
    torch.testing.assert_close(got, want, atol=BLOCK_ATOL, rtol=0)


def _against_jax(path, x):
    """(port's output, JAX's) of the graph file ``path`` on ``x``."""
    want = np.asarray(jax.jit(build_jax_fn(JaxGraph(path)))(x)[0])
    net = TFLiteNet(Graph(path)).eval()
    with torch.inference_mode():
        (got,) = net(torch.from_numpy(x))
    return got.numpy(), want


def test_net_matches_build_jax_fn(small):
    got, want = _against_jax(small / gen.GRAPH_FILE, _crops(2).numpy())
    assert got.shape == want.shape == (2, SMALL["embedding"])
    err = float(np.abs(got - want).max())
    assert err <= JAX_RTOL * float(np.abs(want).max()), err


def test_published_block_matches_build_jax_fn(tmp_path):
    _, path = _published_block(tmp_path)
    x = np.random.default_rng(5).standard_normal(
        (2, 144, 768)).astype(np.float32)
    got, want = _against_jax(path, x)
    assert got.shape == want.shape == (2, 144, 768)
    err = float(np.abs(got - want).max())
    assert err <= JAX_RTOL * float(np.abs(want).max()), err


def _spans(view):
    return lowering._mechanism_spans(view.ops, view.consts, view.tensors,
                                     set(view.outputs))


def _kinds(spans):
    return [sum(name == kind for name, _ in spans.values())
            for kind in (lowering.ATTENTION, lowering.LAYER_NORM)]


def test_mechanisms_recognised(small, published):
    net = TFLiteNet(Graph(small / gen.GRAPH_FILE))
    assert len(net.attention_cores) == 2 and len(net.layer_norms) == 5
    for first, last in net.attention_cores:
        # the head splits of q, k and v, the core, the head merge; the
        # projections outside
        assert [net.ops[i]["op"] for i in range(first, last + 1)] == [
            "RESHAPE", "TRANSPOSE"] * 3 + [
            "BATCH_MATMUL", "MUL", "SOFTMAX", "BATCH_MATMUL", "TRANSPOSE",
            "RESHAPE"]
        assert net.ops[first - 1]["op"] == net.ops[last + 1]["op"] == (
            "FULLY_CONNECTED")
    for first, last in net.layer_norms:
        assert [net.ops[i]["op"] for i in range(first, last + 1)] == [
            "MEAN", "SUB", "MUL", "MEAN", "ADD", "RSQRT", "MUL", "MUL",
            "ADD"]
    assert _kinds(_spans(published[1])[0]) == [24, 49]


def test_interleaved_ops_are_no_mechanism(small):
    graph = Graph(small / gen.GRAPH_FILE)
    first, last = TFLiteNet(graph).layer_norms[0]
    ops = list(graph.ops)
    # the op after the first LayerNorm moved in before its last op (only
    # the recognition reads this order): the LayerNorm's ops are no longer
    # one unbroken range
    ops.insert(last, ops.pop(last + 1))
    view = SimpleNamespace(ops=ops, consts=graph.consts,
                           tensors=graph.tensors, outputs=graph.outputs)
    assert _kinds(_spans(view)[0]) == [2, 4]


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        Path(_DATA_DIR).glob("*.npz")))
def test_bundled_nets_hold_no_mechanism(name):
    net = TFLiteNet(Graph(Path(_DATA_DIR) / f"{name}.npz"))
    assert net.attention_cores == [] and net.layer_norms == []
    assert net._spans == {}


def test_iresnet_holds_no_mechanism(tmp_path):
    made = iresnet.write(tmp_path, SEED, [1, 1, 1, 1], [8, 16, 32, 64], 64,
                         112)
    net = TFLiteNet(Graph(made / iresnet.GRAPH_FILE))
    assert net.attention_cores == [] and net.layer_norms == []


def _freeing_net(name, small, tmp_path):
    """(net, input) of the small ViT, the BACK detector (residual runs), or
    an IR-ResNet unit at the published widths (epilogue chains, routed
    convs, an absorbed affine)."""
    rng = torch.Generator().manual_seed(9)
    if name == "vit":
        return TFLiteNet(Graph(small / gen.GRAPH_FILE)), _crops(2)
    if name == "back":
        return (TFLiteNet(Graph(Path(_DATA_DIR) / "face_detection_back.npz")),
                torch.rand(2, 256, 256, 3, generator=rng))
    unit = iresnet.draw_weights(SEED, [1, 1, 1, 1], [64, 128, 256, 512],
                                512, 112)
    graph, consts = iresnet.unit_graph(unit, "layer3.0", 14, 2)
    gen.save_npz(tmp_path / "unit.npz",
                 {"__graph__": np.array(json.dumps(graph)), **consts})
    return (TFLiteNet(Graph(tmp_path / "unit.npz")),
            torch.randn(2, 14, 14, 128, generator=rng))


@pytest.mark.parametrize("name", ["vit", "back", "unit"])
def test_forward_drops_each_activation_after_its_last_read(small, tmp_path,
                                                           name):
    net, x = _freeing_net(name, small, tmp_path)
    assert name != "back" or net.runs
    assert name != "unit" or (net.chains and any(
        rec["affine"] for rec in net.tc_convs.values()))
    at = net._executed_at({id(n): i for i, n in enumerate(net.ops)})
    dropped = [t for ts in net._dead_after.values() for t in ts]
    assert len(dropped) == len(set(dropped))
    assert not set(dropped) & set(net.outputs)
    where = {t: j for j, ts in net._dead_after.items() for t in ts}
    for i, node in enumerate(net.ops):
        for t in node["inputs"]:
            if t not in net.outputs:
                assert where[t] >= max(i, at.get(i, i))
    with torch.inference_mode():
        freed = net(x)
        net._dead_after = {}
        kept = net(x)
    for a, b in zip(freed, kept):
        assert torch.equal(a, b)


def _config():
    return {"name": "small", "detector": "FULL_SPARSE", "max_faces": 4,
            "graphs": {"detector": "face_detection_full_range_sparse.npz"},
            "widths": {"input": [112, 112], "heads": SMALL["heads"]}}


@pytest.fixture(scope="module")
def canvases():
    traffic = json.loads((BENCH / "traffic" / "crowd720.json").read_text())
    traffic.update(batch=2, pool=1)
    (batch,) = frames.make_pool(traffic, BENCH / "traffic", SEED, "cpu")
    return batch


def test_embed_cascade_matches_the_reference(small, canvases):
    # the card's crop path ("auto" there): the separable hat matmuls
    program = EmbedCascade(FaceDetectionModel.FULL_SPARSE,
                           embed_model_path=str(small), max_faces=4,
                           warp_method="pallas", device="cpu")
    got = entry.with_face_axis(
        {f: getattr(program(canvases), f).numpy()
         for f in ref_cascade.FIELDS}, 4)
    cascade = ref_cascade.EmbedCascade(_config(), ROOT, "cpu",
                                       small / gen.WEIGHTS_FILE)
    with torch.inference_mode():
        want = {f: v.numpy() for f, v in cascade(canvases).items()}
    # four faces a canvas, most of them found (the detector's misses are
    # the program's too: ``valid_flips``)
    assert want["face_valid"].sum() >= 6
    nums = entry.compare(got, want, (1280, 720))
    assert nums["valid_flips"] == 0
    # the detector's path is the same f32 arithmetic on both sides
    assert nums["detection_px"] <= 1e-3 and nums["score"] <= 1e-5
    assert nums["crop_px"] == 0.0
    # the same crops on both sides; the nets as in EMB_ATOL
    assert nums["embedding_abs"] <= EMB_ATOL


def test_embed_cascade_spans_hold_the_mechanisms(small, canvases):
    program = EmbedCascade(FaceDetectionModel.FULL_SPARSE,
                           embed_model_path=str(small), max_faces=4,
                           device="cpu")
    off = program(canvases)
    profiling.reset()
    profiling.enable()
    try:
        on = program(canvases)
    finally:
        profiling.enable(False)
    got = profiling.collect()
    spans = got["spans"]
    names = [s["name"] for s in spans]
    assert set(names) == {"embed_cascade.call", "detect", "nms",
                          "embed_crop", "embed", "net.attention",
                          "net.layer_norm"}
    assert names.count("net.attention") == 2
    assert names.count("net.layer_norm") == 5
    embed = names.index("embed")
    assert all(s["parent"] == embed for s in spans
               if s["name"].startswith("net."))
    # tracing changes nothing the net computes
    for f in off._fields:
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_reference_switches_tf32_off(small, monkeypatch):
    # the plain reference runs its net with TF32 off whatever the
    # caller's settings, and gives them back
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    forward = ref.forward

    def spy(w, crops, heads):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return forward(w, crops, heads)

    monkeypatch.setattr(ref, "forward", spy)
    w = ref.load(small / gen.WEIGHTS_FILE, "cpu")
    out = ref.embed(w, _planes(_crops(3)), SMALL["heads"], block=2)
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(3))
