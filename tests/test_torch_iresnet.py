"""ArcFace's IR-ResNet (``benchmark/models/iresnet.py``, the benchmark's
seeded generator) through the port on the CPU, against the plain
references ``benchmark/reference/iresnet.py`` and
``benchmark/reference/embed_cascade.py``:

* the generator: the same seed gives the same bytes; at the published
  depth and widths (blocks [3, 13, 30, 3], widths 64-512, 512-d, 112²)
  ``graph_flops`` counts 24.18 GFLOP a face and the net holds 65 M
  parameters; its embeddings depend on the input (distinct crops are
  neither NaN nor near-identical);
* ``TFLiteNet`` on the generated graph (BN folded, PADs, the HWC
  flatten) against the reference's published equations (BN unfolded),
  fused and op by op, at blocks [1, 1, 1, 1] and widths / 8;
* one downsampling unit at the published widths (28² x 128 -> 14² x
  256): one epilogue chain ends at its ADD, and the fused net equals the
  op-by-op one and the reference;
* ``EmbedCascade`` (FULL_SPARSE, K=4) on the small net against the plain
  reference on two gallery canvases, by the benchmark's comparison;
* ``EmbedCascade``'s spans in ``utils.profiling``'s record;
* the reference's net runs with TF32 off;
* the small net (fused and op by op) and the downsampling unit at the
  published widths against the JAX package's ``build_jax_fn`` on the
  same graph file and input;
* the program's graph and the reference's weights, written apart (as
  the benchmark's set-up and its reference write them), are the bytes
  written together.

The full net against the op-by-op path and the controls on the card:
``tests/test_torch_iresnet_card.py``.
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
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet, graph_flops
from tpu_face_torch.models.face_detection import FaceDetectionModel
from tpu_face_torch.pipeline import EmbedCascade
from tpu_face_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from entries import embed_cascade as entry  # noqa: E402
from harness import frames  # noqa: E402
from models import iresnet as gen  # noqa: E402
from reference import embed_cascade as ref_cascade  # noqa: E402
from reference import iresnet as ref  # noqa: E402

SEED = 2**31 + 19
SMALL = {"blocks": [1, 1, 1, 1], "widths": [8, 16, 32, 64],
         "embedding": 64, "size": 112}
# f32 rounding of two orders of the same sums: the graph folds each BN
# into its conv's weights (one rounding of w * scale) and the reference
# applies it after the conv (two roundings); oneDNN's and ATen's
# summation orders differ.  A unit-norm embedding's component moves by a
# few 1e-7 a layer at most here; 2e-5 leaves room for the ~10 layers of
# the small net and still fails a single flipped uint8 input level.
EMB_ATOL = 2e-5
# the port's f32 against ``build_jax_fn``'s, as the demo net's test in
# test_torch_embeddings.py holds them: XLA's and oneDNN's convolutions
# sum in other orders, within 1e-4 of the largest JAX output
JAX_RTOL = 1e-4


def _crops(n, side=112):
    """``n`` crops [n, side, side, 3] in (0, 1): the benchmark's
    portraits, resized, then uniform noise."""
    from PIL import Image

    out = []
    photos = sorted((BENCH / "traffic" / "photos").glob("*.png"))
    for p in photos[:n]:
        with Image.open(p) as im:
            out.append(np.asarray(im.convert("RGB").resize((side, side)),
                                  np.float32) / 255.0)
    rng = np.random.default_rng(3)
    while len(out) < n:
        out.append(rng.random((side, side, 3), dtype=np.float32))
    return torch.from_numpy(np.stack(out))


def _torch_weights(w):
    return {k: torch.from_numpy(v) for k, v in w.items()}


def _unit_norm(x):
    return torch.nn.functional.normalize(x, dim=-1)


@pytest.fixture(scope="module")
def published():
    """(weights, graph-like view) of R100 at the published sizes, in
    memory."""
    p = gen.PUBLISHED
    w = gen.draw_weights(SEED, p["blocks"], p["widths"], p["embedding"],
                         p["input"])
    graph, consts = gen.graph_from_weights(w, p["blocks"], p["widths"],
                                           p["embedding"], p["input"])
    view = SimpleNamespace(tensors=graph["tensors"], ops=graph["ops"],
                           consts={int(k[1:]): v for k, v in consts.items()})
    return w, view


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small net's directory (both files)."""
    return gen.write(tmp_path_factory.mktemp("iresnet_small"), SEED,
                     SMALL["blocks"], SMALL["widths"], SMALL["embedding"],
                     SMALL["size"])


def test_same_seed_same_bytes(tmp_path, small):
    again = gen.write(tmp_path / "again", SEED, SMALL["blocks"],
                      SMALL["widths"], SMALL["embedding"], SMALL["size"])
    other = gen.write(tmp_path / "other", SEED + 1, SMALL["blocks"],
                      SMALL["widths"], SMALL["embedding"], SMALL["size"])
    for name in (gen.GRAPH_FILE, gen.WEIGHTS_FILE):
        assert (again / name).read_bytes() == (small / name).read_bytes()
        assert (other / name).read_bytes() != (small / name).read_bytes()


def test_published_size_operations_and_parameters(published):
    w, view = published
    # 2 x MACs of every conv and the FC: stem 21.7 M, stages 1,053 M,
    # 3,128 M, 7,058 M and 816 M, FC 12.8 M
    assert graph_flops(view) == pytest.approx(24.18e9, rel=1e-3)
    params = sum(v.size for k, v in w.items() if "running" not in k)
    assert params == pytest.approx(65e6, rel=0.02)
    by_op = {}
    for node in view.ops:
        by_op[node["op"]] = by_op.get(node["op"], 0) + 1
    # 49 units: two 3x3 convs each, four 1x1 shortcuts, the stem; a PAD
    # before each stage's stride-2 conv
    assert by_op["CONV_2D"] == 1 + 2 * 49 + 4 and by_op["PAD"] == 4
    assert by_op["PRELU"] == 50 and by_op["FULLY_CONNECTED"] == 1


def test_published_size_embeddings_depend_on_the_input(published):
    w, _ = published
    crops = _crops(4).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        emb = _unit_norm(ref.forward(_torch_weights(w), crops))
    assert torch.isfinite(emb).all()
    cos = (emb @ emb.T).abs()
    n = cos.shape[0]
    assert float((cos.sum() - cos.diagonal().sum()) / (n * n - n)) < 0.9


@pytest.mark.parametrize("fuse", [True, False])
def test_net_matches_the_reference(small, fuse):
    graph = Graph(small / gen.GRAPH_FILE)
    net = TFLiteNet(graph, fuse_epilogues=fuse).eval()
    # four units: conv1 + PReLU each and the stem; the ADD of each unit,
    # on its shortcut's chain (every unit downsamples here)
    assert len(net.chains) == (9 if fuse else 0)
    w = ref.load(small / gen.WEIGHTS_FILE, "cpu")
    crops = _crops(2)
    with torch.inference_mode():
        (got,) = net(crops)
        want = ref.forward(w, crops.permute(0, 3, 1, 2).contiguous())
    assert got.shape == (2, SMALL["embedding"])
    torch.testing.assert_close(_unit_norm(got), _unit_norm(want),
                               atol=EMB_ATOL, rtol=0)


def _against_jax(path, x, fuse=True):
    """(port's output, JAX's) of the graph file ``path`` on ``x``."""
    want = np.asarray(jax.jit(build_jax_fn(JaxGraph(path)))(x)[0])
    net = TFLiteNet(Graph(path), fuse_epilogues=fuse).eval()
    with torch.inference_mode():
        (got,) = net(torch.from_numpy(x))
    return got.numpy(), want


@pytest.mark.parametrize("fuse", [True, False])
def test_net_matches_build_jax_fn(small, fuse):
    x = _crops(2).numpy()
    got, want = _against_jax(small / gen.GRAPH_FILE, x, fuse)
    assert got.shape == want.shape == (2, SMALL["embedding"])
    err = float(np.abs(got - want).max())
    assert err <= JAX_RTOL * float(np.abs(want).max()), err


def _published_unit(tmp_path):
    """(weights, graph file) of the downsampling unit ``layer3.0`` at the
    published widths: 28² x 128 -> 14² x 256."""
    w = gen.draw_weights(SEED, [1, 1, 1, 1], gen.PUBLISHED["widths"], 512,
                         112)
    graph, consts = gen.unit_graph(w, "layer3.0", 28, 2)
    gen.save_npz(tmp_path / "unit.npz",
                 {"__graph__": np.array(json.dumps(graph)), **consts})
    return w, tmp_path / "unit.npz"


def test_downsampling_unit_matches_build_jax_fn(tmp_path):
    _, path = _published_unit(tmp_path)
    x = np.random.default_rng(5).standard_normal(
        (2, 28, 28, 128)).astype(np.float32)
    got, want = _against_jax(path, x)
    assert got.shape == want.shape == (2, 14, 14, 256)
    err = float(np.abs(got - want).max())
    assert err <= JAX_RTOL * float(np.abs(want).max()), err


def test_files_written_apart_equal_written_together(tmp_path, small):
    sizes = (SMALL["blocks"], SMALL["widths"], SMALL["embedding"],
             SMALL["size"])
    for name in (gen.GRAPH_FILE, gen.WEIGHTS_FILE):
        apart = gen.write(tmp_path / name, SEED, *sizes, files=(name,))
        assert [p.name for p in apart.iterdir()] == [name]
        assert (apart / name).read_bytes() == (small / name).read_bytes()


def test_downsampling_unit_at_published_widths(tmp_path):
    w, path = _published_unit(tmp_path)
    g = Graph(path)
    fused = TFLiteNet(g).eval()
    plain = TFLiteNet(g, fuse_epilogues=False).eval()
    convs = [n for n in g.ops if n["op"] == "CONV_2D"]
    add = g.ops[-1]
    assert add["op"] == "ADD" and len(convs) == 3
    # the ADD of conv2 and the 1x1 shortcut ends one chain: the
    # shortcut's, the later of the two; conv2 keeps its bias
    ends = [c for c in fused.chains if add in c["ops"]]
    assert len(ends) == 1 and ends[0]["conv"] is convs[2]
    assert [c["conv"] for c in fused.chains] == [convs[0], convs[2]]
    x = torch.randn(2, 28, 28, 128, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        (got,) = fused(x)
        (op_by_op,) = plain(x)
        want = ref._unit(_torch_weights(w), "layer3.0",
                         x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert got.shape == (2, 14, 14, 256)
    # the bias added after oneDNN's convolution, not inside it: one f32
    # rounding of values of O(1)
    torch.testing.assert_close(got, op_by_op, atol=2e-6, rtol=1e-6)
    # BN folded into the weights against BN after the conv (see EMB_ATOL),
    # over two convolutions of 1,152 and 2,304 products a pixel
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def _config():
    return {"name": "small", "detector": "FULL_SPARSE", "max_faces": 4,
            "graphs": {"detector": "face_detection_full_range_sparse.npz"},
            "widths": {"input": [112, 112]}}


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
        {f: getattr(program(canvases), f).numpy() for f in entry.FIELDS}, 4)
    cascade = ref_cascade.EmbedCascade(_config(), ROOT, "cpu",
                                       small / gen.WEIGHTS_FILE)
    with torch.inference_mode():
        want = {f: v.numpy() for f, v in cascade(canvases).items()}
    assert want["face_valid"].sum() == 8          # four faces a canvas
    nums = entry.compare(got, want, (1280, 720))
    assert nums["valid_flips"] == 0
    # the detector's path is the same f32 arithmetic on both sides
    assert nums["detection_px"] <= 1e-3 and nums["score"] <= 1e-5
    assert nums["crop_px"] == 0.0
    # the same crops on both sides; the nets as in EMB_ATOL
    assert nums["embedding_abs"] <= EMB_ATOL


def test_embed_cascade_spans_and_crop_counter(small, canvases):
    program = EmbedCascade(FaceDetectionModel.FULL_SPARSE,
                           embed_model_path=str(small), max_faces=4,
                           device="cpu")
    profiling.reset()
    profiling.enable()
    try:
        program(canvases)
    finally:
        profiling.enable(False)
    got = profiling.collect()
    names = {s["name"] for s in got["spans"]}
    assert names == {"embed_cascade.call", "detect", "nms", "embed_crop",
                     "embed"}


def test_reference_switches_tf32_off(small, monkeypatch):
    # the plain reference runs its net with TF32 off whatever the
    # caller's settings, and gives them back
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    forward = ref.forward

    def spy(w, crops):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return forward(w, crops)

    monkeypatch.setattr(ref, "forward", spy)
    w = ref.load(small / gen.WEIGHTS_FILE, "cpu")
    out = ref.embed(w, _crops(3).permute(0, 3, 1, 2).contiguous(), block=2)
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(3))
