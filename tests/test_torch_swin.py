"""The Swin Transformer face recognizer (``benchmark/models/swin.py``, the
benchmark's seeded generator) through the port on the CPU, against the
plain references ``benchmark/reference/swin.py`` and
``benchmark/reference/swin_embed_cascade.py``:

* the generator: the same seed gives the same bytes, and the program's
  graph and the reference's weights written apart are the bytes written
  together; at the published sizes (224², patch 4, 96 wide, [2, 2, 18, 2]
  blocks of [3, 6, 12, 24] heads of 32, window 7, MLP ratio 4, 512-d)
  the count by hand is 8,769,401,856 multiply-adds a face, ``vit_costs``
  counts twice that, and the net holds 78,134,410 parameters; its
  embeddings depend on the input and its windows' attention is peaked;
* ``TFLiteNet`` on a small Swin (56², [2, 2] blocks, 32 and 64 wide, 1
  and 2 heads: one shifted stage of four windows, one merge, a stage whose
  grid is the window) and on published-size blocks of stages 1 and 3
  against the reference's published equations (``torch.roll``, the
  index and the mask built there, one qkv product, q scaled);
* the graph's folded bias and mask constants against the reference's own
  relative position index and regions' mask;
* SLICE (a cyclic shift of a 4-D activation, a cut of each axis) and GELU
  (exact and ``approximate``) against plain torch, and a RESHAPE's
  leading -1 kept;
* the lowering's recognised mechanisms: 24 attention cores (11 masked),
  53 LayerNorms, 48 window spans and 137 FCs on ``fc_tc`` in the
  published graph; ViT-L's 24, 49 and no window, 144 FCs; none in R100
  or in any bundled net;
* ``EmbedCascade`` (FULL_SPARSE, K=4) on the small net against the plain
  reference on two gallery canvases, the net's spans inside its
  ``embed`` span, and at the published size every span of a traced
  capture in a slot of the stamp ring;
* the benchmark's entry refuses a lowering without SLICE or GELU at once;
* the reference's net runs with TF32 off.

The full net against the reference and the controls on the card:
``tests/test_torch_swin_card.py``.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_profiling import _Marks
from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.compiler import lowering
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet
from tpu_face_torch.models.face_detection import _DATA_DIR, FaceDetectionModel
from tpu_face_torch.pipeline import EmbedCascade
from tpu_face_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from entries import swin_embed_cascade as entry  # noqa: E402
from harness import frames, swin_costs, vit_costs  # noqa: E402
from models import iresnet  # noqa: E402
from models import swin as gen  # noqa: E402
from models import vit  # noqa: E402
from reference import swin as ref  # noqa: E402
from reference import swin_embed_cascade as ref_cascade  # noqa: E402

SEED = 2**31 + 25
SMALL = {"input": 56, "depths": (2, 2), "dim": 32, "heads": (1, 2),
         "embedding": 64}
WINDOW = gen.PUBLISHED["window"]
# f32 rounding of two orders of the same sums, as the ViT's test holds
# them (tests/test_torch_vit.py): BN1d folded against applied after, q, k
# and v as three products against one, the scale on the scores against
# on q, oneDNN's and ATen's summation orders.  2e-5 still fails a single
# flipped uint8 input level.
EMB_ATOL = 2e-5
# one block at the published widths, values O(1): 96- to 1,536-long sums
# in other orders, the softmax's exp, GELU's erf and the LayerNorm's
# rsqrt against torch's fused kernels, a few f32 ulps of the largest value
BLOCK_ATOL = 2e-5


def _crops(n, side=SMALL["input"]):
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
    return F.normalize(x, dim=-1)


def _planes(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _view(graph, consts):
    """A graph dict and its constants as ``lowering``'s functions read a
    ``Graph``."""
    return SimpleNamespace(tensors=graph["tensors"], ops=graph["ops"],
                           outputs=graph["outputs"], inputs=graph["inputs"],
                           consts={int(k[1:]): v for k, v in consts.items()})


def _save(path, graph, consts):
    gen.save_npz(path, {"__graph__": np.array(json.dumps(graph)), **consts})
    return path


@pytest.fixture(scope="module")
def published():
    """(weights, graph view) of Swin-S at the published sizes, in memory
    (312 MB of weights)."""
    w = gen.draw_weights(SEED, **gen.PUBLISHED)
    graph, consts = gen.graph_from_weights(w, gen.PUBLISHED["input"],
                                           WINDOW)
    return w, _view(graph, consts)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small net's directory (both files)."""
    return gen.write(tmp_path_factory.mktemp("swin_small"), SEED, **SMALL)


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


def _macs_by_hand():
    """Multiply-adds a face of Swin-S with the face head, by stage."""
    macs = (224 // 4) ** 2 * 96 * 3 * 4 * 4              # the patch conv
    res, c = 56, 96
    for i, depth in enumerate((2, 2, 18, 2)):
        tokens = res * res
        # q, k, v, proj (C x C), fc1 and fc2 (C x 4C) over every token;
        # q k^T and p v over each token's window of 49, all heads
        macs += depth * (tokens * 12 * c * c + 2 * tokens * 49 * c)
        if i < 3:                      # the merge: tokens / 4 x 4C x 2C
            macs += tokens // 4 * 4 * c * 2 * c
            res, c = res // 2, 2 * c
    return macs + 49 * 768 * 768 + 768 * 512        # the feature head


def test_published_size_operations_and_parameters(published):
    w, view = published
    meta = {"tensors": view.tensors, "ops": view.ops}
    assert _macs_by_hand() == 8_769_401_856
    assert abs(_macs_by_hand() / 8.77e9 - 1) < 0.01
    assert vit_costs.graph_flops(meta) == 2 * _macs_by_hand()
    assert swin_costs.graph_flops(meta) == 17_538_803_712
    shapes = gen.param_shapes(**gen.PUBLISHED)
    assert gen.parameters(shapes) == 78_134_410
    # the backbone without its ImageNet classifier, and the head
    head = sum(int(np.prod(s)) for k, s in shapes.items()
               if k.startswith("feature.") and "running" not in k)
    assert round((gen.parameters(shapes) - head) / 1e6, 1) == 48.8
    assert round(head / 1e6, 1) == 29.3
    assert {k: v.shape for k, v in w.items()} == shapes
    by_op = {}
    for node in view.ops:
        by_op[node["op"]] = by_op.get(node["op"], 0) + 1
    # a block: q, k, v, proj, fc1, fc2; the three merges' reductions, the
    # two feature FCs; a shift and its way back, two SLICEs an axis
    assert by_op["FULLY_CONNECTED"] == 24 * 6 + 3 + 2
    assert by_op["BATCH_MATMUL"] == 48 and by_op["SOFTMAX"] == 24
    assert by_op["GELU"] == 24 and by_op["CONV_2D"] == 1
    assert by_op["MEAN"] == 2 * 53 and by_op["RSQRT"] == 53
    assert by_op["SLICE"] == 11 * 2 * 2 * 2
    assert by_op["CONCATENATION"] == 11 * 2 * 2


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
        emb = _unit_norm(ref.forward(tw, _planes(_crops(3, 224)), WINDOW))
    assert torch.isfinite(emb).all()
    cos = (emb @ emb.T).abs()
    n = cos.shape[0]
    assert float((cos.sum() - cos.diagonal().sum()) / (n * n - n)) < 0.9
    # each block's heads put on average far more than a uniform softmax's
    # 1/49 of their weight on one token of the window
    assert len(peaks) == 24
    assert min(peaks) > 4.0 / 49


@pytest.mark.parametrize("fuse", [True, False])
def test_net_matches_the_reference(small, fuse):
    graph = Graph(small / gen.GRAPH_FILE)
    net = TFLiteNet(graph, fuse_epilogues=fuse).eval()
    assert not net.chains and not net.tc_convs
    w = ref.load(small / gen.WEIGHTS_FILE, "cpu")
    crops = _crops(2)
    with torch.inference_mode():
        (got,) = net(crops)
        want = ref.forward(w, _planes(crops), WINDOW)
    assert got.shape == (2, SMALL["embedding"])
    torch.testing.assert_close(_unit_norm(got), _unit_norm(want),
                               atol=EMB_ATOL, rtol=0)


@pytest.mark.parametrize("stage,block", [(0, 1), (2, 0), (2, 1)])
def test_published_block_matches_the_reference(tmp_path, published, stage,
                                               block):
    w, _ = published
    s = gen.stages(**gen.PUBLISHED)[stage]
    graph, consts = gen.block_graph(w, stage, block, gen.PUBLISHED["input"],
                                    WINDOW)
    net = TFLiteNet(Graph(_save(tmp_path / "block.npz", graph,
                                consts))).eval()
    shift = s["shift"] if block % 2 else 0
    assert len(net.attention_cores) == 1 and len(net.layer_norms) == 2
    assert len(net.masked_cores) == (1 if shift else 0)
    assert len(net.window_ops) == 2
    x = torch.randn(2, s["res"] ** 2, s["dim"],
                    generator=torch.Generator().manual_seed(5))
    tw = {k: torch.from_numpy(v) for k, v in w.items()
          if k.startswith(f"layers.{stage}.blocks.{block}.")}
    with torch.inference_mode():
        (got,) = net(x)
        want = ref.block(tw, f"layers.{stage}.blocks.{block}", x, s["res"],
                         s["heads"], s["window"], shift)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, atol=BLOCK_ATOL, rtol=0)


def _consts_named(view, suffix):
    """The graph's constants whose tensor names end in ``suffix``, by
    name."""
    return {t["name"]: view.consts[i] for i, t in enumerate(view.tensors)
            if t["name"].endswith(suffix) and i in view.consts}


def test_bias_and_mask_constants_are_the_references(published):
    w, view = published
    index = ref.relative_position_index(WINDOW)
    biases = _consts_named(view, ".attn/bias")
    assert len(biases) == 24
    for name, got in biases.items():
        p = name[:-len("/bias")]
        table = torch.from_numpy(w[f"{p}.relative_position_bias_table"])
        want = table[index.view(-1)].view(49, 49, -1).permute(2, 0, 1)
        assert np.array_equal(got, want.numpy()), name
    masks = _consts_named(view, ".attn/mask")
    assert len(masks) == 11
    for name, got in masks.items():
        i = int(name.split(".")[1])
        res = gen.stages(**gen.PUBLISHED)[i]["res"]
        want = ref.shift_mask(res, res, WINDOW, WINDOW // 2)
        assert got.shape == (1, (res // WINDOW) ** 2, 1, 49, 49)
        assert np.array_equal(got[0, :, 0], want.numpy()), name
        assert set(np.unique(got)) == {0.0, ref.MASK}


def _one_op_graph(tmp_path, op, x_shape, out_shape, consts=(), **options):
    """A graph file of the one op ``op`` on an input of ``x_shape``."""
    g = gen._Writer({})
    x = g.tensor(x_shape, "input")
    y = g.op(op, [x] + [g.const(np.array(c, np.int32), f"c{k}")
                        for k, c in enumerate(consts)], out_shape, op,
             **options)
    return Graph(_save(tmp_path / f"{op}.npz", *g.graph([x], [y])))


@pytest.mark.parametrize("shift", [-3, 3])
def test_slice_rolls_a_4d_activation_as_torch(tmp_path, shift):
    g = gen._Writer({})
    shape = [1, 14, 21, 5]
    x = g.tensor(shape, "input")
    y = g.roll(x, shape, shift, "roll")
    net = TFLiteNet(Graph(_save(tmp_path / "roll.npz", *g.graph([x], [y]))))
    a = torch.randn(3, 14, 21, 5, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        (got,) = net(a)
    assert torch.equal(got, torch.roll(a, (shift, shift), (1, 2)))


def test_slice_cuts_each_axis_as_torch(tmp_path):
    net = TFLiteNet(_one_op_graph(
        tmp_path, "SLICE", [1, 9, 8, 6], [1, 4, 8, 3],
        consts=([0, 2, 0, 1], [-1, 4, -1, 3])))
    a = torch.randn(2, 9, 8, 6, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        (got,) = net(a)
    assert torch.equal(got, a[:, 2:6, :, 1:4])



def test_slice_keeps_the_batch_under_a_size_one_entry(tmp_path):
    # a converter writes the batch-1 graph's batch entry as size 1: it is
    # the batch, as RESHAPE's leading 1, so every image is kept
    net = TFLiteNet(_one_op_graph(
        tmp_path, "SLICE", [1, 9, 8, 6], [1, 3, 8, 6],
        consts=([0, 6, 0, 0], [1, 3, 8, 6])))
    a = torch.randn(3, 9, 8, 6, generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        (got,) = net(a)
    assert got.shape == (3, 3, 8, 6)
    assert torch.equal(got, a[:, 6:9])


@pytest.mark.parametrize("begin,size", [(1, -1), (0, 2)])
def test_slice_of_the_batch_axis_raises(tmp_path, begin, size):
    net = TFLiteNet(_one_op_graph(
        tmp_path, "SLICE", [4, 9, 8, 6], [2, 9, 8, 6],
        consts=([begin, 0, 0, 0], [size, -1, -1, -1])))
    a = torch.randn(4, 9, 8, 6, generator=torch.Generator().manual_seed(8))
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                               match="batch axis"):
        net(a)

@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_torch(tmp_path, approximate):
    net = TFLiteNet(_one_op_graph(tmp_path, "GELU", [1, 7, 64], [1, 7, 64],
                                  approximate=approximate))
    a = 3 * torch.randn(4, 7, 64, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        (got,) = net(a)
    want = F.gelu(a, approximate="tanh" if approximate else "none")
    assert torch.equal(got, want)
    assert not torch.equal(got, F.gelu(a, approximate="none" if approximate
                                       else "tanh"))


def test_reshape_keeps_a_leading_minus_one(tmp_path):
    # [1, 4, 6, 8] -> [-1, 6, 8]: the 4 rows of every image of the batch
    net = TFLiteNet(_one_op_graph(tmp_path, "RESHAPE", [1, 4, 6, 8],
                                  [4, 6, 8], consts=([-1, 6, 8],)))
    a = torch.randn(3, 4, 6, 8, generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        (got,) = net(a)
    assert got.shape == (12, 6, 8)
    assert torch.equal(got, a.reshape(12, 6, 8))


def _spans(view):
    return lowering._mechanism_spans(view.ops, view.consts, view.tensors,
                                     set(view.outputs))


def _kinds(spans):
    return [sum(name == kind for name, _ in spans.values())
            for kind in (lowering.ATTENTION, lowering.LAYER_NORM,
                         lowering.WINDOW)]


def _masked(spans, masked):
    """How many of the attention cores of ``spans`` add a mask."""
    return sum(spans[a][0] == lowering.ATTENTION for a in masked)


def test_mechanisms_recognised(small, published):
    net = TFLiteNet(Graph(small / gen.GRAPH_FILE))
    assert (len(net.attention_cores), len(net.masked_cores),
            len(net.layer_norms), len(net.window_ops)) == (4, 1, 11, 8)
    assert len(net.tc_fcs) == 15
    for first, last in net.attention_cores:
        ops = [net.ops[i]["op"] for i in range(first, last + 1)]
        mask = (["RESHAPE", "ADD", "RESHAPE"]
                if (first, last) in net.masked_cores else [])
        assert ops == ["RESHAPE", "TRANSPOSE"] * 3 + [
            "BATCH_MATMUL", "MUL", "ADD"] + mask + [
            "SOFTMAX", "BATCH_MATMUL", "TRANSPOSE", "RESHAPE"]
        assert net.ops[first - 1]["op"] == net.ops[last + 1]["op"] == (
            "FULLY_CONNECTED")
    roll = ["SLICE", "SLICE", "CONCATENATION"] * 2
    shapes = set()
    for first, last in net.window_ops:
        ops = [net.ops[i]["op"] for i in range(first, last + 1)]
        shapes.add(tuple(ops))
    assert shapes == {
        ("RESHAPE", "RESHAPE", "TRANSPOSE", "RESHAPE"),
        ("RESHAPE", "TRANSPOSE", "RESHAPE", "RESHAPE"),
        tuple(["RESHAPE"] + roll + ["RESHAPE", "TRANSPOSE", "RESHAPE"]),
        tuple(["RESHAPE", "TRANSPOSE", "RESHAPE"] + roll + ["RESHAPE"])}
    spans, masked = _spans(published[1])
    assert _kinds(spans) == [24, 53, 48]
    assert _masked(spans, masked) == 11
    v = published[1]
    assert len(lowering._token_fcs(v.ops, v.consts, v.tensors,
                                   torch.float32)) == 137


def test_vit_l_counts_unchanged():
    w = vit.draw_weights(SEED, **vit.PUBLISHED)
    view = _view(*vit.graph_from_weights(w, vit.PUBLISHED["heads"],
                                         vit.PUBLISHED["input"]))
    del w
    spans, masked = _spans(view)
    assert _kinds(spans) == [24, 49, 0]
    assert _masked(spans, masked) == 0
    assert len(lowering._token_fcs(view.ops, view.consts, view.tensors,
                                   torch.float32)) == 144


def test_iresnet_holds_no_window(tmp_path):
    made = iresnet.write(tmp_path, SEED, [1, 1, 1, 1], [8, 16, 32, 64], 64,
                         112)
    net = TFLiteNet(Graph(made / iresnet.GRAPH_FILE))
    assert net.window_ops == [] and net.masked_cores == []
    assert net.attention_cores == [] and net.layer_norms == []


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        Path(_DATA_DIR).glob("*.npz")))
def test_bundled_nets_hold_no_window(name):
    net = TFLiteNet(Graph(Path(_DATA_DIR) / f"{name}.npz"))
    assert net.window_ops == [] and net.masked_cores == []
    assert not net.tc_fcs


def test_forward_drops_each_activation_after_its_last_read(small):
    net = TFLiteNet(Graph(small / gen.GRAPH_FILE))
    dropped = [t for ts in net._dead_after.values() for t in ts]
    assert len(dropped) == len(set(dropped))
    x = _crops(2)
    with torch.inference_mode():
        (freed,) = net(x)
        net._dead_after = {}
        (kept,) = net(x)
    assert torch.equal(freed, kept)


def _config():
    return {"name": "small", "detector": "FULL_SPARSE", "max_faces": 4,
            "graphs": {"detector": "face_detection_full_range_sparse.npz"},
            "widths": {"input": [SMALL["input"]] * 2, "window": WINDOW}}


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
    assert want["face_valid"].sum() >= 6
    nums = entry.compare(got, want, (1280, 720))
    assert nums["valid_flips"] == 0
    assert nums["detection_px"] <= 1e-3 and nums["score"] <= 1e-5
    assert nums["crop_px"] == 0.0
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
                          "net.layer_norm", "net.window"}
    assert names.count("net.attention") == 4
    assert names.count("net.layer_norm") == 11
    assert names.count("net.window") == 8
    embed = names.index("embed")
    assert all(s["parent"] == embed for s in spans
               if s["name"].startswith("net."))
    for f in off._fields:
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_published_spans_all_slotted(tmp_path, published):
    _, view = published
    graph = Graph(_save(tmp_path / "swin_s.npz", {
        "inputs": view.inputs, "outputs": view.outputs,
        "tensors": view.tensors, "ops": view.ops},
        {f"t{i}": v for i, v in view.consts.items()}))
    net = TFLiteNet(graph).eval()
    x = _crops(1, 224)
    dev = _Marks()
    profiling.reset()
    profiling._devices[0] = dev
    profiling.enable()
    try:
        with profiling.graph_spans(0) as table, torch.inference_mode():
            for name in ("detect", "nms", "embed_crop"):
                with profiling.stage(name):
                    pass
            with profiling.stage("embed"):
                net(x)
        unslotted = profiling.counters["spans.unslotted"]
    finally:
        profiling.enable(False)
        del profiling._devices[0]
        profiling.reset()
    assert unslotted == 0
    names = [name for name, _ in table]
    assert names.count(lowering.ATTENTION) == 24
    assert names.count(lowering.LAYER_NORM) == 53
    assert names.count(lowering.WINDOW) == 48
    # the graph's two stamps, then two a span of the table after
    # programs.copy_in and programs.graph
    assert len(dev.slots) == 2 + 2 * (len(table) - 2)
    assert max(dev.slots) < profiling.SLOTS


@pytest.mark.parametrize("op", entry.NEEDS)
def test_entry_refuses_a_lowering_without_the_op(monkeypatch, op):
    monkeypatch.setattr(lowering, "_SUPPORTED", tuple(
        o for o in lowering._SUPPORTED if o != op))
    written = []
    monkeypatch.setattr(gen, "write_config",
                        lambda *a, **k: written.append(a))
    config = json.loads((BENCH / "configs" / "swin_s_k4_f32.json")
                        .read_text())
    with pytest.raises(SystemExit, match=op):
        entry.build(config, "cpu")
    assert written == []


def test_reference_switches_tf32_off(small, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    forward = ref.forward

    def spy(w, crops, window):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return forward(w, crops, window)

    monkeypatch.setattr(ref, "forward", spy)
    w = ref.load(small / gen.WEIGHTS_FILE, "cpu")
    out = ref.embed(w, _planes(_crops(3)), WINDOW, block=2)
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(3))
