"""insightface's ViT-L (``benchmark/models/vit.py``) on a CUDA card (each
test skips without one; run on the card with ``python -m pytest
tests/test_torch_vit_card.py -q``).

* The full ViT-L through ``TFLiteNet`` at 128 crops a call stays within
  the configuration's ``embedding_abs`` of the plain reference run in
  blocks of 32 and of 48 crops (cuBLAS picks its kernels per shape); the
  same net with TF32 allowed does not.
* The benchmark's ``arcface_vitl_k4_f32`` program (``EmbedCascade``,
  FULL_SPARSE, K=4, f32) on gallery canvases is within every limit of
  its configuration against the plain reference, and both controls, the
  nets in bf16 and TF32 allowed in the f32 embedding net alone, fail
  ``embedding_abs``.
* Its stamped graph holds the stages' spans, which with the graph's self
  time sum to the graph's span, and inside ``embed`` the 24 attention
  cores' and 49 LayerNorms' spans, none unslotted; its results equal
  the untraced graph's.  R100's stamped graph holds the stages' spans
  alone.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch import exact_f32
from tpu_face_torch.compiler.lowering import Graph, TFLiteNet
from tpu_face_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from entries import embed_cascade as r100_entry  # noqa: E402
from entries import vit_embed_cascade as entry  # noqa: E402
from harness import frames  # noqa: E402
from harness.core import Cell, compare  # noqa: E402
from models import vit as gen  # noqa: E402
from reference import vit as ref  # noqa: E402

CELL = "arcface_vitl_k4_f32.crowd720"
R100_CELL = "arcface_r100_k4_f32.crowd720"
SEED = 2**31 + 31
STAGES = ("detect", "nms", "embed_crop", "embed")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda", 0)
    profiling.enable(False)
    profiling.reset()


def _cell(name=CELL, batch=8):
    cell = Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name,
                here=BENCH)
    cell.traffic.update(batch=batch, pool=1)
    return cell


def test_net_within_limit_of_the_reference_at_other_blocks(card, tmp_path):
    made = gen.write(tmp_path, SEED)
    limit = _cell().config["limits"]["embedding_abs"]
    levels = torch.randint(0, 256, (128, 112, 112, 3), device=card,
                           generator=torch.Generator(card).manual_seed(7))
    x = levels.float() / 255.0
    w = ref.load(made / gen.WEIGHTS_FILE, card)
    planes = x.permute(0, 3, 1, 2).contiguous()
    want = [ref.embed(w, planes, gen.PUBLISHED["heads"], block)
            for block in (32, 48)]
    del w
    net = TFLiteNet(Graph(made / gen.GRAPH_FILE)).to(card).eval()
    assert len(net.attention_cores) == 24 and len(net.layer_norms) == 49

    def embed(run):
        with torch.inference_mode():
            return torch.nn.functional.normalize(run(x)[0], dim=-1)

    with exact_f32():
        got = embed(net)
    tf32 = embed(entry._TF32Net(net))
    for r in want:
        assert float((got - r).abs().max()) <= limit
        assert float((tf32 - r).abs().max()) > limit


def test_program_within_limits_and_controls_fail(card):
    cell = _cell()
    (batch,) = frames.make_pool(cell.traffic, BENCH / "traffic", SEED, card)
    refs = cell.reference.run(cell.config, [batch], ROOT)
    limits = cell.config["limits"]
    readings = {}
    for dtype in ("float32", "bfloat16", entry.TF32):
        program = entry.build(dict(cell.config, compute_dtype=dtype), card)
        kept = {0: [entry.call(program, batch) for _ in range(2)]}
        readings[dtype] = {n: v for n, (v, _) in
                           compare(cell, kept, refs).items()}
        del program
    assert sum(float(r["face_valid"].sum()) for r in refs) >= 24
    for name, value in readings["float32"].items():
        assert value <= limits[name], (name, value)
    for dtype in ("bfloat16", entry.TF32):
        assert readings[dtype]["embedding_abs"] > limits["embedding_abs"], (
            dtype, readings[dtype])


def _same(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _stamped(cell, card, build):
    """(the device spans of two stamped calls of the cell's program, the
    collection) after an untraced call, each result equal to it."""
    (batch,) = frames.make_pool(cell.traffic, BENCH / "traffic", SEED, card)
    program = build(cell.config, card)
    off = program(batch)
    profiling.reset()
    profiling.enable()
    on = [program(batch), program(batch)]
    profiling.enable(False)
    for res in on:
        _same(res, off)
    got = profiling.collect()
    return [s for s in got["spans"] if s["kind"] == "device"], got


def test_stamped_graph_spans_sum_to_the_graph(card):
    device, got = _stamped(_cell(), card, entry.build)
    assert {s["name"] for s in device} == {
        "programs.copy_in", "programs.graph", *STAGES, "net.attention",
        "net.layer_norm"}
    assert got["lost_calls"] == 0
    assert got["counters"].get("spans.unslotted", 0) == 0
    graphs = [s for s in device if s["name"] == "programs.graph"]
    assert len(graphs) == 2
    for g in graphs:
        mine = [s for s in device if s["call"] == g["call"]]
        stages = [s for s in mine if s["name"] in STAGES]
        assert len(stages) == 4
        parts = sum(s["end_ns"] - s["start_ns"] for s in stages)
        total = g["end_ns"] - g["start_ns"]
        assert parts + g["self_ns"] == pytest.approx(total, rel=1e-3)
        (embed,) = [s for s in stages if s["name"] == "embed"]
        assert embed["end_ns"] - embed["start_ns"] > 0.5 * total
        inner = {name: [s for s in mine if s["name"] == name]
                 for name in ("net.attention", "net.layer_norm")}
        assert len(inner["net.attention"]) == 24
        assert len(inner["net.layer_norm"]) == 49
        at = got["spans"].index(embed)
        for s in inner["net.attention"] + inner["net.layer_norm"]:
            assert s["parent"] == at
            assert embed["start_ns"] <= s["start_ns"] <= s["end_ns"] <= (
                embed["end_ns"])


def test_r100_stamped_graph_holds_the_stages_alone(card):
    device, got = _stamped(_cell(R100_CELL), card, r100_entry.build)
    assert {s["name"] for s in device} == {
        "programs.copy_in", "programs.graph", *STAGES}
    assert got["counters"].get("spans.unslotted", 0) == 0
