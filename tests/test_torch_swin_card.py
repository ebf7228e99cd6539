"""The Swin-S face recognizer (``benchmark/models/swin.py``) on a CUDA card
(each test skips without one; run on the card with ``python -m pytest
tests/test_torch_swin_card.py -q``).

* The full Swin-S through ``TFLiteNet`` at 128 crops of 224² a call stays
  within the configuration's ``embedding_abs`` of the plain reference run
  in blocks of 32 and of 48 crops (cuBLAS picks its kernels per shape);
  the same net with TF32 allowed does not.
* The benchmark's ``swin_s_k4_f32`` program (``EmbedCascade``,
  FULL_SPARSE, K=4, f32) on 32 gallery canvases (128 crops a call): its
  cached call equals the eager call bit for bit, makes 12 launches (the
  graph's replay and the copies), and is within every limit of its
  configuration against the plain reference; on 8 canvases both controls,
  the nets in bf16 and TF32 allowed in the f32 embedding net alone, fail
  ``embedding_abs``.
* Its stamped graph holds the stages' spans, which with the graph's self
  time sum to the graph's span, and inside ``embed`` the 24 attention
  cores', 53 LayerNorms' and 48 window spans, none unslotted; its results
  equal the untraced graph's.
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

from entries import swin_embed_cascade as entry  # noqa: E402
from harness import frames, trace  # noqa: E402
from harness.core import Cell, compare  # noqa: E402
from models import swin as gen  # noqa: E402
from reference import swin as ref  # noqa: E402

CELL = "swin_s_k4_f32.crowd720"
SEED = 2**31 + 37
STAGES = ("detect", "nms", "embed_crop", "embed")
WINDOW = gen.PUBLISHED["window"]
# the cell's one-caller call: the graph's replay and the copies in and out
LAUNCHES = 12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda", 0)
    profiling.enable(False)
    profiling.reset()


def _cell(batch=8):
    cell = Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), CELL,
                here=BENCH)
    cell.traffic.update(batch=batch, pool=1)
    return cell


def _counts(net):
    return (len(net.attention_cores), len(net.masked_cores),
            len(net.layer_norms), len(net.window_ops), len(net.tc_fcs))


def test_net_within_limit_of_the_reference_at_other_blocks(card, tmp_path):
    made = gen.write(tmp_path, SEED)
    limit = _cell().config["limits"]["embedding_abs"]
    levels = torch.randint(0, 256, (128, 224, 224, 3), device=card,
                           generator=torch.Generator(card).manual_seed(7))
    x = levels.float() / 255.0
    w = ref.load(made / gen.WEIGHTS_FILE, card)
    planes = x.permute(0, 3, 1, 2).contiguous()
    want = [ref.embed(w, planes, WINDOW, block) for block in (32, 48)]
    del w
    net = TFLiteNet(Graph(made / gen.GRAPH_FILE)).to(card).eval()
    assert _counts(net) == (24, 11, 53, 48, 137)

    def embed(run):
        with torch.inference_mode():
            return torch.nn.functional.normalize(run(x)[0], dim=-1)

    with exact_f32():
        got = embed(net)
    tf32 = embed(entry._TF32Net(net))
    for r in want:
        assert float((got - r).abs().max()) <= limit
        assert float((tf32 - r).abs().max()) > limit


def _same(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_program_cached_equals_eager_launches_and_limits(card):
    cell = _cell(batch=32)
    (batch,) = frames.make_pool(cell.traffic, BENCH / "traffic", SEED, card)
    program = entry.build(cell.config, card)
    assert _counts(program._embed_net) == (24, 11, 53, 48, 137)
    _, h, w, _ = batch.shape
    cached = [program(batch) for _ in range(3)]       # captures, replays
    with torch.inference_mode(), exact_f32():
        eager = program._forward(batch, (w, h))
    for res in cached:
        _same(res, eager)
    summary = trace.profile(lambda b: entry.call(program, b), [batch], 4)
    assert sum(summary["launches"].values()) == LAUNCHES * 4, summary[
        "launches"]
    kept = {0: [entry.call(program, batch) for _ in range(2)]}
    del program
    refs = cell.reference.run(cell.config, [batch], ROOT)
    assert sum(float(r["face_valid"].sum()) for r in refs) >= 96
    limits = cell.config["limits"]
    for name, (value, limit) in compare(cell, kept, refs).items():
        assert value <= limits[name] == limit, (name, value)


def test_controls_fail(card):
    cell = _cell()
    (batch,) = frames.make_pool(cell.traffic, BENCH / "traffic", SEED, card)
    refs = cell.reference.run(cell.config, [batch], ROOT)
    limits = cell.config["limits"]
    for dtype in ("bfloat16", entry.TF32):
        program = entry.build(dict(cell.config, compute_dtype=dtype), card)
        kept = {0: [entry.call(program, batch) for _ in range(2)]}
        reading = {n: v for n, (v, _) in compare(cell, kept, refs).items()}
        del program
        assert reading["embedding_abs"] > limits["embedding_abs"], (
            dtype, reading)


def test_stamped_graph_spans_sum_to_the_graph(card):
    cell = _cell()
    (batch,) = frames.make_pool(cell.traffic, BENCH / "traffic", SEED, card)
    program = entry.build(cell.config, card)
    off = program(batch)
    profiling.reset()
    profiling.enable()
    on = [program(batch), program(batch)]
    profiling.enable(False)
    for res in on:
        _same(res, off)
    got = profiling.collect()
    device = [s for s in got["spans"] if s["kind"] == "device"]
    assert {s["name"] for s in device} == {
        "programs.copy_in", "programs.graph", *STAGES, "net.attention",
        "net.layer_norm", "net.window"}
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
        inner = {name: [s for s in mine if s["name"] == name]
                 for name in ("net.attention", "net.layer_norm",
                              "net.window")}
        assert [len(v) for v in inner.values()] == [24, 53, 48]
        at = got["spans"].index(embed)
        for s in (span for v in inner.values() for span in v):
            assert s["parent"] == at
            assert embed["start_ns"] <= s["start_ns"] <= s["end_ns"] <= (
                embed["end_ns"])
