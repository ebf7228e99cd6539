"""tpu_face_torch.utils.profiling: stage spans, on the CPU.

* ``stage(name)`` is a no-op until enabled (``enable()`` or
  ``TPU_FACE_PROFILE``), then a ``record_function`` event
  ``tpu_face/<name>`` and a host span kept in memory (name, start <= end
  on ``perf_counter_ns``, parent, call id), which ``collect()`` returns
  and clears, with the counters and each span's self time.
* ``EmbedCascade.infer_batch`` and ``FaceCascade.infer_batch`` label the
  call, its ``__call__`` and their stages (the JAX package's
  ``named_scope`` names) while tracing is on, and nothing while it is
  off; the results do not change.
* The stamp ring's decoding and the clock pairing's mapping, on
  synthetic arrays; ``stage`` under ``torch.export`` leaves nothing in
  the exported graph.
* The ring's shape is ``csrc/stage_stamp.cu``'s; a capture's recorder
  slots every span up to the ring's width (a ViT-L call's 79, far past
  the 31 of a 64-slot ring) and counts the ones past it unslotted, and
  the ring decodes every slotted span.
"""

import importlib
import re
import time
from pathlib import Path

import numpy as np

import pytest
import torch

from test_rotation_e2e import ROT
from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.pipeline import EmbedCascade, FaceCascade
from tpu_face_torch.utils import profiling
from tpu_face_torch.utils.image_io import load_image


@pytest.fixture
def profiling_on():
    profiling.enable()
    yield
    profiling.enable(False)


def _labels(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events() if e.name.startswith("tpu_face/")}


def _work():
    with profiling.stage("unit"):
        torch.ones(8).add_(1)


def test_stage_is_a_no_op_until_enabled():
    assert not profiling.enabled()
    assert _labels(_work) == set()


def test_stage_records_when_enabled(profiling_on):
    assert profiling.enabled()
    assert _labels(_work) == {"tpu_face/unit"}


def test_switch_reads_the_environment(monkeypatch):
    try:
        monkeypatch.setenv("TPU_FACE_PROFILE", "1")
        assert importlib.reload(profiling).enabled()
        monkeypatch.setenv("TPU_FACE_PROFILE", "0")
        assert not importlib.reload(profiling).enabled()
    finally:
        monkeypatch.delenv("TPU_FACE_PROFILE")
        importlib.reload(profiling)


@pytest.fixture(scope="module")
def frame():
    return load_image(ROT / "man_rotp15.png")[None]


def test_cascades_label_their_stages(frame, profiling_on):
    embed = EmbedCascade(embed_model_path=str(_DATA_DIR / "demo"),
                         device="cpu")
    assert _labels(lambda: embed.infer_batch(frame)) == {
        "tpu_face/embed_cascade.infer_batch", "tpu_face/embed_cascade.call",
        "tpu_face/detect", "tpu_face/nms", "tpu_face/embed_crop",
        "tpu_face/embed"}
    cascade = FaceCascade(device="cpu")
    assert _labels(lambda: cascade.infer_batch(frame)) == {
        "tpu_face/cascade.infer_batch", "tpu_face/cascade.call",
        "tpu_face/detect", "tpu_face/nms", "tpu_face/mesh_warp",
        "tpu_face/mesh", "tpu_face/iris_warp", "tpu_face/iris"}
    profiling.enable(False)
    assert _labels(lambda: cascade.infer_batch(frame)) == set()


def _by_name(got):
    return {s["name"]: s for s in got["spans"]}


def test_spans_are_kept_only_while_tracing():
    profiling.reset()
    _work()
    assert profiling.collect()["spans"] == []
    profiling.enable()
    try:
        with profiling.stage("outer"):
            _work()
            _work()
        _work()
    finally:
        profiling.enable(False)
    _work()
    got = profiling.collect()
    spans = got["spans"]
    assert [s["name"] for s in spans] == ["outer", "unit", "unit", "unit"]
    assert all(s["kind"] == "host" and s["start_ns"] <= s["end_ns"]
               for s in spans)
    outer, a, b, c = spans
    assert outer["parent"] is None and c["parent"] is None
    assert a["parent"] == b["parent"] == 0
    assert a["call"] == b["call"] == outer["call"] != c["call"]
    assert outer["start_ns"] <= a["start_ns"] <= b["end_ns"] <= \
        outer["end_ns"]
    assert outer["self_ns"] == (outer["end_ns"] - outer["start_ns"]
                                - (a["end_ns"] - a["start_ns"])
                                - (b["end_ns"] - b["start_ns"]))
    # collect() cleared them
    assert profiling.collect()["spans"] == []


def test_counters_are_always_on_and_collected():
    profiling.reset()
    assert not profiling.enabled()
    profiling.count("programs.captures")
    profiling.count("programs.captures", 2)
    assert profiling.collect()["counters"] == {"programs.captures": 3}
    assert profiling.collect()["counters"] == {}


def test_self_time_is_duration_less_the_union_of_children():
    # [name, start, end, parent]: children overlap each other and one
    # runs past its parent's end; a grandchild does not count against
    # the root
    spans = [["root", 0, 100, None], ["a", 10, 40, 0], ["b", 30, 50, 0],
             ["c", 90, 120, 0], ["d", 12, 20, 1], ["leaf", 200, 207, None]]
    assert profiling.self_times(spans) == [100 - 40 - 10, 30 - 8, 20, 30,
                                           8, 7]


def _ring(rows):
    """A synthetic stamp ring: {seq: {slot: device ns}}."""
    ring = np.zeros(profiling._HEAD + profiling.ROWS * (1 + profiling.SLOTS),
                    np.int64)
    for seq, slots in rows.items():
        base = profiling._HEAD + (seq % profiling.ROWS) * (
            1 + profiling.SLOTS)
        ring[base] = seq
        for slot, t in slots.items():
            ring[base + 1 + slot] = t
    return ring


def test_ring_shape_is_the_stamp_kernels():
    src = (Path(profiling.__file__).resolve().parents[1] / "csrc"
           / "stage_stamp.cu").read_text()
    consts = dict(re.findall(r"constexpr int(?:64_t)? (k\w+) = (\d+);", src))
    assert int(consts["kRows"]) == profiling.ROWS
    assert int(consts["kSlots"]) == profiling.SLOTS
    assert int(consts["kHead"]) == profiling._HEAD


class _Marks:
    """A card's stamp state as ``_Recorder`` uses it: the slots it marks."""

    def __init__(self):
        self.slots = []

    def mark(self, slot):
        self.slots.append(slot)


@pytest.mark.parametrize("layers", [73, 200, 125, 400])
def test_capture_slots_every_span_the_ring_holds(layers):
    # inside a traced capture: the cascade's stages, then ``layers`` spans
    # inside ``embed`` (a ViT-L's 24 attention cores and 49 LayerNorms; a
    # Swin-S's 24 cores, 53 LayerNorms and 48 window spans; more than the
    # ring holds)
    dev = _Marks()
    profiling.reset()
    profiling._devices[0] = dev
    profiling.enable()
    try:
        with profiling.graph_spans(0) as table:
            for name in ("detect", "nms", "embed_crop"):
                with profiling.stage(name):
                    pass
            with profiling.stage("embed"):
                for i in range(layers):
                    with profiling.stage(f"net.{i % 3}"):
                        pass
        unslotted = profiling.counters["spans.unslotted"]
    finally:
        profiling.enable(False)
        del profiling._devices[0]
        profiling.reset()
    held = profiling.SLOTS // 2 - 2          # after programs.copy_in, .graph
    assert held > 31
    slotted = min(4 + layers, held)
    assert unslotted == 4 + layers - slotted
    assert len(table) == 2 + slotted
    # the graph's begin, each stage's begin and end (embed's around its
    # slotted inner spans), the graph's end
    inner = [s for j in range(6, 2 + slotted) for s in (2 * j, 2 * j + 1)]
    assert dev.slots == [2, 4, 5, 6, 7, 8, 9, 10] + inner + [11, 3]
    embed = table.index(("embed", 1))
    assert all(parent == embed for _, parent in table[embed + 1:])
    stamps = {0: 1, 1: 2}
    stamps.update({s: 100 + s for s in range(2, 4 + 2 * slotted)})
    spans, lost = profiling.decode({0: _ring({9: stamps})},
                                   [(0, 9, 1, table)], {0: lambda d: d})
    assert lost == 0 and len(spans) == 2 + slotted
    assert [s[0] for s in spans] == [name for name, _ in table]


def test_ring_decodes_with_unset_branches_and_lost_rows():
    table = [(profiling.COPY_IN, None), (profiling.GRAPH, None),
             ("track.tracked", 1), ("mesh", 2), ("track.repair", 1),
             ("detect", 4)]
    stamps = {0: 1000, 1: 1100, 2: 1150, 3: 1900, 4: 1200, 5: 1700,
              6: 1250, 7: 1600}          # the repair branch did not run
    later = profiling.ROWS + 7           # took the row of seq 7
    ring = _ring({5: stamps, later: {0: 1}})
    offset = 10**9

    def to_host(d):
        return d + offset

    spans, lost = profiling.decode(
        {0: ring}, [(0, 5, 42, table), (0, 7, 43, table)], {0: to_host})
    assert lost == 1
    assert [s[0] for s in spans] == [profiling.COPY_IN, profiling.GRAPH,
                                     "track.tracked", "mesh"]
    assert [s[3] for s in spans] == [None, None, 1, 2]
    assert all(s[4] == 42 and s[5] == 5 for s in spans)
    assert spans[3][1:3] == [1250 + offset, 1600 + offset]
    assert profiling.self_times([s[:4] for s in spans]) == [100, 250, 150,
                                                            350]


def test_clock_pairing_maps_device_onto_host():
    # the device's timer runs 50 ppm fast and 7 s ahead of the host's
    pairs = [(1_000_000_000, 8_000_000_000, 9_000),
             (3_000_000_000, 8_000_000_000 + 2_000_100_000, 12_000)]
    to_host, drift = profiling._clock(pairs)
    assert to_host(8_000_000_000) == 1_000_000_000
    assert to_host(8_000_000_000 + 2_000_100_000) == 3_000_000_000
    assert to_host(8_000_000_000 + 1_000_050_000) == 2_000_000_000
    assert abs(drift + 1e6 * 100_000 / 2_000_100_000) < 1e-6


def test_host_clock_is_the_one_the_pairing_reads():
    # csrc/stage_stamp.cu brackets its stamp with CLOCK_MONOTONIC
    info = time.get_clock_info("perf_counter")
    assert info.implementation == "clock_gettime(CLOCK_MONOTONIC)"
    assert abs(time.perf_counter_ns()
               - time.clock_gettime_ns(time.CLOCK_MONOTONIC)) < 10**8


def test_cpu_cascade_spans_one_call_id_a_call(frame):
    cascade = FaceCascade(device="cpu")
    x = torch.from_numpy(np.concatenate([frame, frame[:, :, ::-1]]).copy())
    off = cascade(x)
    profiling.reset()
    profiling.enable()
    try:
        on = [cascade(x), cascade(x)]
    finally:
        profiling.enable(False)
    spans = profiling.collect()["spans"]
    for res in on:
        for f in off._fields:
            assert torch.equal(getattr(res, f), getattr(off, f)), f
    calls = [i for i, s in enumerate(spans) if s["name"] == "cascade.call"]
    assert len(calls) == 2 and all(spans[i]["parent"] is None
                                   for i in calls)
    assert spans[calls[0]]["call"] != spans[calls[1]]["call"]
    stages = [s for s in spans if s["name"] != "cascade.call"]
    assert sorted({s["name"] for s in stages}) == [
        "detect", "iris", "iris_warp", "mesh", "mesh_warp", "nms"]
    for s in stages:
        assert s["parent"] in calls
        assert s["call"] == spans[s["parent"]]["call"]


class _Staged(torch.nn.Module):
    def forward(self, x):
        with profiling.stage("unit"):
            return x * 2 + 1


def test_stage_under_export_leaves_no_profiler_node(profiling_on):
    profiling.reset()
    ep = torch.export.export(_Staged(), (torch.ones(3),))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets and not any("profiler" in t for t in targets), targets
    assert profiling.collect()["spans"] == []
    assert torch.equal(ep.module()(torch.ones(3)), torch.full((3,), 3.0))
