"""The span readers (``harness/spans.py`` and the seven metrics that read
it) on a synthetic ``ctx["spans"]`` in ``profiling.collect()``'s form,
and a ``None`` from every one of them where there are no spans."""

import pytest

from harness import spans as sp
from harness.core import load_module
from helpers import HERE

METRICS = ("stage.detect_ms", "stage.nms_ms", "stage.mesh_ms",
           "stage.iris_ms", "stage.other_ms", "programs.launch_wait_ms",
           "programs.host_ms")
MS = 1_000_000
# device spans of one call: (name, parent name, start, end) in ns from
# the call's start; the graph runs 100 us after the copies' end
DEVICE = (("programs.copy_in", None, 0, 20_000),
          ("programs.graph", None, 120_000, 120_000 + 20 * MS),
          ("detect", "programs.graph", 130_000, 130_000 + 5 * MS),
          ("nms", "programs.graph", 130_000 + 5 * MS, 130_000 + 6 * MS),
          ("mesh_warp", "programs.graph", 140_000 + 6 * MS,
           140_000 + 7 * MS),
          ("mesh", "programs.graph", 140_000 + 7 * MS, 140_000 + 11 * MS),
          ("iris_warp", "programs.graph", 150_000 + 11 * MS,
           150_000 + 12 * MS),
          ("iris", "programs.graph", 150_000 + 12 * MS, 150_000 + 16 * MS))
# host spans of one call (name, parent name, start, end); the launch
# covers the wait's middle
HOST = (("cascade.call", None, -50_000, 300_000),
        ("programs.call", "cascade.call", -40_000, 250_000),
        ("programs.copy_in", "programs.call", -30_000, 25_000),
        ("programs.launch", "programs.call", 30_000, 200_000),
        ("programs.clone_out", "programs.call", 210_000, 240_000))


def _collection(calls=3, period=30 * MS):
    out = []
    for c in range(calls):
        t0 = c * period
        for kind, rows in (("host", HOST), ("device", DEVICE)):
            where = {}
            for name, parent, a, b in rows:
                where[name] = len(out)
                out.append({"name": name, "kind": kind, "start_ns": t0 + a,
                            "end_ns": t0 + b, "parent": where.get(parent),
                            "call": c + 1,
                            "seq": c + 1 if kind == "device" else None})
    from tpu_face_torch.utils.profiling import self_times

    own = self_times([[s["name"], s["start_ns"], s["end_ns"], s["parent"]]
                      for s in out])
    for s, o in zip(out, own):
        s["self_ns"] = o
    return {"spans": out, "counters": {}, "clock": {}, "lost_calls": 0}


def _read(name, ctx):
    return load_module(HERE / "metrics" / f"{name}.py").read(ctx)


def test_readers_on_synthetic_spans():
    ctx = {"spans": _collection()}
    got = {m: _read(m, ctx) for m in METRICS}
    want = {"stage.detect_ms": 5.0, "stage.nms_ms": 1.0,
            "stage.mesh_ms": 5.0, "stage.iris_ms": 5.0,
            # 20 ms less the 16 ms of stages
            "stage.other_ms": 4.0,
            "programs.launch_wait_ms": 0.1, "programs.host_ms": 0.29}
    assert got == pytest.approx(want, rel=1e-12)
    stages = sum(got[m] for m in METRICS[:5])
    assert stages == pytest.approx(sp.device_ms(ctx, ("programs.graph",)))


def test_idle_is_attributed_to_the_host_span_open_at_its_middle():
    got = _collection(calls=2)
    waits = sp.launch_waits(got)
    assert [(s, c, b - a) for s, c, a, b in waits] == [(1, 1, 100_000),
                                                      (2, 2, 100_000)]
    table = sp.attribute(got, waits)
    # the launch opens 10 us into the wait and closes after it
    assert table == {"programs.launch": [200_000, 2, 2 * 10_000,
                                         2 * 90_000, 0]}
    # a wait with no host span of its call open lies outside the program
    assert sp.attribute(got, [(9, 99, 0, 10)]) == {
        "outside the program": [10, 1, 0, 0, 0]}
    # a wait that runs past the launch's end
    late = [(1, 1, 150_000, 260_000)]
    assert sp.attribute(got, late) == {"programs.call": [110_000, 1, 0,
                                                         50_000, 60_000]}


def test_a_branch_that_did_not_run_reads_nothing():
    got = _collection()
    got["spans"] = [s for s in got["spans"] if s["name"] != "nms"]
    assert _read("stage.nms_ms", {"spans": got}) is None
    assert _read("stage.detect_ms", {"spans": got}) == pytest.approx(5.0)


@pytest.mark.parametrize("name", METRICS)
def test_no_spans_read_none(name):
    assert _read(name, {"spans": None}) is None
    assert _read(name, {"spans": {"spans": [], "counters": {},
                                  "clock": {}, "lost_calls": 0}}) is None


@pytest.mark.parametrize("name", METRICS)
def test_without_a_card_the_window_reads_none(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = {"config": {}, "traffic": {}}
    assert _read(name, ctx) is None
    assert ctx["spans"] is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent's program: a card, but no ``profiling.collect``."""
    import torch

    from tpu_face_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delattr(profiling, "collect")
    assert sp.window({"config": {}, "traffic": {}}) is None


def test_the_window_runs_in_a_process_of_its_own(monkeypatch):
    """The readers' window runs in a child process, whose answer (here,
    without a card, None) comes back on its last line."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ctx = {"config": {"entry": "face_cascade"}, "traffic": {"batch": 2}}
    assert all(_read(m, ctx) is None for m in METRICS)
    assert ctx["spans"] is None
