"""utils.profiling's device spans on a CUDA card (each test skips without
one; run on the card with ``python -m pytest tests/test_torch_spans_card.py
-q``).

* A ``FaceCascade`` at 540p b8 gives bit-identical results with tracing
  on (its stamped graph) and off (its untraced graph).
* A ``FaceTracker`` step that takes the repair branch, traced, gives the
  untraced tracker's results and a device span for each branch that ran
  (``track.full`` on the first step; ``track.tracked`` and
  ``track.repair`` on the step with a stream blanked), none for a branch
  that did not.
* The stamps' stage times agree within 3% with torch.profiler's time
  between the same stamp kernels in its trace of the replays.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.tracking import FaceTracker
from tpu_face_torch.utils import profiling
from tpu_face_torch.utils.image_io import load_image

ROT = Path(__file__).resolve().parents[1] / "assets" / "rotated"
NAMES = ("man_rotm15.png", "man_rotm30.png", "man_rotp15.png",
         "man_rotp30.png")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda", 0)
    profiling.enable(False)
    profiling.reset()


def _frames(device):
    """540x360 b8: the four rotated frames and their mirror images."""
    imgs = [load_image(ROT / n) for n in NAMES]
    imgs += [np.ascontiguousarray(i[:, ::-1]) for i in imgs]
    return torch.from_numpy(np.stack(imgs)).to(device)


def _same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            assert torch.equal(torch.nan_to_num(x, nan=7.0),
                               torch.nan_to_num(y, nan=7.0)), f
            assert torch.equal(x.isnan(), y.isnan()), f
        else:
            assert torch.equal(x, y), f


def _device_names(got):
    return {s["name"] for s in got["spans"] if s["kind"] == "device"}


def test_cascade_bit_identical_with_tracing_on_and_off(card):
    cascade = FaceCascade(device=card)
    x = _frames(card)
    off = cascade(x)
    profiling.enable()
    on = [cascade(x), cascade(x)]
    profiling.enable(False)
    for res in on + [cascade(x)]:
        _same(res, off)
    got = profiling.collect()
    assert _device_names(got) == {
        "programs.copy_in", "programs.graph", "detect", "nms", "mesh_warp",
        "mesh", "iris_warp", "iris"}
    graphs = [s for s in got["spans"] if s["name"] == "programs.graph"]
    assert len(graphs) == 2 and got["lost_calls"] == 0
    assert all(c["error_ns"] <= 100_000 for c in got["clock"].values())


def test_tracker_repair_step_spans_each_branch_that_ran(card):
    x = _frames(card)
    blank = x.clone()
    blank[2] = 0
    plain = FaceTracker(repair_batch=2, device=card)
    traced = FaceTracker(repair_batch=2, device=card)
    seen = []
    for frames in (x, blank):
        want = plain.step(frames)
        profiling.enable()
        got = traced.step(frames)
        profiling.enable(False)
        _same(got, want)
        seen.append(_device_names(profiling.collect()))
    assert "track.full" in seen[0]
    assert not {"track.tracked", "track.repair"} & seen[0]
    assert {"track.tracked", "track.repair"} <= seen[1]
    assert "track.full" not in seen[1]


def test_stage_ms_match_the_profiler_between_the_stamps(card, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv("TEARDOWN_CUPTI", "1")
    cascade = FaceCascade(device=card)
    x = _frames(card)
    calls = 4
    profiling.enable()
    cascade(x)
    cascade(x)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cascade(x)
        torch.cuda.synchronize()
    profiling.enable(False)
    got = profiling.collect()
    kernels = sorted(e.time_range.start for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "stamp" in e.name and "stamp_at" not in e.name)
    (program,) = [p for k, p in cascade._cache.entries.items()
                  if k[-1] == "stamped"]
    table = program.table
    # a cascade's replay stamps in this order: the copies' two, the
    # graph's begin, each stage's two, the graph's end
    order = [0, 1, 2] + [s for j in range(2, len(table))
                         for s in (2 * j, 2 * j + 1)] + [3]
    assert len(kernels) == calls * len(order)
    at = {}
    for c in range(calls):
        for i, slot in enumerate(order):
            at[c, slot] = kernels[c * len(order) + i] * 1e3   # ns
    device = [s for s in got["spans"] if s["kind"] == "device"]
    seqs = sorted({s["seq"] for s in device})
    assert len(seqs) == calls
    for j, (name, _) in enumerate(table):
        if j == 0:
            continue
        mine = sum(s["end_ns"] - s["start_ns"] for s in device
                   if s["name"] == name)
        theirs = sum(at[c, 2 * j + 1] - at[c, 2 * j] for c in range(calls))
        assert mine == pytest.approx(theirs, rel=0.03), (name, mine,
                                                         theirs)
