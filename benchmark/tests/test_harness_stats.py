"""The host-clock arithmetic, the closed loop, the sample and the trace's
reduction."""

import math
import time

import pytest

from harness import trace
from harness.window import Reservoir, closed_loop, p95


def test_p95_nearest_rank():
    assert p95([5.0]) == 5.0
    vals = list(range(1, 101))           # 1..100
    assert p95(vals) == 95
    assert p95(list(reversed(vals))) == 95
    assert p95(list(range(1, 21))) == 19    # ceil(0.95 * 20) = 19th
    assert p95(list(range(1, 22))) == 20    # ceil(19.95) = 20th


def test_closed_loop_rate_and_latency():
    pool = ["a", "b", "c"]
    seen = []

    def call(batch):
        seen.append(batch)
        time.sleep(0.01)
        return batch

    sample = Reservoir(2, 7)
    lat, window_s, counts = closed_loop(call, pool, 0.2, sample, min_calls=3)
    assert seen[:4] == ["a", "b", "c", "a"]
    assert sum(counts) == len(lat) == len(seen)
    assert window_s >= 0.2 and window_s >= sum(lat)
    assert all(v >= 0.01 for v in lat)
    # frames per second of a batch of 4 frames
    rate = 4 * len(lat) / window_s
    assert 4 * len(lat) / (sum(lat) + 0.05) <= rate <= 4 / 0.01
    assert {k: len(v) for k, v in sample.kept.items()} == {0: 2, 1: 2, 2: 2}


def test_min_calls_cover_the_pool():
    lat, _, counts = closed_loop(lambda b: b, [1, 2, 3, 4], 0.0,
                                 Reservoir(1, 0), min_calls=4)
    assert counts == [1, 1, 1, 1] and len(lat) == 4


def test_reservoir_is_seeded_and_uniform():
    def kept(seed):
        r = Reservoir(2, seed)
        for i in range(1000):
            r.offer(i % 2, i)
        return r.kept

    assert kept(3) == kept(3)
    assert kept(3) != kept(4)
    firsts = [kept(s)[0][0] for s in range(200)]
    assert sum(f > 500 for f in firsts) > 50     # late calls are drawn too


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary():
    events = [
        _x("user_annotation", trace.CALL, 0, 100),
        _x("user_annotation", trace.CALL, 100, 100),
        _x("cuda_runtime", "cudaGraphLaunch", 5, 5),
        _x("cuda_runtime", "cudaMemcpyAsync", 90, 2),
        _x("cuda_runtime", "cudaStreamSynchronize", 120, 70),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 3),
        _x("kernel", "k1", 10, 40),
        _x("kernel", "k2", 40, 20),          # overlaps k1
        _x("gpu_memcpy", "Memcpy DtoH", 130, 50),
        _x("kernel", "late", 250, 10),       # after the window
    ]
    s = trace.summarize(events, calls=2)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(100e-6)       # [10, 60] + [130, 180]
    assert s["device_ops"] == pytest.approx({"k1": 40e-6, "k2": 20e-6,
                                             "Memcpy DtoH": 50e-6})
    assert sum(s["idle_by_host"].values()) == pytest.approx(100e-6)
    # [60, 130] is idle while the host copies and launches; [180, 200]
    # while it synchronizes
    assert s["idle_by_host"]["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert s["launches"] == {"cudaGraphLaunch": 1, "cudaMemcpyAsync": 1,
                             "cudaLaunchKernel": 1}
    assert math.isclose(100.0 * (1 - s["busy_s"] / s["window_s"]), 50.0)


def test_trace_without_calls_raises():
    with pytest.raises(RuntimeError):
        trace.summarize([_x("kernel", "k", 0, 1)], calls=1)


class _Event:
    """A stand-in for a CUDA event recorded at ``ms`` on the stream."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, later):
        return later.ms - self.ms


def test_device_gaps_between_calls():
    # three calls on the stream's clock: [0, 20], [20.5, 40.5], [41, 61]
    marks = [(_Event(s), _Event(e)) for s, e in
             ((0.0, 20.0), (20.5, 40.5), (41.0, 61.0))]
    idle, span = trace.between_calls(marks)
    assert span == pytest.approx(61e-3)
    assert idle == pytest.approx(1e-3)
    from harness.core import load_module, HERE
    read = load_module(HERE / "metrics" / "device.idle_pct.py").read
    assert read({"device_gaps": (idle, span)}) == pytest.approx(100 / 61)
    # a run with no marked window (on the CPU) reports nothing
    assert read({"device_gaps": None}) is None
