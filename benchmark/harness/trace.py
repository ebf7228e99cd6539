"""A bounded traced sub-window: torch.profiler over a fixed number of
calls, reduced to device busy time, device time by operation, idle gaps
by what the host was doing, and runtime calls by name.  The Chrome trace
goes to a temporary file under ``TMPDIR`` and is deleted once read.
Also the device's gaps between the calls of an untraced window, from
CUDA events."""

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")
CALL = "bench.call"
# runtime calls that put work on the device: kernel and graph launches,
# copies and fills
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                   "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                   "cuMemset")


def profile(call, batches, calls):
    """Run ``call`` on ``batches`` in turn ``calls`` times under the
    profiler, each call in a ``bench.call`` range; returns the trace's
    summary (``summarize``)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            with record_function(CALL):
                call(batches[i % len(batches)])
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, calls)


def between_calls(marks):
    """(idle s, span s) of a window's calls, each marked by CUDA events
    (start, done) recorded on the stream at its start and once its work
    is queued: the device's time from the first start to the last done,
    and the part of it from each done to the next call's start, in which
    the stream held nothing of the window's calls."""
    span = marks[0][0].elapsed_time(marks[-1][1]) * 1e-3
    idle = sum(done.elapsed_time(start) for (_, done), (start, _)
               in zip(marks, marks[1:])) * 1e-3
    return idle, span


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, calls, top=10):
    """{"calls", "window_s", "busy_s", "device_ops" {name: s},
    "idle_by_host" {name: s}, "launches" {name: count}} of Chrome-trace
    ``events`` (times in microseconds): the window runs from the first
    ``bench.call`` range's start to the last one's end."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [(e["ts"], e["ts"] + e["dur"]) for e in spans
             if e.get("name") == CALL and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no bench.call range")
    w0, w1 = min(s for s, _ in marks), max(e for _, e in marks)
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    ops = {}
    clipped = []
    for e in dev:
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t > s:
            clipped.append((s, t))
            ops[e["name"]] = ops.get(e["name"], 0.0) + (t - s) * 1e-6
    busy = _union(clipped)
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    gaps = [(s, t) for s, t in zip(edges[0::2], edges[1::2]) if t > s]
    mids = [(s + t) / 2.0 for s, t in gaps]
    labels = ["host: no traced call"] * len(gaps)
    # each gap is named after the innermost host call under way at its
    # middle: the host calls from the longest down, the inner ones last
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                   if e.get("cat") in HOST_CATS and e.get("name") != CALL),
                  key=lambda x: x[0] - x[1])
    for a, b, name in host:
        for i in range(bisect.bisect_left(mids, a),
                       bisect.bisect_right(mids, b)):
            labels[i] = name
    idle = {}
    for (s, t), label in zip(gaps, labels):
        idle[label] = idle.get(label, 0.0) + (t - s) * 1e-6
    launches = {}
    for e in spans:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver") and w0 <= e["ts"]
                <= w1 and e["name"].startswith(LAUNCH_PREFIXES)):
            launches[e["name"]] = launches.get(e["name"], 0) + 1

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:top])

    return {"calls": calls, "window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "device_ops": ops, "top_device_ops": ranked(ops),
            "idle_by_host": ranked(idle), "launches": launches}
