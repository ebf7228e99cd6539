"""The program's own spans (``tpu_face_torch.utils.profiling``) over a
stamped window, and what the per-layer metrics read from them.

The first reader that asks (``of``) runs the window once and keeps its
collection in ``ctx["spans"]``: in a process of its own, a second build
of the cell's program on the card, its untraced graph captured and
warmed, then its stamped graph captured by one call with tracing on;
then ``ROUNDS`` rounds of ``CHUNK`` closed-loop calls untraced and
``CHUNK`` stamped, in turns (ABBA), with no profiler; then
``profiling.collect()``.  It logs on standard error the device ms a call
by stage beside the traced sub-window's, both sides' frames/s, the
captures and builds in each side's calls, the clock pairing's error and
drift, and each device idle interval inside the stamped calls by the
innermost host span open at its middle.  A program without spans (no
``profiling.collect``), or a run without a card, reads nothing:
``ctx["spans"]`` is None and every reader returns None.

The frames come from a fixed seed: stage times do not depend on which
faces are in them, and the window's results are not compared.
"""

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

from . import frames

HERE = Path(__file__).resolve().parents[1]
# calls a side, in rounds of CHUNK calls
CHUNK = 32
ROUNDS = 8
SEED = 2**31 + 17
# seconds the window's process may take
CHILD_S = 600
GRAPH, COPY_IN = "programs.graph", "programs.copy_in"
CALL, LAUNCH = "programs.call", "programs.launch"


def log(msg):
    from .core import log as _log

    _log(f"spans: {msg}")


def of(ctx):
    """The stamped window's collection (``profiling.collect()``'s dict
    with ``"window"`` added), run on first use; None where nothing can
    be read."""
    if "spans" not in ctx:
        ctx["spans"] = stamped_window(ctx)
    return ctx["spans"]


# ---- the readers' arithmetic --------------------------------------------


def _device(got, name):
    return [s for s in got["spans"]
            if s["kind"] == "device" and s["name"] == name]


def stamped_calls(got):
    """The stamped program calls whose graph span was read."""
    return len(_device(got, GRAPH)) if got else 0


def device_ms(ctx, names):
    """Device ms a stamped call in the spans ``names`` (None if none)."""
    got = of(ctx)
    calls = stamped_calls(got)
    picked = [s for n in names for s in _device(got, n)] if calls else []
    if not picked:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in picked) * 1e-6 / calls


def own_ms(ctx, name):
    """Device self time a stamped call of the span ``name``: its
    duration less the union of its children's."""
    got = of(ctx)
    calls = stamped_calls(got)
    picked = _device(got, name) if calls else []
    if not picked:
        return None
    return sum(s["self_ns"] for s in picked) * 1e-6 / calls


def host_ms(ctx, name):
    """The mean host ms of the host span ``name``."""
    got = of(ctx)
    picked = [s for s in got["spans"]
              if s["kind"] == "host" and s["name"] == name] if got else []
    if not picked:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in picked) * 1e-6 / len(
        picked)


def launch_waits(got):
    """[(seq, call, start, end)] of each stamped call's device idle from
    its ``programs.copy_in``'s end to its ``programs.graph``'s start."""
    ends = {s["seq"]: s for s in _device(got, COPY_IN)}
    out = []
    for g in _device(got, GRAPH):
        c = ends.get(g["seq"])
        if c is not None:
            out.append((g["seq"], g["call"], c["end_ns"],
                        max(c["end_ns"], g["start_ns"])))
    return out


def launch_wait_ms(ctx):
    got = of(ctx)
    waits = launch_waits(got) if got else []
    if not waits:
        return None
    return sum(b - a for _, _, a, b in waits) * 1e-6 / len(waits)


def attribute(got, intervals):
    """{label: [ns, count, ns before, inside and after programs.launch]}
    of device idle ``intervals`` [(seq, call, start, end)]: each named
    after the innermost host span of its call open at its middle, else
    "outside the program"; its overlap with the time before the call's
    ``programs.launch`` span opens, with the span, and after it closes."""
    by_call = {}
    for s in got["spans"]:
        if s["kind"] == "host":
            by_call.setdefault(s["call"], []).append(s)
    out = {}
    for _, call, a, b in intervals:
        mid = (a + b) / 2
        open_ = [s for s in by_call.get(call, ())
                 if s["start_ns"] <= mid <= s["end_ns"]]
        label = (max(open_, key=lambda s: s["start_ns"])["name"]
                 if open_ else "outside the program")
        row = out.setdefault(label, [0, 0, 0, 0, 0])
        row[0] += b - a
        row[1] += 1
        for s in by_call.get(call, ()):
            if s["name"] == LAUNCH:
                row[2] += max(0, min(b, s["start_ns"]) - a)
                row[3] += max(0, min(b, s["end_ns"]) - max(a, s["start_ns"]))
                row[4] += max(0, b - max(a, s["end_ns"]))
    return out


# ---- the window ---------------------------------------------------------


def _calls(entry, program, pool, n):
    t = time.perf_counter()
    for i in range(n):
        entry.call(program, pool[i % len(pool)])
    return time.perf_counter() - t


def stamped_window(ctx):
    """The window (``window``) run in a process of its own, its
    collection read from the last line of the process's output and
    reported here.  In this process, after the traced sub-window, the
    profiler's CUPTI subscription outlives the profile and adds ~0.6 ms
    of host time to every graph launch (kineto tears it down only under
    ``TEARDOWN_CUPTI=1``), which the launch wait would read."""
    import torch

    if not torch.cuda.is_available():
        return None
    job = json.dumps({"config": ctx["config"], "traffic": ctx["traffic"]})
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; "
            "from harness.spans import window; "
            "print(json.dumps(window(json.loads(sys.argv[3]))))")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(HERE), str(HERE.parent), job],
        stdout=subprocess.PIPE, text=True, cwd=HERE.parent,
        timeout=CHILD_S)
    if proc.returncode != 0:
        raise RuntimeError(f"the stamped window's process exited with "
                           f"{proc.returncode}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if got is not None:
        _report(ctx, got)
    return got


def window(job):
    """The stamped window of the program that ``job``'s "config" and
    "traffic" build, in this process; None without a card or without
    spans in the program."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from tpu_face_torch.ops import _build
        from tpu_face_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "collect"):
        log("the program records no spans")
        return None
    cfg, traffic = job["config"], dict(job["traffic"], pool=2)
    entry = importlib.import_module(f"entries.{cfg['entry']}")
    device = torch.device("cuda", 0)
    pool = frames.make_pool(traffic, HERE / "traffic", SEED, device)
    program = entry.build(cfg, device)
    try:
        for batch in pool:                 # the untraced graph
            entry.call(program, batch)
        profiling.enable()
        known = len(entry.programs(program))
        t = time.perf_counter()
        entry.call(program, pool[0])       # captures the stamped graph
        first_s = time.perf_counter() - t
        entry.call(program, pool[1])
        profiling.enable(False)
        for name, s, nbytes in entry.programs(program)[known:]:
            log(f"capture {name}: {s:.3f} s, pool {nbytes} bytes "
                f"(the stamped graph's first call {first_s:.3f} s)")
        profiling.reset()
        seconds = {"untraced": 0.0, "stamped": 0.0}
        seen = {side: {"captures": 0, "builds": 0} for side in seconds}
        for r in range(ROUNDS):
            order = ("untraced", "stamped")
            for side in order if r % 2 == 0 else order[::-1]:
                profiling.enable(side == "stamped")
                captures = profiling.counters["programs.captures"]
                builds = set(_build.BUILD_LOG)
                seconds[side] += _calls(entry, program, pool, CHUNK)
                seen[side]["captures"] += (
                    profiling.counters["programs.captures"] - captures)
                seen[side]["builds"] += len(set(_build.BUILD_LOG) - builds)
        profiling.enable(False)
        got = profiling.collect()
    finally:
        profiling.enable(False)
    got["window"] = {
        "calls": CHUNK * ROUNDS, "seconds": seconds, "seen": seen,
        "frames_per_s": {k: CHUNK * ROUNDS * traffic["batch"] / s
                         for k, s in seconds.items()}}
    return got


def _report(ctx, got):
    w = got["window"]
    calls = stamped_calls(got)
    stages = {name: device_ms({"spans": got}, names) or 0.0 for name, names
              in (("detect", ("detect",)), ("nms", ("nms",)),
                  ("mesh", ("mesh_warp", "mesh")),
                  ("iris", ("iris_warp", "iris")))}
    stages["other"] = own_ms({"spans": got}, GRAPH) or 0.0
    total = sum(stages.values())
    log(f"{calls} stamped calls ({got['lost_calls']} lost); device ms a "
        f"call by stage: " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in stages.items())
        + f"; sum {total:.4f}; programs.graph "
        f"{device_ms({'spans': got}, (GRAPH,)) or 0.0:.4f}")
    t = ctx.get("trace")
    if t and t.get("calls"):
        busy = t["busy_s"] * 1e3 / t["calls"]
        kernels = sum(s for n, s in t["device_ops"].items()
                      if not n.startswith(("Memcpy", "Memset"))
                      ) * 1e3 / t["calls"]
        log(f"traced sub-window device ms a call: busy {busy:.4f}, kernels "
            f"{kernels:.4f}; stage sum / busy {total / busy:.4f}, / kernels "
            f"{total / kernels:.4f}")
    fps = w["frames_per_s"]
    window = (ctx["frames"] / ctx["window_s"]
              if ctx.get("window_s") else float("nan"))
    log(f"frames/s stamped {fps['stamped']:.1f}, untraced "
        f"{fps['untraced']:.1f} ({ROUNDS} turns of {CHUNK} calls a side): "
        f"tracing costs {100 * (1 - fps['stamped'] / fps['untraced']):.3f}%"
        f"; the measured window's {window:.1f}")
    for side, seen in w["seen"].items():
        log(f"{side} calls: {seen['captures']} captures, {seen['builds']} "
            f"builds")
    for dev, c in got["clock"].items():
        log(f"clock pairing, card {dev}: error (widest bracket) "
            f"{c['error_ns'] * 1e-3:.3f} us, drift {c['drift_ppm']:.3f} "
            f"ppm over {c['pairs']} pairings")
    waits = launch_waits(got)
    wait_ns = sum(b - a for _, _, a, b in waits)
    log(f"device idle inside the stamped calls (programs.copy_in's end to "
        f"programs.graph's start), {len(waits)} calls, "
        f"{wait_ns * 1e-6 / max(1, len(waits)):.4f} ms a call, by the host "
        f"span open at its middle:")
    log(f"  {'innermost host span':<24} {'ms':>10}  {'intervals':>9}  "
        f"share before / inside / after programs.launch")
    for label, (ns, n, *parts) in sorted(attribute(got, waits).items(),
                                         key=lambda kv: -kv[1][0]):
        log(f"  {label:<24} {ns * 1e-6:10.4f}  {n:9d}  " + " / ".join(
            f"{100 * p / max(1, ns):.2f}%" for p in parts))
    host = host_ms({"spans": got}, CALL)
    if host is not None:
        log(f"host ms a call in programs.call {host:.4f}, of which "
            + ", ".join(f"{n} {host_ms({'spans': got}, n) or 0.0:.4f}"
                        for n in (COPY_IN, LAUNCH, "programs.clone_out")))
