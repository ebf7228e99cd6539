"""One run of one cell: set-up, the measured window, the traced
sub-window, the reference and the comparison, and the result's line.

Everything a cell needs is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<name>.json``, its
traffic in ``traffic/<name>.json``, the configuration's entry point in
``entries/<entry>.py`` and plain reference in ``reference/<name>.py``
(modules of the ``entries`` and ``reference`` packages), and each
metric's reader in ``metrics/<metric>.py`` (loaded by path: a metric's
name has dots).
"""

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import frames, trace
from .window import Reservoir, closed_loop

HERE = Path(__file__).resolve().parents[1]          # the benchmark folder
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_face")
# sampled calls per pool batch whose results the comparison reads
SAMPLES_PER_BATCH = 2
# calls of the traced sub-window (after the measured window)
TRACE_CALLS = 24
# calls after the capturing first call, before the window
WARM_CALLS = 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def read_json(path):
    return json.loads(Path(path).read_text())


def load_module(path):
    """The Python file at ``path`` as a module of its own."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, entry
    point and reference, and the metrics it reports."""

    def __init__(self, bench, name, here=HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        self.here = Path(here)
        self.config = read_json(self.here / "configs"
                                / f"{self.workload['config']}.json")
        self.traffic = read_json(self.here / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.entry = importlib.import_module(
            f"entries.{self.config['entry']}")
        self.reference = importlib.import_module(
            f"reference.{self.config['reference']}")

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric):
        return load_module(self.here / "metrics" / f"{metric}.py").read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def peak_bytes(device):
    return (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)


def _set_up(cell, seed, device, t_start):
    """The program, the frame pool, the capturing first call and the warm
    calls; returns (program, pool, {part: s})."""
    setup = {"process": time.perf_counter() - t_start}
    t = time.perf_counter()
    program = cell.entry.build(cell.config, device)
    setup["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = frames.make_pool(cell.traffic, cell.here / "traffic", seed, device)
    if pool[0].is_cuda:
        torch.cuda.synchronize(device)
    setup["frames"] = time.perf_counter() - t
    t = time.perf_counter()
    cell.entry.call(program, pool[0])          # builds, captures
    setup["first_call"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(WARM_CALLS):
        cell.entry.call(program, pool[(i + 1) % len(pool)])
    setup["warm_calls"] = time.perf_counter() - t
    return program, pool, setup


def compare(cell, kept, refs):
    """{number: (value, limit)} of calls' results ``kept`` {pool index:
    [result, ...]} against the reference's results of their pool
    batches."""
    k = cell.config["max_faces"]
    got, ref = {}, {}
    for p, outs in sorted(kept.items()):
        for out in outs:
            for f, a in cell.entry.with_face_axis(
                    {f: v.numpy() for f, v in out.items()}, k).items():
                got.setdefault(f, []).append(a)
            for f, a in refs[p].items():
                ref.setdefault(f, []).append(a)
    numbers = cell.entry.compare(
        {f: np.concatenate(v) for f, v in got.items()},
        {f: np.concatenate(v) for f, v in ref.items()},
        (cell.traffic["width"], cell.traffic["height"]))
    limits = cell.config["limits"]
    return {n: (float(v), float(limits[n])) for n, v in numbers.items()}


def run_cell(cell, seed, seconds, traced, device, t_start, root,
             device_record=None):
    """One run; returns (result line dict, checks {name: (value, limit)}).
    ``t_start`` is the host clock at the process's start (set-up counts
    from it); ``root`` the checkout, whose ``tpu_face/data`` holds the
    weights."""
    program, pool, setup = _set_up(cell, seed, device, t_start)

    def call(batch):
        return cell.entry.call(program, batch)

    # traced on the card, each call of the window is marked on the stream
    # by a CUDA event at its start and one once its work is queued
    marks = []

    def marked_call(batch):
        start, done = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record(torch.cuda.current_stream(device))
        out = cell.entry.call(program, batch, done=done)
        marks.append((start, done))
        return out

    marked = traced and pool[0].is_cuda
    sample = Reservoir(SAMPLES_PER_BATCH, seed)
    setup_s = time.perf_counter() - t_start
    lat, window_s, counts = closed_loop(marked_call if marked else call,
                                        pool, seconds, sample,
                                        min_calls=len(pool))
    gaps = trace.between_calls(marks) if marks else None
    memory_peak = peak_bytes(device)
    summary = (trace.profile(call, pool, TRACE_CALLS) if traced else None)
    captures = cell.entry.programs(program)
    del program, call
    if pool[0].is_cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    t = time.perf_counter()
    refs = cell.reference.run(cell.config, pool, root)
    reference_s = time.perf_counter() - t
    checks = compare(cell, sample.kept, refs)

    faces = [float(r["face_valid"].sum()) for r in refs]
    ctx = {"config": cell.config, "traffic": cell.traffic, "root": root,
           "latencies_s": lat, "window_s": window_s, "counts": counts,
           "frames": sum(counts) * cell.traffic["batch"],
           "setup_s": setup_s, "reference_faces": faces, "trace": summary,
           "device_gaps": gaps}
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    for name, value in setup.items():
        log(f"setup {name}: {value:.3f} s")
    for name, s, nbytes in captures:
        log(f"setup capture {name}: {s:.3f} s, pool {nbytes} bytes")
    build = sys.modules.get("tpu_face_torch.ops._build")
    for lib, rec in sorted(getattr(build, "BUILD_LOG", {}).items()):
        log(f"setup build {lib}: {rec['seconds']:.3f} s"
            f"{' (cached)' if rec['cached'] else ''}")
    log(f"setup total: {setup_s:.3f} s; reference {reference_s:.3f} s "
        f"(after the window, not in setup_s); memory peak {memory_peak} "
        f"bytes")
    log(f"window: {len(lat)} calls, {window_s:.3f} s; calls per pool "
        f"batch {counts}; reference faces per frame "
        f"{sum(faces) / (len(refs) * cell.traffic['batch']):.4f}")

    dev = dict(device_record or {"platform": "cpu", "kind": "cpu",
                                 "count": 1})
    dev["memory_peak_bytes"] = memory_peak
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(lat), "failed": 0, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in
                           summary["top_device_ops"].items()],
            "idle_gaps": [[n[:160], s] for n, s in
                          summary["idle_by_host"].items()]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result, checks
