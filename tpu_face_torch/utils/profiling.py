"""Per-stage profiling hooks, off by default (counterpart of
tpu_face/utils/profiling.py).

* ``stage(name)`` labels a region ``tpu_face/<name>`` when profiling is
  enabled (``enable()`` or ``TPU_FACE_PROFILE=1``): a
  ``torch.profiler.record_function`` range, which traces attribute the
  region's host time and its kernels to, and on a CUDA card also an NVTX
  range.  The cascades wrap ``infer_batch`` and each of their stages in
  it (the JAX package's ``jax.named_scope`` labels: detect, nms,
  mesh_warp, mesh, iris_warp, iris, embed_crop, embed).  Disabled, it
  does nothing.
* ``device_trace(log_dir)`` profiles the enclosed region (CPU and, on a
  card, CUDA activity) and writes it into ``log_dir`` as a Chrome trace.
"""

import contextlib
import itertools
import os
from pathlib import Path

import torch

_enabled = os.environ.get("TPU_FACE_PROFILE", "0") not in ("", "0")
_traces = itertools.count()


def enable(on: bool = True) -> None:
    """Turn the stage labels on or off for this process."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def stage(name: str):
    """Profiler label ``tpu_face/<name>`` (a no-op unless enabled)."""
    if not _enabled:
        yield
        return
    label = f"tpu_face/{name}"
    with contextlib.ExitStack() as labels:
        labels.enter_context(torch.profiler.record_function(label))
        if torch.cuda.is_available():
            labels.enter_context(torch.cuda.nvtx.range(label))
        yield


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed region (always active: callers opt in by
    using it) and write a Chrome trace ``trace_<pid>_<n>.json`` into
    ``log_dir``; yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{next(_traces)}.json"))
