"""Batch data parallelism across CUDA devices (counterpart of
tpu_face/parallel/sharding.py).

The JAX package shards a frame batch over a device mesh and lets XLA
partition the one fused program.  Here a mesh is a list of devices, and
the batch is split into one chunk per device: each chunk runs through a
replica of the cascade on its device (the same constructor arguments,
the weights read once per device, ``FaceCascade.replica``), and the
results are concatenated in batch order on the cascade's device.  A
cascade call has no host sync, so every shard's work is queued before
any result is read.  Nothing crosses between devices but the chunks and
the results: there are no collectives.

Trackers shard their streams the same way: one replica tracker per shard
holds its streams' state on its device.  Each step's decisions are taken
over all B streams (``FaceTracker._sharded_step``), as the JAX tracker
takes them with the global predicates of one partitioned program, and
without a host read: where JAX all-reduces each predicate, the shards'
flags are copied device to device to the tracker's device, the entry
decision and the repair's selection are computed there, and each shard
gets its part back the same way.  Each shard runs two cached programs a
step (its stages under the entry decision; its repair over a fixed
number of rows, then its next state), so a step's repair runs on every
shard that holds a repaired stream, at the repair batch each.

A mesh may name a device more than once: that is how a single card (or
the CPU, in tests) runs several shards.

A cascade or tracker with an attached artifact (``tpu_face_torch.aot``)
is refused: its programs are fixed-batch programs for one device, and
the shards run the Python stages of replicas built without them.
"""

from typing import Optional, Sequence

import numpy as np
import torch


def data_parallel_mesh(devices: Optional[Sequence] = None) -> list:
    """The mesh over ``devices`` (default: every visible CUDA device), as
    a list of ``torch.device``; an explicit list may repeat a device.
    Without a card the default raises: there is no CPU fallback."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("data_parallel_mesh() needs a CUDA device; "
                               "pass devices=[...] for another mesh")
        return [torch.device("cuda", i) for i in range(n)]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_batch(images, mesh) -> list:
    """A batch [B, ...] (numpy or torch) as ``len(mesh)`` equal chunks
    along the batch axis, chunk i on ``mesh[i]``.  B must divide by the
    mesh size."""
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.require(images, requirements="CW"))
    b, n = images.shape[0], len(mesh)
    if b % n != 0:
        raise ValueError(f"batch {b} not divisible by mesh size {n}")
    return [chunk.to(dev, non_blocking=True)
            for chunk, dev in zip(images.split(b // n), mesh)]


def _unattached(obj, fn):
    """Refuse ``obj`` (a cascade or a tracker) if it has programs
    installed by ``aot.attach``."""
    if obj._programs:
        raise ValueError(
            f"{fn} cannot run a {type(obj).__name__} with an attached "
            "artifact: its programs take the saved batch on one device, "
            "and the shards would run without them; shard an object "
            "without one")


def infer_sharded(cascade, images, mesh: Optional[Sequence] = None):
    """Run a ``FaceCascade`` or ``EmbedCascade`` over ``images`` split
    across ``mesh`` (default ``data_parallel_mesh()``): one replica per
    device, every shard launched before any result is read; one result
    with every field concatenated in batch order on the cascade's
    device.  A cascade with an attached artifact raises ``ValueError``."""
    _unattached(cascade, "infer_sharded")
    mesh = data_parallel_mesh() if mesh is None else mesh
    parts = [cascade.replica(dev)(chunk)
             for chunk, dev in zip(shard_batch(images, mesh), mesh)]
    return type(parts[0])(*(torch.cat([f.to(cascade.device) for f in fields])
                            for fields in zip(*parts)))


def track_sharded(tracker, images, mesh: Optional[Sequence] = None):
    """Step a ``FaceTracker`` or ``MultiFaceTracker`` with its B streams
    split across ``mesh`` (default ``data_parallel_mesh()``): each shard's
    state stays on its device across steps, a repaired stream is
    re-detected on the device that holds it, and the step's decisions
    are the unsharded tracker's.  Returns the result of all B streams on
    the tracker's device; ``tracker.tracking`` and ``face_count`` report
    all of them.  A tracker with an attached artifact raises
    ``ValueError``."""
    _unattached(tracker, "track_sharded")
    mesh = data_parallel_mesh() if mesh is None else mesh
    return tracker._sharded_step(shard_batch(images, mesh), mesh)
