"""tpu_face_torch.parallel (batch data parallelism across devices) on
the CPU, the counterparts of tests/test_sharding.py.  A mesh here names
the CPU several times, as the JAX suite's 8 virtual CPU devices stand in
for chips: only the split, the replicas, the global step decisions and
the merge are tested here; ``chip_smoke.py`` runs the same on the card.

* ``data_parallel_mesh``: 8 CPU entries; without a card the default mesh
  raises.  ``shard_batch``: the layout, and "not divisible".
* ``FaceCascade(SHORT)`` at 64x64 batch 8 (seeded random frames) over 8
  shards against the unsharded call and against
  ``tpu_face.parallel.infer_sharded`` on the JAX suite's 8-device CPU
  mesh: within 2e-3 with the flags equal (tests/test_sharding.py's
  tolerance: the shards run the nets at another batch size, which
  reassociates their sums).
* Planar input against HWC and ``EmbedCascade`` (demo graph) sharded
  against unsharded (embeddings within 2e-4, as tests/test_sharding.py),
  over two shards.
* ``track_sharded`` against the unsharded port tracker, ``FaceTracker``
  and ``MultiFaceTracker(max_faces=2)``: four streams of 540x360 frames
  over two shards, three steps (full; stream 2, on the second shard,
  blanked: it is lost and the repair finds no face; back: the repair on
  its shard locks it again), ``MultiFaceTracker``'s first step unsharded
  (the streams' state goes out to the shards); then an unsharded step
  after the sharded ones (it comes back).  Results within 2e-3 with the
  flags equal, ``tracking`` and ``face_count`` over all four streams
  equal.
* ``track_sharded`` from a set state in every branch (``repair_batch=2``,
  four streams over two shards, ``CASES``): forced, mass loss (three
  streams unlocked), locked, a repair of a lost stream in each shard, and
  three lost streams across the shards (stream 0 unlocked, stream 2
  blanked, stream 3 unlocked on a blank... see ``CASES``), where the
  repair takes the first two lost streams of all four, not the first of
  each shard: the unsharded step's result (within 2e-3, flags equal) and
  lock flags.
* Outside its two cached programs per shard (each cond run on both
  sides, as a capture's warm-up runs it), a sharded step after the first
  reads nothing back to the host (tests/test_torch_bench.py's
  ``_HostValues``).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_bench import _HostValues
from test_torch_programs import _EagerProgram
from test_torch_threads import share_cores  # noqa: F401
import tpu_face
from test_rotation_e2e import ROT
from tpu_face.models.face_detection import FaceDetectionModel as JaxModel
from tpu_face.parallel import data_parallel_mesh as jax_mesh
from tpu_face.parallel import infer_sharded as jax_infer_sharded
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch import programs
from tpu_face_torch.models.face_detection import FaceDetectionModel
from tpu_face_torch.parallel import (data_parallel_mesh, infer_sharded,
                                     shard_batch, track_sharded)
from tpu_face_torch.pipeline import EmbedCascade, FaceCascade
from tpu_face_torch.tracking import FaceTracker, MultiFaceTracker
from tpu_face_torch.utils.image_io import load_image

TOL = 2e-3
DEMO = str(Path(tpu_face.__file__).parent / "data" / "demo")


def _close(got, want, tol=TOL):
    """Field by field: bools equal, numbers within ``tol``."""
    for f in want._fields:
        a = np.asarray(getattr(got, f))
        b = np.asarray(getattr(want, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b.astype(a.dtype), atol=tol,
                                       rtol=0, err_msg=f)


@pytest.fixture(scope="module")
def random_frames():
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, size=(8, 64, 64, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def short():
    return FaceCascade(FaceDetectionModel.SHORT, device="cpu")


def test_mesh_of_8_cpu_entries(monkeypatch):
    mesh = data_parallel_mesh(["cpu"] * 8)
    assert mesh == [torch.device("cpu")] * 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        data_parallel_mesh()


def test_shard_batch_layout():
    imgs = np.arange(16 * 8 * 8 * 3, dtype=np.int64).reshape(16, 8, 8, 3)
    chunks = shard_batch(imgs, data_parallel_mesh(["cpu"] * 8))
    assert len(chunks) == 8
    assert all(c.shape == (2, 8, 8, 3) and c.device.type == "cpu"
               for c in chunks)
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), imgs)


def test_shard_batch_requires_divisible():
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(np.zeros((3, 8, 8, 3), np.uint8),
                    data_parallel_mesh(["cpu"] * 8))


def test_sharded_cascade_matches_unsharded_and_jax(short, random_frames):
    mesh = data_parallel_mesh(["cpu"] * 8)
    sharded = infer_sharded(short, random_frames, mesh)
    assert sharded.mesh.device.type == "cpu"
    _close(sharded, short.infer_batch(random_frames))
    assert len(jax.devices()) == 8      # tests/conftest.py's CPU mesh
    ref = jax.block_until_ready(jax_infer_sharded(
        JaxFaceCascade(JaxModel.SHORT), random_frames, jax_mesh()))
    _close(sharded, ref)


def test_sharded_planar_matches_hwc(short, random_frames):
    mesh = data_parallel_mesh(["cpu"] * 2)
    planar = np.ascontiguousarray(random_frames.transpose(0, 3, 1, 2))
    out = infer_sharded(FaceCascade(FaceDetectionModel.SHORT,
                                    input_layout="planar", device="cpu"),
                        planar, mesh)
    _close(out, infer_sharded(short, random_frames, mesh))


def test_sharded_embed_cascade_matches_unsharded():
    img = load_image(ROT / "man_rotm15.png")
    batch = np.stack([np.roll(img, 6 * i, axis=1) for i in range(4)])
    cas = EmbedCascade(FaceDetectionModel.SHORT, embed_model_path=DEMO,
                       device="cpu")
    out = infer_sharded(cas, batch, data_parallel_mesh(["cpu"] * 2))
    ref = cas.infer_batch(batch)
    _close(out, ref, tol=2e-4)
    assert bool(out.face_valid.all())


def _steps():
    """Four streams (each shifted 4 px more) over three steps: a full
    step, stream 2 blanked (lost; the repair finds no face), stream 2
    back (the repair locks it again)."""
    frames = [load_image(ROT / n) for n in ("man_rotm15.png",
                                            "man_rotp15.png",
                                            "man_rotp30.png")]
    steps = []
    for t, img in enumerate(frames):
        batch = np.stack([np.roll(img, 4 * s, axis=1) for s in range(4)])
        if t == 1:
            batch[2] = 0
        steps.append(batch)
    return steps


@pytest.mark.parametrize("cls,kw,first", [
    (FaceTracker, {}, "sharded"),
    (MultiFaceTracker, {"max_faces": 2}, "unsharded")])
def test_track_sharded_matches_unsharded(cls, kw, first):
    mesh = data_parallel_mesh(["cpu"] * 2)
    sharded = cls(device="cpu", **kw)
    single = cls(device="cpu", **kw)
    lock = []
    steps = _steps()
    for t, batch in enumerate(steps):
        rs = (sharded.step(batch) if t == 0 and first == "unsharded"
              else track_sharded(sharded, batch, mesh))
        ru = single.step(batch)
        _close(rs, ru)
        assert (sharded.tracking == single.tracking).all(), t
        lock.append(list(single.tracking))
        if cls is MultiFaceTracker:
            assert (sharded.face_count == single.face_count).all(), t
    assert lock == [[True] * 4, [True, True, False, True], [True] * 4]
    assert len(sharded._shards[1]) == 2
    # the streams come back from the shards for an unsharded step
    _close(sharded.step(steps[2]), single.step(steps[2]))
    assert sharded._shards is None
    assert (sharded.tracking == single.tracking).all()


# case: (streams entering unlocked, streams blanked, forced, the lock
# flags after the step); repair_batch=2, streams 0-1 on the first shard
CASES = {
    "forced": ((), (1,), True, [True, False, True, True]),
    "mass_loss": ((0, 2, 3), (), False, [True] * 4),
    "locked": ((), (), False, [True] * 4),
    "repair_in_both_shards": ((1,), (3,), False, [True, True, True, False]),
    # lost: 0 and 3 (unlocked, their faces there) and 2 (blanked); the
    # repair takes 0 and 2, the first two of all four streams, so stream
    # 3 stays lost although its shard repairs two rows
    "first_r_of_all_streams": ((0, 3), (2,), False,
                               [True, True, False, False]),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cls,kw", [(FaceTracker, {}),
                                    (MultiFaceTracker, {"max_faces": 2})])
def test_track_sharded_matches_unsharded_in_every_branch(cls, kw, case):
    unlocked, blank, forced, want = CASES[case]
    steps = _steps()
    batch = steps[2]
    batch[list(blank)] = 0
    single = cls(device="cpu", repair_batch=2, redetect_every=3, **kw)
    sharded = cls(device="cpu", repair_batch=2, redetect_every=3, **kw)
    single.step(steps[0])
    state = single._state
    flags = state[-1].clone()
    flags[list(unlocked)] = False
    state = state._replace(**{state._fields[-1]: flags})
    for t in (single, sharded):
        t._state, t._state_hw = state, (360, 540)
        t._steps = 3 if forced else 1
    assert sharded.next_step_forced == forced
    rs = track_sharded(sharded, batch, data_parallel_mesh(["cpu"] * 2))
    _close(rs, single.step(batch))
    assert list(single.tracking) == want
    assert (sharded.tracking == single.tracking).all()
    if cls is MultiFaceTracker:
        assert (sharded.face_count == single.face_count).all()


class _BothBranches(_EagerProgram):
    """The eager stand-in with each cond run on both sides."""

    def replay(self):
        with programs.both_branches():
            super().replay()


@pytest.mark.parametrize("cls,kw", [(FaceTracker, {}),
                                    (MultiFaceTracker, {"max_faces": 2})])
def test_track_sharded_reads_nothing_back(monkeypatch, cls, kw):
    monkeypatch.setattr(programs, "Program", _BothBranches)
    tracker = cls(device="cpu", repair_batch=2, **kw)
    tracker.cascade._cache.on_card = True
    mesh = data_parallel_mesh(["cpu"] * 2)
    steps = [torch.from_numpy(x) for x in _steps()]
    track_sharded(tracker, steps[0], mesh)
    with _HostValues() as mode:
        for batch in steps[1:]:
            track_sharded(tracker, batch, mesh)
    assert mode.seen == [], mode.seen
    assert [k[0] for k in tracker.cascade._cache.entries] == [
        "shard_stage", "shard_finish"]
