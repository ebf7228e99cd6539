"""tpu_face_torch.programs (the per-geometry CUDA-graph program cache) on
the CPU.

A CUDA graph cannot be captured here, so the tests that need the cache
to make entries swap its capture step for an eager stand-in
(``_EagerProgram``: the "graph" is the function run on the program's
static inputs, its outputs copied into the static outputs); the copies
in and the fresh outputs out are the cache's own code.

* Every program the cache captures, reached through the public calls
  (``FaceCascade`` BACK f32 and bf16, ``max_faces=4``, FULL,
  FULL_SPARSE, each ``warp_method``, the planar layout;
  ``EmbedCascade``; ``FaceTracker`` and ``MultiFaceTracker``'s step
  program, with both sides of its conds run; the four models' ``_run``
  and ``embed_boxes``), runs free of host values: no tensor made from
  host data (``torch.tensor``, ``torch.from_numpy``), no value read back
  (tests/test_torch_bench.py's ``_HostValues``).
* The bookkeeping: one entry per key (program name, input shapes and
  types), reused at the same key; a held result unchanged by the next
  call; attached programs (``aot.attach``) taking precedence; a
  ``device="cpu"`` object making no entry; a replica
  (``tpu_face_torch.parallel``) capturing into its own cache on its own
  device.
* The slice as a whole against ``tpu_face``: seeded frames through the
  cached ``FaceCascade`` call and ``tpu_face.FaceCascade``, and a
  ``FaceTracker`` over steps with a repair through the cached step
  program and ``tpu_face.tracking.FaceTracker``, within the cascade contract
  (tests/test_torch_cascade.py's ``_compare``: equal bools, 0.25 px,
  1e-3 rad, 1e-3 on scores).
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from test_rotation_e2e import ROT
from test_torch_bench import _HostValues
from test_torch_cascade import _compare
from test_torch_threads import share_cores  # noqa: F401
from test_torch_tracking import SEQ, _batch, _step_both
from tpu_face import tracking as jtrack
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch import exact_f32, programs
from tpu_face_torch import tracking as ttrack
from tpu_face_torch.models import (FaceDetection, FaceDetectionModel,
                                   FaceEmbeddings, FaceLandmark,
                                   IrisLandmark)
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.parallel import infer_sharded
from tpu_face_torch.pipeline import EmbedCascade, FaceCascade
from tpu_face_torch.types import Rect
from tpu_face_torch.utils import profiling
from tpu_face_torch.utils.image_io import load_image

DEMO = str(_DATA_DIR / "demo")
FRAME = "man_rotp15.png"
SIZE = (540, 360)


class _EagerProgram(programs.Program):
    """``Program`` with its capture step swapped for an eager stand-in."""

    def _capture(self, fn):
        self.fn = fn
        return fn(*self.inputs), 0

    def replay(self):
        out = pytree.tree_leaves(self.fn(*self.inputs))
        for buf, t in zip(self.outputs, out):
            buf.copy_(t)

    def _serialized(self):
        return contextlib.nullcontext()


@pytest.fixture
def cached(monkeypatch):
    """``on(obj)``: ``obj``'s program cache, made to capture (with the
    eager stand-in) although ``obj`` lies on the CPU."""
    monkeypatch.setattr(programs, "Program", _EagerProgram)

    def on(obj):
        cache = obj.cascade._cache if hasattr(obj, "cascade") else obj._cache
        cache.on_card = True
        return cache

    return on


def _host_values(program):
    """What ``_HostValues`` records over one call of a captured
    program's function on its static inputs, with both sides of each
    ``programs.cond`` run (as the warm-ups run them, and as a capture
    records them: neither side may read a value back)."""
    with (torch.inference_mode(), exact_f32(), programs.both_branches(),
          _HostValues() as mode):
        program.fn(*program.inputs)
    return mode.seen


@pytest.fixture(scope="module")
def img():
    return load_image(ROT / FRAME)


def _frames(img, n, seed=0):
    """``n`` copies of ``img``, each shifted by a seeded few px."""
    rng = np.random.default_rng(seed)
    return np.stack([np.roll(img, tuple(rng.integers(-6, 7, 2)), (0, 1))
                     for _ in range(n)])


def _cascade_call(kw, planar=False):
    def drive(img):
        obj = FaceCascade(device="cpu", **kw,
                          input_layout="planar" if planar else "hwc")
        x = torch.from_numpy(_frames(img, 2))
        return obj, lambda: obj(x.permute(0, 3, 1, 2).contiguous()
                                if planar else x)
    return drive


def _embed_cascade(img):
    obj = EmbedCascade(embed_model_path=DEMO, device="cpu")
    x = torch.from_numpy(_frames(img, 2))
    return obj, lambda: obj(x)


def _tracker(cls, **kw):
    def drive(img):
        obj = cls(device="cpu", repair_batch=1, **kw)
        frames = _frames(img, 4)
        blank = frames.copy()
        blank[2] = 0

        def steps():
            for x in (frames, frames, blank):    # full, tracked, repair
                obj.step(x)
        return obj, steps
    return drive


def _models(img):
    """The four models, driven through their batched host calls."""
    det = FaceDetection(FaceDetectionModel.BACK_CAMERA, device="cpu")
    mesh = FaceLandmark(device="cpu")
    iris = IrisLandmark(device="cpu")
    emb = FaceEmbeddings(DEMO, device="cpu")
    x = _frames(img, 2)
    roi = Rect(0.47, 0.41, 0.4, 0.6, 0.2, normalized=True)
    eye = Rect(0.42, 0.33, 0.08, 0.08, 0.1, normalized=True)

    def calls():
        det.infer_batch(x)
        mesh.infer_batch(x, [roi, roi])
        iris.infer_batch(x, [eye, eye], [False, True])
        emb.infer_batch(x, [(180, 80, 320, 215)] * 2)
        emb.embed_boxes(x, torch.tensor([[[0.33, 0.22], [0.59, 0.6]]] * 2))
    return [det, mesh, iris, emb], calls


PROGRAMS = {
    "back_f32": _cascade_call({}),
    "back_bf16": _cascade_call({"compute_dtype": torch.bfloat16}),
    "max_faces_4": _cascade_call({"max_faces": 4}),
    "full": _cascade_call({"detection_model": FaceDetectionModel.FULL}),
    "full_sparse": _cascade_call(
        {"detection_model": FaceDetectionModel.FULL_SPARSE, "max_faces": 4}),
    "gather": _cascade_call({"warp_method": "gather"}),
    "pallas": _cascade_call({"warp_method": "pallas"}),
    "mxu": _cascade_call({"warp_method": "mxu"}),
    "planar": _cascade_call({"warp_method": "pallas"}, planar=True),
    "embed_cascade": _embed_cascade,
    "face_tracker": _tracker(ttrack.FaceTracker),
    "multiface_tracker": _tracker(ttrack.MultiFaceTracker, max_faces=2),
    "models": _models,
}


@pytest.mark.parametrize("name", PROGRAMS)
def test_captured_programs_are_free_of_host_values(img, cached, name):
    objs, drive = PROGRAMS[name](img)
    objs = objs if isinstance(objs, list) else [objs]
    caches = [cached(o) for o in objs]
    drive()
    entries = {k: p for c in caches for k, p in c.entries.items()}
    # every program the call path reaches was captured: the cascade's
    # call, the trackers' step (its full, tracked and repair branches in
    # one program), each model's pass
    want = {"models": 5}
    assert len(entries) == want.get(name, 1), list(entries)
    for key, program in entries.items():
        assert _host_values(program) == [], key


def test_host_values_sees_host_data():
    """The check itself: host data made into a tensor (a host list, a
    numpy array) and a value read back; Python scalars are no host
    values (a graph takes them as kernel arguments)."""
    prog = _EagerProgram.__new__(_EagerProgram)
    prog.inputs = [torch.ones(3)]
    for fn in (lambda x: x + torch.from_numpy(np.ones(3, np.float32)),
               lambda x: x + torch.tensor([1.0, 2, 3])):
        prog.fn = fn
        assert _host_values(prog) == ["aten.lift_fresh.default"]
    prog.fn = lambda x: x * float(x.sum())
    assert _host_values(prog) == ["aten.item.default"]
    prog.fn = lambda x: x if bool(x.any()) else -x
    assert _host_values(prog) == ["aten.is_nonzero.default"]
    prog.fn = lambda x: torch.where(x > 0, x * 2.0, -1.0) + x.new_zeros(3)
    assert _host_values(prog) == []


def test_one_entry_per_key(img, cached):
    cascade = FaceCascade(device="cpu")
    cache = cached(cascade)
    one = torch.from_numpy(_frames(img, 1))
    cascade(one)
    (program,) = cache.entries.values()
    cascade(one)
    assert list(cache.entries.values()) == [program]
    cascade(torch.from_numpy(_frames(img, 2)))
    cascade(one[:, :180, :270].contiguous())
    cascade(one.float())
    assert {k[1] for k in cache.entries} == {
        ((1, 180, 270, 3), torch.uint8), ((1, 360, 540, 3), torch.float32),
        ((1, 360, 540, 3), torch.uint8), ((2, 360, 540, 3), torch.uint8)}
    assert all(k[0] == "forward" for k in cache.entries)


def test_captures_are_counted(img, cached):
    cascade = FaceCascade(device="cpu")
    cached(cascade)
    one = torch.from_numpy(_frames(img, 1))
    profiling.reset()
    cascade(one)
    cascade(one)
    cascade(torch.from_numpy(_frames(img, 2)))
    assert profiling.collect()["counters"] == {"programs.captures": 2}


def test_tracing_keys_a_stamped_program_beside_the_untraced(img, cached):
    """Turning tracing on makes exactly one new entry (the untraced key
    with ``STAMPED`` last), whose calls record the program's host spans;
    turning it off again reuses the untraced entry."""
    cascade = FaceCascade(device="cpu")
    cache = cached(cascade)
    one = torch.from_numpy(_frames(img, 1))
    off = cascade(one)
    (key,) = cache.entries
    plain = cache.entries[key]
    profiling.reset()
    profiling.enable()
    try:
        on = cascade(one)
        cascade(one)
    finally:
        profiling.enable(False)
    assert list(cache.entries) == [key, key + (programs.STAMPED,)]
    for f in off._fields:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    got = profiling.collect()
    assert got["counters"] == {"programs.captures": 1}
    names = [s["name"] for s in got["spans"] if s["parent"] is not None
             and got["spans"][s["parent"]]["name"] == "programs.call"]
    assert names == ["programs.copy_in", "programs.launch",
                     "programs.clone_out"] * 2
    calls = [s for s in got["spans"] if s["name"] == "programs.call"]
    assert len(calls) == 2 and all(
        got["spans"][s["parent"]]["name"] == "cascade.call" for s in calls)
    cascade(one)
    assert list(cache.entries) == [key, key + (programs.STAMPED,)]
    assert cache.entries[key] is plain
    assert profiling.collect()["counters"] == {}


def test_cached_call_returns_fresh_results(img, cached):
    """A result the caller holds does not change on the next call, and
    each cached call gives the eager ``_forward``'s result."""
    cascade = FaceCascade(device="cpu")
    cached(cascade)
    a = torch.from_numpy(_frames(img, 2, seed=1))
    b = torch.from_numpy(_frames(img, 2, seed=2))
    first = cascade(a)
    held = [f.clone() for f in first]
    second = cascade(b)
    for f, h in zip(first, held):
        assert torch.equal(f, h)
    assert not torch.equal(first.mesh, second.mesh)
    with torch.inference_mode(), exact_f32():
        for got, x in ((first, a), (second, b)):
            want = cascade._forward(x, SIZE)
            for f, g in zip(want, got):
                assert torch.equal(f, g)


def test_attached_programs_take_precedence(img, cached):
    cascade = FaceCascade(device="cpu")
    cache = cached(cascade)
    x = torch.from_numpy(_frames(img, 1))
    cascade._programs[(360, 540)] = lambda images: ("attached", images)
    assert cascade(x) == ("attached", x)
    assert cache.entries == {}

    tracker = ttrack.FaceTracker(device="cpu")
    cache = cached(tracker)
    calls = []

    def step(images, *state_force):
        calls.append(images)
        return tracker._step_fn(images, *state_force, SIZE)

    step.batch = 1
    tracker._programs[(360, 540)] = step
    tracker.step(x)
    assert len(calls) == 1 and cache.entries == {}


def test_cpu_objects_make_no_entry(img, monkeypatch):
    def refuse(*args):
        raise AssertionError("a program captured on the CPU")

    monkeypatch.setattr(programs, "Program", refuse)
    x = _frames(img, 4)
    cascade = FaceCascade(device="cpu")
    cascade(torch.from_numpy(x))
    tracker = ttrack.FaceTracker(device="cpu")
    tracker.step(x)
    tracker.step(x)
    det = FaceDetection(FaceDetectionModel.BACK_CAMERA, device="cpu")
    det.infer_batch(x)
    for cache in (cascade._cache, tracker.cascade._cache, det._cache):
        assert not cache.on_card and cache.entries == {}


def test_replicas_capture_on_their_own_device(img, cached):
    """``infer_sharded`` over two devices: each shard's program in the
    cache of the replica on its device ("cpu:1" holds CPU tensors, so
    the replica is a second cascade here, as on a second card)."""
    cascade = FaceCascade(device="cpu")
    second = torch.device("cpu", 1)
    rep = cascade.replica(second)
    assert rep is not cascade and rep._cache is not cascade._cache
    caches = (cached(cascade), cached(rep))
    frames = _frames(img, 2)
    out = infer_sharded(cascade, frames, ["cpu", second])
    for cache, dev in zip(caches, (torch.device("cpu"), second)):
        (program,) = cache.entries.values()
        assert program.device == dev
        assert program.inputs[0].shape == (1, 360, 540, 3)
    with torch.inference_mode(), exact_f32():
        want = [cascade._forward(torch.from_numpy(frames[i:i + 1]), SIZE)
                for i in range(2)]
    for f, g in zip(zip(*want), out):
        assert torch.equal(torch.cat(f), g)


def test_cached_cascade_matches_jax(img, cached):
    cascade = FaceCascade(device="cpu")
    cache = cached(cascade)
    jax_cascade = JaxFaceCascade(warp_method="gather")
    for seed in (3, 4):                       # a capture, then a replay
        frames = _frames(img, 2, seed=seed)
        _compare(cascade.infer_batch(frames),
                 jax_cascade.infer_batch(frames), SIZE)
    assert len(cache.entries) == 1


def test_cached_tracker_matches_jax(cached):
    """The tracker's cached programs over the five-step sequence with
    stream 2 blanked at step 2 (lost, an empty repair) and re-locked by
    the repair at step 3, each step against the JAX tracker entered with
    the port's state."""
    frames = {n: load_image(ROT / n) for n in set(SEQ)}
    mine = ttrack.FaceTracker(device="cpu")
    cache = cached(mine)
    ref = jtrack.FaceTracker(warp_method="gather")
    for step in range(len(SEQ)):
        blank = (2,) if step == 2 else ()
        res, _ = _step_both(mine, ref, _batch(frames, step, blank))
        assert bool(res.mesh_valid[2]) == (step != 2)
    assert mine.tracking.all()
    assert [(k[0], k[1][0][0]) for k in cache.entries] == [("step", 4)]
