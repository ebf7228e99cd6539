"""tpu_face_torch.aot with the trackers, on the CPU (the counterparts of
tests/test_aot.py's tracker cases).  ``FaceTracker`` and
``MultiFaceTracker(max_faces=2)`` saved at two 540x360 streams:

* the artifact holds one program, "step" (the tracker's ``_step_fn``),
  taking JAX's inputs in JAX's order and returning (result, next state);
  its exported graph has exactly two ``torch.cond`` nodes;
* attached, a full step, a tracked step, a repair step (one stream
  blanked: it loses lock and the one-stream repair finds no face) and a
  re-lock step (the stream back: the repair locks it again) match the
  live tracker (within 1e-6, flags and lock states equal).  A step at
  another batch names the saved batch, and ``track_sharded`` refuses the
  attached tracker;
* ``aot.load(p)(images, *state, force)`` from a set state in each branch
  (forced, mass loss, locked, repair) equals the live ``_step_fn``
  (within 1e-6, flags equal), result and state;
* the loaded ``FaceTracker`` step against ``tpu_face.aot.save``/``load``
  of the JAX tracker on the same numpy inputs, within the cascade
  contract (tests/test_torch_cascade.py: 0.25 px, 1e-3; the next ROIs
  within 0.25 px and 1e-3 rad), flags equal;
* a file in the old three-program layout (``tpu-face-torch-aot-v1``) is
  refused by ``load`` and ``attach``, naming its format.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rotation_e2e import ROT
from test_torch_aot import NAMES, SIZE, _close, _with_meta
from test_torch_cascade import _compare
from test_torch_threads import share_cores  # noqa: F401
from tpu_face import aot as jaot
from tpu_face.tracking import FaceTracker as JaxFaceTracker
from tpu_face_torch import aot
from tpu_face_torch.parallel import track_sharded
from tpu_face_torch.tracking import (FaceTracker, MultiFaceTracker,
                                     _force_flags)
from tpu_face_torch.utils.image_io import load_image

TRACKERS = {"face": (FaceTracker, {}),
            "multiface": (MultiFaceTracker, {"max_faces": 2})}
BRANCHES = ["forced", "mass_loss", "locked", "repair"]


def _make(kind):
    cls, kw = TRACKERS[kind]
    return cls(warp_method="pallas", device="cpu", **kw)


@pytest.fixture(scope="module")
def frames():
    return np.stack([load_image(ROT / n) for n in NAMES])


@pytest.fixture(scope="module")
def saved(tmp_path_factory, frames):
    """{kind: artifact path}, each tracker saved once per module."""
    b, h, w, _ = frames.shape
    out = {}
    for kind in TRACKERS:
        out[kind] = aot.save(_make(kind), tmp_path_factory.mktemp(kind)
                             / "tracker.aot", batch=b, height=h, width=w)
    return out


@pytest.fixture(scope="module")
def loaded(saved):
    return {kind: aot.load(p) for kind, p in saved.items()}


def _steps(frames):
    """A full step, a tracked step, a repair step (stream 1 blanked: it
    loses lock and the one-stream repair finds no face) and a second
    repair step (stream 1 back: the repair locks it again)."""
    blank = frames.copy()
    blank[1] = 0
    return [frames, frames[:, :, ::-1].copy(), blank, frames]


@pytest.mark.parametrize("kind", TRACKERS)
def test_attached_step_matches_live(saved, frames, kind):
    tracker = _make(kind)
    live = []
    for x in _steps(frames):
        live.append(tracker.step(x))
        live.append(tracker.tracking.copy())
    fresh = _make(kind)
    prog = aot.attach(fresh, saved[kind])
    assert prog.meta["cls"] == type(tracker).__name__
    for i, x in enumerate(_steps(frames)):
        _close(live[2 * i], fresh.step(x))
        assert (fresh.tracking == live[2 * i + 1]).all(), i
    assert list(live[5]) == [True, False]     # the blanked stream was lost
    assert fresh.tracking.all()
    with pytest.raises(ValueError, match="saved batch"):
        fresh.step(frames[:1])
    with pytest.raises(ValueError, match="attached artifact"):
        track_sharded(fresh, frames, ["cpu", "cpu"])


@pytest.mark.parametrize("kind", TRACKERS)
def test_artifact_holds_one_step_program(loaded, frames, kind):
    prog = loaded[kind]
    b = frames.shape[0]
    (entry,) = prog.meta["programs"]
    state = {"face": ("TrackerState", [[b, 5], [b]]),
             "multiface": ("MultiTrackerState", [[b, 2, 5], [b, 2], [b]])}
    name, shapes = state[kind]
    assert entry["name"] == "step" and entry["state"] == name
    assert [s for _, s in entry["inputs"]] == (
        [list(frames.shape)] + shapes + [[]])
    assert entry["inputs"][-1][0] == "torch.bool"
    graph = prog.programs["step"].module.graph
    assert sum(n.target is torch.ops.higher_order.cond
               for n in graph.nodes) == 2


def _entry(tracker, frames, branch):
    """(images, state, force) entering ``branch`` of a step: the state
    the first step leaves (every stream locked), forced; every stream
    unlocked (mass loss); locked; locked with stream 1 blanked (it loses
    presence: the repair)."""
    images = torch.from_numpy(frames)
    force = _force_flags(tracker.device)
    empty = tracker._empty_state(frames.shape[0])
    with torch.inference_mode():
        _, locked = tracker._step_fn(images, *empty, force[1], SIZE)
    if branch == "repair":
        images = images.clone()
        images[1] = 0
    state = empty if branch == "mass_loss" else locked
    return images, state, force[branch == "forced"]


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("kind", TRACKERS)
def test_loaded_step_matches_step_fn(loaded, frames, kind, branch):
    tracker = _make(kind)
    images, state, force = _entry(tracker, frames, branch)
    with torch.inference_mode():
        want = tracker._step_fn(images, *state, force, SIZE)
    got = loaded[kind](images, *state, force)
    assert type(got[1]) is type(state)
    for a, b in zip(want, got):
        _close(a, b)
    if branch == "repair":
        assert list(got[1][-1]) == [True, False]
    else:
        assert bool(got[1][-1].all())


def test_loaded_step_matches_jax(tmp_path, loaded, frames):
    """The repair branch (stream 1 blanked) and the re-lock (stream 1
    back, the repair finds it) through both loaded programs."""
    tracker = _make("face")
    b, h, w, _ = frames.shape
    ref = jaot.load(jaot.save(JaxFaceTracker(warp_method="gather"),
                              tmp_path / "jax_tracker.aot", batch=b,
                              height=h, width=w))
    images, state, force = _entry(tracker, frames, "repair")
    for x in (images, torch.from_numpy(frames)):
        res, nxt = loaded["face"](x, *state, force)
        want, want_state = ref(jnp.asarray(x.numpy()),
                               *(jnp.asarray(t.numpy()) for t in state),
                               jnp.asarray(bool(force)))
        jax.block_until_ready(want)
        _compare(res, want, SIZE)
        np.testing.assert_array_equal(nxt.valid.numpy(),
                                      np.asarray(want_state.valid))
        ok = nxt.valid.numpy()
        d = np.abs(nxt.roi.numpy() - np.asarray(want_state.roi))[ok]
        assert d[:, :4].max() <= 0.25 and d[:, 4].max() <= 1e-3, d
        state = nxt
    assert list(state.valid) == [True, True]


OLD = [{"name": n, "batch": bb, "inputs": [], "result": "CascadeResult"}
       for n, bb in (("full", 2), ("repair", 1), ("tracked", 2))]


@pytest.mark.parametrize("how", ["load", "attach"])
def test_old_format_refused(saved, tmp_path, how):
    old = _with_meta(saved["face"], tmp_path / "v1.aot",
                     format="tpu-face-torch-aot-v1", programs=OLD)
    with pytest.raises(ValueError, match="tpu-face-torch-aot-v1"):
        if how == "load":
            aot.load(old)
        else:
            aot.attach(_make("face"), old)
