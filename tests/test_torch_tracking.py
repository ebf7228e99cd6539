"""tpu_face_torch.tracking on the CPU, step by step against
tpu_face.tracking.

* ``roi_from_mesh``, ``_roi_iou_matrix`` and ``match_slots`` against JAX
  on seeded inputs (ROIs within 1e-3 px / 1e-5 rad, IoUs within 1e-6,
  permutations equal), including tied IoUs, no valid previous slot and
  scene entries.
* ``FaceTracker`` (BACK, f32) on a five-step rotated sequence
  (man_rotm30 -> man_rotm15 -> man_rotp15 -> man_rotp30 -> man_rotp15),
  four streams each shifted a few px, stream 2 blanked at step 2 (it
  loses lock, the repair sub-batch finds no face, and at step 3 the
  repair locks it again), against ``tpu_face``'s
  ``FaceTracker(warp_method="gather")`` at every step, both trackers
  entering the step with the port's state (the ROIs come from the
  previous step's mesh, so a free run would compound the two libraries'
  sub-pixel differences step after step): every field within
  tests/test_torch_cascade.py's rules (equal bools, 0.25 px, 1e-3 rad,
  1e-3), and ``tracking`` and ``next_step_forced`` equal; the same with
  ``redetect_every=3``.
* The phantom-face rule: a stream that enters a step unlocked and that
  the bounded repair does not reach has ``face_valid`` (and so
  ``mesh_valid``) False, though its frame holds a face.
* ``MultiFaceTracker`` is in tests/test_torch_multiface_tracking.py.
* ``smoothing="one_euro"`` through the tracker against JAX's smoothed
  tracker, and ``dt`` reaching the smoother.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rotation_e2e import ROT
from test_torch_cascade import _compare
from tpu_face import tracking as jtrack
from tpu_face_torch import tracking as ttrack
from tpu_face_torch.utils.image_io import load_image

SEQ = ["man_rotm30.png", "man_rotm15.png", "man_rotp15.png",
       "man_rotp30.png", "man_rotp15.png"]
SIZE = (540, 360)
STREAMS = 4


def _rng_rois(rng, n, w=540.0, h=360.0):
    return np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n),
                     rng.uniform(20, 200, n), rng.uniform(20, 200, n),
                     rng.uniform(-1, 1, n)], -1).astype(np.float32)


def test_roi_from_mesh_matches_jax():
    rng = np.random.default_rng(0)
    mesh = rng.uniform(0.2, 0.8, (6, 468, 3)).astype(np.float32)
    got = ttrack.roi_from_mesh(torch.from_numpy(mesh), SIZE).numpy()
    for i in range(mesh.shape[0]):
        want = np.asarray(jtrack.roi_from_mesh(jnp.asarray(mesh[i]), SIZE))
        assert np.abs(got[i, :4] - want[:4]).max() <= 1e-3
        assert abs(got[i, 4] - want[4]) <= 1e-5


def test_roi_iou_matrix_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _rng_rois(rng, 5), _rng_rois(rng, 5)
    b[2] = a[1]                                       # an exact overlap
    got = ttrack._roi_iou_matrix(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
    want = np.asarray(jtrack._roi_iou_matrix(jnp.asarray(a),
                                             jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["random", "ties", "no_prev", "entries"])
def test_match_slots_matches_jax(case):
    rng = np.random.default_rng(len(case))
    k = 4
    new, prev = _rng_rois(rng, (3, k)), _rng_rois(rng, (3, k))
    nval = rng.uniform(size=(3, k)) > 0.3
    pval = rng.uniform(size=(3, k)) > 0.3
    if case == "ties":
        prev[:, 1] = prev[:, 0]                       # tied IoU rows
        new[:, :2] = prev[:, :2]
    elif case == "no_prev":
        pval[:] = False
    elif case == "entries":
        new[:, :2] = prev[:, 2:] + np.float32(3.0)    # survivors move
        nval[:] = pval[:] = True
    got = ttrack.match_slots(torch.from_numpy(new), torch.from_numpy(nval),
                             torch.from_numpy(prev),
                             torch.from_numpy(pval)).numpy()
    for i in range(3):
        want = np.asarray(jtrack.match_slots(
            jnp.asarray(new[i]), jnp.asarray(nval[i]), jnp.asarray(prev[i]),
            jnp.asarray(pval[i])))
        np.testing.assert_array_equal(got[i], want, err_msg=case)


@pytest.fixture(scope="module")
def frames():
    return {n: load_image(ROT / n) for n in set(SEQ)}


@pytest.fixture(scope="module")
def jax_tracker():
    """One JAX ``FaceTracker(warp_method="gather")`` for every test of
    the file (its step compiles once per frame size): ``make(**opts)``
    resets it and sets its schedule and smoothing.  Its repair sub-batch
    is the default, one stream for four."""
    ref = jtrack.FaceTracker(warp_method="gather")

    def make(redetect_every=None, smoothing=None):
        ref.reset()
        ref.redetect_every = redetect_every
        ref._init_smoothing(smoothing)
        return ref

    return make


def _batch(frames, step, blank=()):
    """The step's frames of the four streams: stream s shifted 4*s px
    right, the streams in ``blank`` black."""
    out = []
    for s in range(STREAMS):
        f = np.roll(frames[SEQ[step]], 4 * s, axis=1)
        out.append(np.zeros_like(f) if s in blank else f)
    return np.stack(out)


def _step_both(mine, ref, batch, size=SIZE, dt=None):
    """One step of both trackers from the port's state; returns both
    results."""
    assert mine.next_step_forced == ref.next_step_forced
    if mine._state is not None:
        ref._state = type(ref._state)(*(jnp.asarray(t.numpy())
                                        for t in mine._state))
    res = mine.step(batch, dt=dt)
    want = ref.step(batch, dt=dt)
    _compare(res, want, size)
    np.testing.assert_array_equal(mine.tracking, ref.tracking)
    return res, want


@pytest.mark.parametrize("redetect", [None, 3])
def test_face_tracker_matches_jax(frames, jax_tracker, redetect):
    mine = ttrack.FaceTracker(redetect_every=redetect, device="cpu")
    ref = jax_tracker(redetect_every=redetect)
    seen = []
    for step in range(len(SEQ)):
        blank = (2,) if step == 2 else ()
        res, _ = _step_both(mine, ref, _batch(frames, step, blank))
        seen.append(mine.tracking.copy())
        if step == 2:
            assert not bool(res.mesh_valid[2])
        else:
            assert bool(res.mesh_valid.all()), step
    # stream 2 loses lock at the blank step, the repair locks it again
    assert not seen[2][2] and seen[3].all() and seen[4].all()


def test_unrepaired_lost_stream_surfaces_no_face(frames, jax_tracker):
    """Stream 1 enters step 1 unlocked with a face in its frame; stream
    0 is blanked, so both are lost and the one-stream repair takes
    stream 0 (lost streams go in index order).  Stream 1 stays without a
    face rather than showing the dummy ROI's mesh."""
    mine = ttrack.FaceTracker(repair_batch=1, device="cpu")
    ref = jax_tracker()         # its default repair: one of four streams
    _step_both(mine, ref, _batch(frames, 0))
    _step_both(mine, ref, _batch(frames, 1, blank=(1,)))
    assert list(mine.tracking) == [True, False, True, True]
    res, _ = _step_both(mine, ref, _batch(frames, 2, blank=(0,)))
    assert not bool(res.face_valid[1]) and not bool(res.mesh_valid[1])
    assert float(res.score[1]) == 0.0
    assert bool(res.mesh_valid[2:].all())


def test_one_euro_smoothing_through_the_tracker(frames, jax_tracker):
    mine = ttrack.FaceTracker(smoothing="one_euro", device="cpu")
    ref = jax_tracker(smoothing="one_euro")
    raw = ttrack.FaceTracker(device="cpu")
    for step, dt in enumerate((None, 1 / 30, 1 / 15)):
        batch = _batch(frames, step)
        res, _ = _step_both(mine, ref, batch, dt=dt)
        unsmoothed = raw.step(batch)
        # smoothing moves only the output landmarks, never the state
        assert torch.equal(res.mesh_raw, unsmoothed.mesh_raw)
        if step == 0:
            assert torch.equal(res.mesh, unsmoothed.mesh)
        else:
            assert not torch.equal(res.mesh, unsmoothed.mesh)
    with pytest.raises(TypeError):
        ttrack.FaceTracker(smoothing="kalman", device="cpu")


def test_trackers_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cls in (ttrack.FaceTracker, ttrack.MultiFaceTracker):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
