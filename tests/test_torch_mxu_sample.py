"""The "mxu" warp method of tpu_face_torch on the CPU, against
tpu_face.ops.image.mxu_sample and the JAX models' "mxu" method.

* ``mxu_sample`` against JAX's on the same coordinates over seeded
  synthetic frames (uint8 levels as f32): rotated ROIs whose tiles stay
  inside the band (where both also equal the plain gather), ROIs that
  overflow the band (both clamp to the band's edge the same way), a
  portrait frame, bands taller than the frame, and a batch of frames
  with several grids each (each grid as the single-grid call gives it):
  max abs 1e-3 in 0-255 units.
* ``auto_band`` equal to JAX's over a grid of sizes.
* ``warp_image_to_tensor(method="mxu")`` dispatches to it.
* ``FaceDetection(BACK)``, ``FaceLandmark`` and ``IrisLandmark`` with
  ``warp_method="mxu"`` (band ``auto_band(max(H, W), in_h)``) on the
  rotated frames: the port's chain, and JAX's "mxu" models on the port's
  ROIs: points within 0.25 px, scores within 1e-3.
* On the 704x704 close-up the mesh ROI (350 px at 0.55 rad) overflows
  ``auto_band``'s 56 rows, and both packages' "mxu" mesh models clamp
  alike: presence below 0.5 (no mesh) in both, within 1e-3.
* ``FaceCascade(warp_method="mxu")`` (BACK) against JAX's "mxu" cascade
  on the four rotated 540p frames (f32 planes; ``_bands`` gives 96/72
  rows) and on canvas (a) (1920x1080, bf16 planes; 144/144 rows), by
  tests/test_torch_cascade.py's rules, with no warp kernel's wrapper
  called.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_rotation_e2e import FRAMES_540, GT, GT_PORTRAIT, ROT
from test_torch_cascade import _compare
from tpu_face import models as jm
from tpu_face import types as jtypes
from tpu_face.ops import image as jimage
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch import models as tm
from tpu_face_torch.ops import image as timage
from tpu_face_torch.ops import warp
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

TOL = 1e-3
PX_TOL = 0.25
SCORE_TOL = 1e-3
ROWS = {**GT, **GT_PORTRAIT}
FRAMES = ["man_rotp15.png", "man_rotm30.png", "russ2_rotp20.png"]


def _frame(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _coords(roi, out, keep, flip=False):
    """JAX's source coordinates of an ROI, as numpy (both samplers then
    read the same coordinates)."""
    x, y, _ = jimage._source_coords(jnp.asarray(np.float32(roi)), out, keep,
                                    flip)
    return np.array(x), np.array(y)


def _both(img, x, y, band):
    want = np.asarray(jimage.mxu_sample(jnp.asarray(img), jnp.asarray(x),
                                        jnp.asarray(y), band=band))
    got = timage.mxu_sample(torch.from_numpy(img), torch.from_numpy(x),
                            torch.from_numpy(y), band=band).numpy()
    return got, want


@pytest.mark.parametrize("roi,out,keep,flip,band", [
    ((270, 180, 120, 130, 0.3), (64, 64), True, False, 96),
    ((200, 150, 90, 90, -0.6), (64, 64), True, True, 96),
    ((300, 170, 150, 150, 0.2), (192, 192), False, False, 96),
    ((270, 180, 120, 120, 0.0), (192, 192), False, False, 48),
])
def test_mxu_sample_inside_the_band(roi, out, keep, flip, band):
    img = _frame(np.random.default_rng(0), 360, 540)
    x, y = _coords(roi, out, keep, flip)
    got, want = _both(img, x, y, band)
    assert np.abs(got - want).max() <= TOL
    gather = timage.bilinear_sample(torch.from_numpy(img),
                                    torch.from_numpy(x),
                                    torch.from_numpy(y)).numpy()
    assert np.abs(got - gather).max() <= TOL


@pytest.mark.parametrize("roi,band", [
    ((270, 180, 600, 600, 1.0), 48),
    ((270, 180, 150, 160, 0.4), 48),
    ((500, 20, 200, 200, 0.7), 32),
])
def test_mxu_sample_clamps_like_jax_beyond_the_band(roi, band):
    img = _frame(np.random.default_rng(1), 360, 540)
    x, y = _coords(roi, (192, 192), False)
    got, want = _both(img, x, y, band)
    assert np.abs(got - want).max() <= TOL
    gather = timage.bilinear_sample(torch.from_numpy(img),
                                    torch.from_numpy(x),
                                    torch.from_numpy(y)).numpy()
    # the band really was too short: the gather reads rows it dropped
    assert np.abs(got - gather).max() > 1.0


@pytest.mark.parametrize("hw,band", [((225, 200), 48), ((40, 64), 96)])
def test_mxu_sample_portrait_and_short_frames(hw, band):
    h, w = hw
    img = _frame(np.random.default_rng(h), h, w)
    x, y = _coords((w / 2, h / 2, w * 0.6, h * 0.5, -0.35), (64, 64), True)
    got, want = _both(img, x, y, band)
    assert np.abs(got - want).max() <= TOL


def test_mxu_sample_batched_grids():
    rng = np.random.default_rng(2)
    imgs = np.stack([_frame(rng, 360, 540) for _ in range(2)])
    rois = [[(270, 180, 150, 160, 0.4), (200, 100, 80, 80, -0.3)],
            [(300, 200, 150, 160, 0.1), (100, 100, 80, 80, 0.9)]]
    xy = [[_coords(r, (64, 64), True) for r in frame] for frame in rois]
    xs = torch.from_numpy(np.array([[c[0] for c in f] for f in xy]))
    ys = torch.from_numpy(np.array([[c[1] for c in f] for f in xy]))
    got = timage.mxu_sample(torch.from_numpy(imgs), xs, ys, band=72)
    assert tuple(got.shape) == (2, 2, 64, 64, 3)
    for i in range(2):
        for k in range(2):
            one, want = _both(imgs[i], *xy[i][k], 72)
            np.testing.assert_array_equal(got[i, k].numpy(), one)
            assert np.abs(one - want).max() <= TOL
    with pytest.raises(ValueError):
        timage.mxu_sample(torch.from_numpy(imgs), xs[:1], ys[:1])


def test_auto_band_matches_jax():
    for extent in (64, 200, 225, 540, 704, 1080, 1920, 3840):
        for out_h in (64, 128, 192, 256):
            for minimum in (48, 32):
                assert timage.auto_band(extent, out_h, minimum) == \
                    jimage.auto_band(extent, out_h, minimum)


def test_warp_image_to_tensor_dispatches_mxu(monkeypatch):
    seen = []
    real = timage.mxu_sample

    def spy(image, x, y, band=32, row_tile=8):
        seen.append(band)
        return real(image, x, y, band=band, row_tile=row_tile)

    monkeypatch.setattr(timage, "mxu_sample", spy)
    img = torch.from_numpy(_frame(np.random.default_rng(3), 360, 540))
    roi = torch.tensor([270.0, 180.0, 120.0, 130.0, 0.3])
    got, pad = timage.warp_image_to_tensor(img, roi, (64, 64), True,
                                           method="mxu", band=96)
    want, _ = timage.warp_image_to_tensor(img, roi, (64, 64), True)
    assert seen == [96] and torch.equal(got, want)
    assert timage.resolve_warp_method("mxu", "cpu") == "mxu"


def _chain(models, img, size, rois=None):
    det, mesh_model, iris_model = models
    pkg = tm if isinstance(det, tm.FaceDetection) else jm
    faces = det.infer(img)
    face_roi = rois[0] if rois else pkg.face_detection_to_roi(faces[0],
                                                              size)
    mesh = mesh_model.infer(img, face_roi)
    left, right = (rois[1:] if rois
                   else pkg.iris_roi_from_face_landmarks(mesh, size))
    return {"faces": faces, "rois": (face_roi, left, right), "mesh": mesh,
            "left": iris_model.infer(img, left),
            "right": iris_model.infer(img, right, is_right_eye=True)}


@pytest.fixture(scope="module")
def chains():
    port = (tm.FaceDetection(tm.FaceDetectionModel.BACK_CAMERA,
                             warp_method="mxu", device="cpu"),
            tm.FaceLandmark(warp_method="mxu", device="cpu"),
            tm.IrisLandmark(warp_method="mxu", device="cpu"))
    ref = (jm.FaceDetection(jm.FaceDetectionModel.BACK_CAMERA,
                            warp_method="mxu"),
           jm.FaceLandmark(warp_method="mxu"),
           jm.IrisLandmark(warp_method="mxu"))
    assert all(m._warp == "mxu" for m in port)
    out = {}
    for name in FRAMES:
        img = load_image(ROT / name)
        size = ROWS[name]["size"]
        mine = _chain(port, img, size)
        out[name] = (mine, _chain(ref, img, size, mine["rois"]))
    return out


def _worst_px(a, b, size):
    w, h = size
    return max(max(abs(p.x - q.x) * w, abs(p.y - q.y) * h, abs(p.z - q.z) * w)
               for p, q in zip(a, b))


@pytest.mark.parametrize("name", FRAMES)
def test_mxu_models_match_jax(chains, name):
    size = ROWS[name]["size"]
    w, h = size
    mine, theirs = chains[name]
    assert len(mine["faces"]) == len(theirs["faces"]) >= 1
    for a, b in zip(mine["faces"], theirs["faces"]):
        px = np.abs(a.data - b.data) * np.array([w, h], np.float32)
        assert px.max() <= PX_TOL and abs(a.score - b.score) <= SCORE_TOL
    assert len(mine["mesh"]) == len(theirs["mesh"]) == 468
    assert _worst_px(mine["mesh"], theirs["mesh"], size) <= PX_TOL
    for eye in ("left", "right"):
        a, b = mine[eye], theirs[eye]
        assert _worst_px(a.contour + a.iris, b.contour + b.iris,
                         size) <= PX_TOL


def test_mxu_band_overflow_on_the_closeup_matches_jax():
    name = "man_closeup_rotp30.png"
    img = load_image(ROT / name)
    face = tm.FaceDetection(tm.FaceDetectionModel.BACK_CAMERA,
                            device="cpu").infer(img)[0]
    roi = tm.face_detection_to_roi(face, ROWS[name]["size"])
    _, presence = tm.FaceLandmark(warp_method="mxu",
                                  device="cpu").infer_batch(img[None], [roi])
    jroi = jtypes.Rect(roi.x_center, roi.y_center, roi.width, roi.height,
                       roi.rotation, normalized=True)
    _, want = jm.FaceLandmark(warp_method="mxu").infer_batch(img[None],
                                                             [jroi])
    want = np.asarray(want)
    assert presence[0] < 0.5 and want[0] < 0.5
    assert abs(presence[0] - want[0]) <= SCORE_TOL


@pytest.mark.parametrize("frames", ["540p", "canvas_a"])
def test_mxu_cascade_matches_jax(frames, monkeypatch):
    def refuse(*args):
        raise AssertionError("the mxu cascade called a warp kernel wrapper")

    monkeypatch.setattr(warp, "warp_sample_multi", refuse)
    images = (np.stack([load_image(ROT / n) for n in FRAMES_540])
              if frames == "540p"
              else chip_smoke.canvas_1080p(load_image)[None])
    size = (images.shape[2], images.shape[1])
    cascade = FaceCascade(warp_method="mxu", device="cpu")
    assert cascade.warp_method == "mxu"
    assert cascade._bands(size) == ((96, 72) if frames == "540p"
                                    else (144, 144))
    res = cascade.infer_batch(images)
    ref = JaxFaceCascade(warp_method="mxu").infer_batch(images)
    assert bool(res.mesh_valid.all()) and bool(res.envelope_ok.all())
    _compare(res, ref, size)
