"""The standalone models of tpu_face_torch.models on the CPU, against the
rotated-frame ground truth and against tpu_face.models.

* ``FaceDetection(BACK)`` on the seven ``assets/rotated/`` frames against
  the GT rows of tests/test_rotation_e2e.py (score within 0.01, bbox IoU
  >= 0.99, keypoints <= 1 px where the row has them) and against
  ``tpu_face`` (``warp_method="gather"``): points within 0.25 px, scores
  within 1e-3.
* The verify skill's chain (detection -> face ROI -> mesh -> eye ROIs ->
  left and mirrored right iris) against the GT nose and iris centres
  (<= 1 px), and the port's mesh and iris models against ``tpu_face`` on
  the same ROIs (0.25 px / 1e-3).
* The ROI and refinement helpers against ``tpu_face`` on the same inputs,
  ``infer_batch`` against ``infer``, FRONT and SHORT against ``tpu_face``.
  The image and post-processing ops the models add are in
  tests/test_torch_standalone_ops.py.
"""

import numpy as np
import pytest
import torch

from test_rotation_e2e import GT, GT_PORTRAIT, ROT, _iou
from test_torch_threads import share_cores  # noqa: F401
from tpu_face import models as jm
from tpu_face import types as jtypes
from tpu_face_torch import models as tm
from tpu_face_torch.utils.image_io import load_image

ROWS = {**GT, **GT_PORTRAIT}
FRAMES = list(ROWS)
PX_TOL = 0.25
SCORE_TOL = 1e-3


@pytest.fixture(scope="module")
def port():
    return (tm.FaceDetection(tm.FaceDetectionModel.BACK_CAMERA,
                             device="cpu"),
            tm.FaceLandmark(device="cpu"), tm.IrisLandmark(device="cpu"))


@pytest.fixture(scope="module")
def ref():
    return (jm.FaceDetection(jm.FaceDetectionModel.BACK_CAMERA,
                             warp_method="gather"),
            jm.FaceLandmark(warp_method="gather"),
            jm.IrisLandmark(warp_method="gather"))


def _chain(models, img, size, rois=None):
    """detection -> face ROI -> mesh -> eye ROIs -> both irises, with
    the package's own helpers, or on the given ``rois`` (face, left,
    right)."""
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
def chains(port, ref):
    """Per frame: the port's chain, and the JAX models' chain on the
    port's ROIs."""
    out = {}
    for name in FRAMES:
        img = load_image(ROT / name)
        size = ROWS[name]["size"]
        mine = _chain(port, img, size)
        out[name] = (mine, _chain(ref, img, size, mine["rois"]))
    return out


def _worst_px(a, b, size):
    w, h = size
    return max(max(abs(p.x - q.x) * w, abs(p.y - q.y) * h)
               for p, q in zip(a, b))


@pytest.mark.parametrize("name", FRAMES)
def test_detection_matches_ground_truth(chains, name):
    gt = ROWS[name]
    w, h = gt["size"]
    faces = chains[name][0]["faces"]
    assert len(faces) == 1
    assert abs(faces[0].score - gt["score"]) < 0.01
    box = faces[0].bbox().scale((w, h)).as_tuple()
    assert _iou(box, gt["bbox"]) >= 0.99, (box, gt["bbox"])
    absolute = faces[0].scaled_by_image_size((w, h))
    for k, (gx, gy) in enumerate(gt.get("keypoints", [])):
        x, y = absolute.keypoint(k)
        assert abs(x - gx) <= 1.0 and abs(y - gy) <= 1.0, (k, (x, y))


@pytest.mark.parametrize("name", FRAMES)
def test_detection_matches_jax(ref, chains, name):
    w, h = ROWS[name]["size"]
    faces = chains[name][0]["faces"]
    want = ref[0].infer(load_image(ROT / name))
    assert len(faces) == len(want)
    for a, b in zip(faces, want):
        px = np.abs(a.data - b.data) * np.array([w, h], np.float32)
        assert px.max() <= PX_TOL, px.max()
        assert abs(a.score - b.score) <= SCORE_TOL


@pytest.mark.parametrize("name", FRAMES)
def test_chain_matches_ground_truth(chains, name):
    gt = ROWS[name]
    w, h = gt["size"]
    mine = chains[name][0]
    pts = [((mine["mesh"][1].x, mine["mesh"][1].y), gt["nose"]),
           ((mine["left"].iris[0].x, mine["left"].iris[0].y),
            gt["iris"]["L"]),
           ((mine["right"].iris[0].x, mine["right"].iris[0].y),
            gt["iris"]["R"])]
    for (x, y), (gx, gy) in pts:
        assert abs(x * w - gx) <= 1.0 and abs(y * h - gy) <= 1.0, (
            (x * w, y * h), (gx, gy))
    for e, roi in enumerate(mine["rois"][1:]):
        assert abs(roi.rotation - gt["eye_rots"][e]) <= 0.02


@pytest.mark.parametrize("name", FRAMES)
def test_mesh_and_iris_match_jax(chains, name):
    """FaceLandmark and IrisLandmark (left, and right mirrored) on the
    same ROIs as the JAX models."""
    size = ROWS[name]["size"]
    mine, theirs = chains[name]
    assert len(mine["mesh"]) == len(theirs["mesh"]) == 468
    assert _worst_px(mine["mesh"], theirs["mesh"], size) <= PX_TOL
    for eye in ("left", "right"):
        a, b = mine[eye], theirs[eye]
        assert len(a.contour) == 71 and len(a.iris) == 5
        assert _worst_px(a.contour + a.iris, b.contour + b.iris,
                         size) <= PX_TOL


def _as_jax_detection(d):
    return jtypes.Detection(d.data, d.score)


def _as_jax_landmarks(pts):
    return [jtypes.Landmark(p.x, p.y, p.z) for p in pts]


@pytest.mark.parametrize("name", FRAMES)
def test_helpers_match_jax(chains, name):
    """The ROI, refinement and iris-metric helpers on the same inputs."""
    size = ROWS[name]["size"]
    mine = chains[name][0]
    a = tm.face_detection_to_roi(mine["faces"][0], size)
    b = jm.face_detection_to_roi(_as_jax_detection(mine["faces"][0]), size)
    assert (a.x_center, a.y_center, a.width, a.height, a.rotation) == \
        (b.x_center, b.y_center, b.width, b.height, b.rotation)
    for p, q in zip(tm.iris_roi_from_face_landmarks(mine["mesh"], size),
                    jm.iris_roi_from_face_landmarks(
                        _as_jax_landmarks(mine["mesh"]), size)):
        assert (p.x_center, p.y_center, p.width, p.height, p.rotation) == \
            (q.x_center, q.y_center, q.width, q.height, q.rotation)
    left, right = mine["left"], mine["right"]
    refined = tm.update_face_landmarks_with_iris_results(mine["mesh"], left,
                                                         right)
    jref = jm.update_face_landmarks_with_iris_results(
        _as_jax_landmarks(mine["mesh"]),
        jm.IrisResults(_as_jax_landmarks(left.contour),
                       _as_jax_landmarks(left.iris)),
        jm.IrisResults(_as_jax_landmarks(right.contour),
                       _as_jax_landmarks(right.iris)))
    assert [(p.x, p.y, p.z) for p in refined] == \
        [(p.x, p.y, p.z) for p in jref]
    for eye in (left, right):
        d = tm.get_iris_diameter(eye.iris, size)
        assert d == jm.get_iris_diameter(_as_jax_landmarks(eye.iris), size)
        assert tm.get_iris_depth(eye.iris, 42.0, d, size) == \
            jm.get_iris_depth(_as_jax_landmarks(eye.iris), 42.0, d, size)
    assert left.eyeball_contour() == left.contour[:15]
    with pytest.raises(ValueError):
        tm.update_face_landmarks_with_iris_results(mine["mesh"][:10], left,
                                                   right)


def test_infer_batch_matches_infer(port):
    det, mesh_model, iris_model = port
    names = [n for n in FRAMES if ROWS[n]["size"] == (540, 360)][:2]
    batch = np.stack([load_image(ROT / n) for n in names])
    size = (540, 360)
    per_frame = det.infer_batch(batch)
    rois, eyes = [], []
    for img, faces in zip(batch, per_frame):
        one = det.infer(img)
        assert len(faces) == len(one) == 1
        np.testing.assert_allclose(faces[0].data, one[0].data, atol=1e-5)
        rois.append(tm.face_detection_to_roi(faces[0], size))
    lmk, presence = mesh_model.infer_batch(batch, rois)
    assert lmk.shape == (len(names), 468, 3) and (presence > 0.5).all()
    for i, img in enumerate(batch):
        one = mesh_model.infer(img, rois[i])
        np.testing.assert_allclose(lmk[i], [(p.x, p.y, p.z) for p in one],
                                   atol=1e-5)
        eyes.append(tm.iris_roi_from_face_landmarks(one, size))
    # the first frame's left eye, the second frame's mirrored right eye
    flips = [False, True]
    contour, iris = iris_model.infer_batch(
        batch, [e[int(f)] for e, f in zip(eyes, flips)], flips)
    for i, img in enumerate(batch):
        one = iris_model.infer(img, eyes[i][int(flips[i])], flips[i])
        np.testing.assert_allclose(
            contour[i], [(p.x, p.y, p.z) for p in one.contour], atol=1e-5)
        np.testing.assert_allclose(
            iris[i], [(p.x, p.y, p.z) for p in one.iris], atol=1e-5)


@pytest.mark.parametrize("model", ["FRONT_CAMERA", "SHORT"])
def test_front_and_short_match_jax(model):
    name = "man_rotp15.png"
    w, h = ROWS[name]["size"]
    img = load_image(ROT / name)
    mine = tm.FaceDetection(tm.FaceDetectionModel[model],
                            device="cpu").infer(img)
    want = jm.FaceDetection(jm.FaceDetectionModel[model],
                            warp_method="gather").infer(img)
    assert len(mine) == len(want) >= 1
    for a, b in zip(mine, want):
        px = np.abs(a.data - b.data) * np.array([w, h], np.float32)
        assert px.max() <= PX_TOL and abs(a.score - b.score) <= SCORE_TOL


def test_unported_options_raise():
    # bf16 nets construct and run (held against JAX in
    # tests/test_torch_bf16.py); other dtypes raise
    img = load_image(ROT / "man_rotp15.png")
    lmk, presence = tm.FaceLandmark(compute_dtype=torch.bfloat16,
                                    device="cpu").infer_batch(img[None],
                                                              [None])
    assert lmk.shape == (1, 468, 3) and np.isfinite(lmk).all()
    assert presence.shape == (1,)
    with pytest.raises(NotImplementedError):
        tm.FaceLandmark(compute_dtype=torch.float16, device="cpu")
    # "mxu" is ported (tests/test_torch_mxu_sample.py); an unknown method
    # raises
    with pytest.raises(ValueError):
        tm.IrisLandmark(warp_method="bogus", device="cpu")
    with pytest.raises(ValueError):
        tm.FaceLandmark(warp_method="bicubic", device="cpu")


def test_models_default_to_the_card():
    """With no card every model raises unless given device="cpu"."""
    for cls in (tm.FaceDetection, tm.FaceLandmark, tm.IrisLandmark):
        if torch.cuda.is_available():
            assert cls().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                cls()
