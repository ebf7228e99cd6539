"""The standalone models with bf16 nets (``compute_dtype=torch.bfloat16``)
on the CPU: the chain ``FaceDetection`` -> ``FaceLandmark`` ->
``IrisLandmark`` (left, and right mirrored) against JAX's bf16 models on
two rotated frames, JAX's on the port's ROIs (detection on the whole
frame), by the rules of tests/test_torch_bf16.py (measured: detection
<= 0.47 px, iris points <= 0.35 px, nose <= 0.63 px, scores <= 2.7e-3),
and the port's nose and iris centres against the ground truth (<= 1 px).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_rotation_e2e import GT, ROT
from test_torch_bf16 import (BF16, PX_TOL, SCORE_TOL, _check_mesh_steps,
                             _px)
from test_torch_threads import share_cores  # noqa: F401
from tpu_face import models as jm
from tpu_face_torch import models as tm
from tpu_face_torch.utils.image_io import load_image


def _chain(models, img, size, rois=None):
    det, mesh_model, iris_model = models
    pkg = tm if isinstance(det, tm.FaceDetection) else jm
    faces = det.infer(img)
    face_roi = rois[0] if rois else pkg.face_detection_to_roi(faces[0], size)
    mesh = mesh_model.infer(img, face_roi)
    left, right = (rois[1:] if rois
                   else pkg.iris_roi_from_face_landmarks(mesh, size))
    return {"faces": faces, "rois": (face_roi, left, right), "mesh": mesh,
            "eyes": [iris_model.infer(img, left),
                     iris_model.infer(img, right, is_right_eye=True)]}


def _rows(points):
    return np.array([(p.x, p.y, p.z) for p in points], np.float32)


@pytest.mark.parametrize("name", ["man_rotp30.png", "man_closeup_rotp30.png"])
def test_standalone_chain_bf16_matches_jax(name):
    """The port's bf16 chain, and JAX's bf16 models on the port's ROIs
    (detection on the whole frame)."""
    size = GT[name]["size"]
    img = load_image(ROT / name)
    port = (tm.FaceDetection(tm.FaceDetectionModel.BACK_CAMERA,
                             device="cpu", compute_dtype=BF16),
            tm.FaceLandmark(device="cpu", compute_dtype=BF16),
            tm.IrisLandmark(device="cpu", compute_dtype=BF16))
    ref = (jm.FaceDetection(jm.FaceDetectionModel.BACK_CAMERA,
                            warp_method="gather",
                            compute_dtype=jnp.bfloat16),
           jm.FaceLandmark(warp_method="gather", compute_dtype=jnp.bfloat16),
           jm.IrisLandmark(warp_method="gather", compute_dtype=jnp.bfloat16))
    mine = _chain(port, img, size)
    theirs = _chain(ref, img, size, mine["rois"])
    (a,), (b,) = mine["faces"], theirs["faces"]
    assert abs(a.score - b.score) <= SCORE_TOL
    assert _px(a.data, b.data, size).max() <= PX_TOL
    for e, f in zip(mine["eyes"], theirs["eyes"]):
        assert _px(_rows(e.contour + e.iris), _rows(f.contour + f.iris),
                   size).max() <= PX_TOL
    mesh = _px(_rows(mine["mesh"]), _rows(theirs["mesh"]), size)
    assert mesh[0, 1] <= PX_TOL
    roi = mine["rois"][0]
    _check_mesh_steps(mesh, [max(roi.width * size[0],
                                 roi.height * size[1])])
    gt = GT[name]
    for (x, y), (gx, gy) in (
            ((mine["mesh"][1].x, mine["mesh"][1].y), gt["nose"]),
            ((mine["eyes"][0].iris[0].x, mine["eyes"][0].iris[0].y),
             gt["iris"]["L"]),
            ((mine["eyes"][1].iris[0].x, mine["eyes"][1].iris[0].y),
             gt["iris"]["R"])):
        assert abs(x * size[0] - gx) <= 1.0 and abs(y * size[1] - gy) <= 1.0
