"""``FaceCascade`` with every detector, on the CPU against
tpu_face.pipeline.FaceCascade.

* FRONT, SHORT, FULL and FULL_SPARSE on the four rotated 540p frames as
  one batch, against JAX's cascade on the same ``detection_model``
  (``warp_method="gather"``), field by field by
  tests/test_torch_cascade.py's rules (equal bools, 0.25 px, 1e-3 rad,
  1e-3).
* FULL_SPARSE with ``max_faces=4`` on canvas (c) (the four frames as a
  2x2 grid on 1080x720): every slot by the same rules.
* FULL on the 540p frames against the ground truth of
  tests/test_rotation_e2e.py: the nose and both iris centres within 2 px
  (the budget that file gives the tracked mesh and iris; its rows come
  from the BACK detector's ROIs).  On the 704x704 close-up FULL misses
  that budget (2.80 px, FULL_SPARSE 3.38 px): the face ROI of another
  detector, not a fault of the port, so the close-up is held against
  JAX only.
* The "mxu" cascade is in tests/test_torch_mxu_sample.py.
"""

import numpy as np
import pytest

import chip_smoke
from test_rotation_e2e import FRAMES_540, GT, ROT
from test_torch_cascade import _compare
from tpu_face.models import FaceDetectionModel as JModel
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch.models import FaceDetectionModel as TModel
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

GT_PX = 2.0


@pytest.fixture(scope="module")
def batch():
    return np.stack([load_image(ROT / n) for n in FRAMES_540])


@pytest.fixture(scope="module")
def full_result(batch):
    return FaceCascade(TModel.FULL, device="cpu").infer_batch(batch)


@pytest.mark.parametrize("model", ["FRONT_CAMERA", "SHORT", "FULL",
                                   "FULL_SPARSE"])
def test_cascade_matches_jax_for_every_detector(batch, full_result, model):
    res = (full_result if model == "FULL" else
           FaceCascade(TModel[model], device="cpu").infer_batch(batch))
    ref = JaxFaceCascade(JModel[model], warp_method="gather").infer_batch(
        batch)
    assert bool(res.mesh_valid.all())
    _compare(res, ref, (540, 360))


def test_full_sparse_four_faces_match_jax():
    canvas = chip_smoke.canvas_grid(load_image)[None]
    res = FaceCascade(TModel.FULL_SPARSE, max_faces=4,
                      device="cpu").infer_batch(canvas)
    ref = JaxFaceCascade(JModel.FULL_SPARSE, max_faces=4,
                         warp_method="gather").infer_batch(canvas)
    assert bool(res.mesh_valid.all())
    _compare(res, ref, (1080, 720))


def test_full_cascade_meets_the_tracked_budget(full_result):
    for i, name in enumerate(FRAMES_540):
        gt = GT[name]
        w, h = gt["size"]
        mesh = full_result.mesh[i].numpy()
        iris = full_result.iris[i].numpy()
        pts = [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
               ((iris[0, 0, 0] * w, iris[0, 0, 1] * h), gt["iris"]["L"]),
               ((iris[1, 0, 0] * w, iris[1, 0, 1] * h), gt["iris"]["R"])]
        for (x, y), (gx, gy) in pts:
            assert abs(x - gx) <= GT_PX and abs(y - gy) <= GT_PX, (
                name, (x, y), (gx, gy))
