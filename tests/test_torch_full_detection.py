"""The full-range detectors (FULL, FULL_SPARSE) and every detector in the
cascade, on the CPU against tpu_face.

* ``FaceDetection(FULL)`` and ``FaceDetection(FULL_SPARSE)`` against
  ``tpu_face``'s (``warp_method="gather"``) on the seven rotated frames
  and canvas (c) (the four 540p frames as a 2x2 grid on 1080x720):
  the same faces, points within 0.25 px, scores within 1e-3
  (tests/test_torch_models.py's ``PX_TOL``/``SCORE_TOL``).  The two
  200x225 portraits take the two-stage letterbox, and there JAX runs
  un-jitted: jitted, XLA's fused arithmetic rounds 95 of the 110,592
  values of its uint8 intermediate one level apart from its own eager
  result (ROADMAP queue 3's letterbox near-tie), which on russ2_rotm20
  drops FULL's anchor 1176 (score 0.50007 eager, 0.49964 jitted) below
  the 0.5 validity threshold and moves the merged box by 1.06 px.  Eager
  JAX and the port compute the same letterbox.
* ``FaceDetection.infer`` with an explicit rotated ROI, for BACK and
  FULL, against ``tpu_face`` on the same ROI.
* The cascades are in tests/test_torch_full_cascade.py.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from test_rotation_e2e import GT, GT_PORTRAIT, ROT
from test_torch_threads import share_cores  # noqa: F401
from tpu_face import models as jm
from tpu_face import types as jtypes
from tpu_face_torch import models as tm
from tpu_face_torch import types as ttypes
from tpu_face_torch.ops import image as timage
from tpu_face_torch.utils.image_io import load_image

ROWS = {**GT, **GT_PORTRAIT}
PX_TOL = 0.25
SCORE_TOL = 1e-3
MODELS = ("FULL", "FULL_SPARSE")


@pytest.fixture(scope="module")
def detectors():
    return {m: (tm.FaceDetection(tm.FaceDetectionModel[m], device="cpu"),
                jm.FaceDetection(jm.FaceDetectionModel[m],
                                 warp_method="gather"))
            for m in MODELS + ("BACK_CAMERA",)}


def _same_faces(mine, want, size):
    w, h = size
    assert len(mine) == len(want) >= 1, (len(mine), len(want))
    for a, b in zip(mine, want):
        px = np.abs(a.data - b.data) * np.array([w, h], np.float32)
        assert px.max() <= PX_TOL, px.max()
        assert abs(a.score - b.score) <= SCORE_TOL, (a.score, b.score)


@pytest.mark.parametrize("name", list(ROWS) + ["canvas_c"])
@pytest.mark.parametrize("model", MODELS)
def test_full_range_detection_matches_jax(detectors, model, name):
    img = (chip_smoke.canvas_grid(load_image) if name == "canvas_c"
           else load_image(ROT / name))
    size = (img.shape[1], img.shape[0])
    mine, ref = detectors[model]
    faces = mine.infer(img)
    if timage.letterbox_two_stage_params(size, (mine.in_w, mine.in_h)):
        with jax.disable_jit():
            want = ref.infer(img)
    else:
        want = ref.infer(img)
    _same_faces(faces, want, size)
    if name == "canvas_c":
        assert len(faces) == 4


@pytest.mark.parametrize("model", MODELS + ("BACK_CAMERA",))
def test_detection_with_a_rotated_roi_matches_jax(detectors, model):
    """The ROI path of ``infer`` (re-checked for this slice): a rotated
    ROI around the face of man_rotm30, keep-aspect letterbox."""
    img = load_image(ROT / "man_rotm30.png")
    mine, ref = detectors[model]
    args = (0.53, 0.43, 0.5, 0.62, 0.3)
    faces = mine.infer(img, ttypes.Rect(*args, normalized=True))
    _same_faces(faces, ref.infer(img, jtypes.Rect(*args, normalized=True)),
                (540, 360))


def test_every_model_constructs_in_f32_and_bf16():
    for model in tm.FaceDetectionModel:
        for dtype in (torch.float32, torch.bfloat16):
            det = tm.FaceDetection(model, compute_dtype=dtype, device="cpu")
            assert det._net.compute_dtype == dtype
    for model in MODELS:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tm.FaceDetection(tm.FaceDetectionModel[model])
