"""Edge inputs on tpu_face_torch (``device="cpu"``), each held to the JAX
package's behaviour on the same input (tests/test_robustness.py's cases):

* a black frame gives no detection, and the cascade marks its face and
  its mesh invalid;
* a noise frame gives no detection, and a 16x16 frame runs (it
  upscales through the letterbox warp), with as many detections as
  ``tpu_face`` finds on it;
* an [H, W] frame raises ``ValueError`` naming "[H,W,3]", NaN pixels
  raise ``ValueError``;
* a ``model_path`` without the converted weights raises
  ``FileNotFoundError`` naming ``tools/convert_tflite.py``.
"""

import numpy as np
import pytest

from test_torch_threads import share_cores  # noqa: F401
from tpu_face.models import FaceDetection as JaxFaceDetection
from tpu_face.models import FaceDetectionModel as JaxModel
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch.models import FaceDetection, FaceDetectionModel
from tpu_face_torch.pipeline import FaceCascade


@pytest.fixture(scope="module")
def detectors():
    """(port, JAX) short-range detectors, shared by the module."""
    return (FaceDetection(FaceDetectionModel.SHORT, device="cpu"),
            JaxFaceDetection(JaxModel.SHORT))


def _frame(kind):
    if kind == "black":
        return np.zeros((360, 540, 3), np.uint8)
    if kind == "noise":
        return np.random.RandomState(0).randint(0, 256, (360, 540, 3),
                                                np.uint8)
    return np.random.RandomState(1).randint(0, 256, (16, 16, 3), np.uint8)


@pytest.mark.parametrize("kind,want", [("black", 0), ("noise", 0),
                                       ("tiny", None)])
def test_edge_frames_match_jax(detectors, kind, want):
    """Black and noise frames give no face, as in JAX; a 16x16 frame runs
    and finds what JAX finds."""
    port, ref = detectors
    img = _frame(kind)
    faces = port.infer(img)
    assert isinstance(faces, list)
    assert len(faces) == len(ref.infer(img))
    if want is not None:
        assert len(faces) == want


def test_black_frame_cascade_invalid():
    img = np.zeros((240, 320, 3), np.uint8)
    res = FaceCascade(FaceDetectionModel.SHORT, device="cpu").infer_batch(img)
    ref = JaxFaceCascade(JaxModel.SHORT).infer_batch(img)
    for field in ("face_valid", "mesh_valid"):
        got = getattr(res, field).numpy()
        assert not got.any(), field
        assert (got == np.asarray(getattr(ref, field))).all(), field


@pytest.mark.parametrize("bad,match", [
    (np.zeros((64, 64), np.uint8), r"\[H,W,3\]"),
    (np.full((64, 64, 3), np.nan, np.float32), "NaN")])
def test_bad_frames_rejected(detectors, bad, match):
    port, ref = detectors
    with pytest.raises(ValueError, match=match):
        port.infer(bad)
    with pytest.raises(ValueError):
        ref.infer(bad)


def test_missing_model_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="tools/convert_tflite.py"):
        FaceDetection(FaceDetectionModel.SHORT, model_path=str(tmp_path),
                      device="cpu")
    with pytest.raises(FileNotFoundError, match="convert_tflite"):
        JaxFaceDetection(JaxModel.SHORT, model_path=str(tmp_path))
