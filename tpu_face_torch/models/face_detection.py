"""BlazeFace detector constants (counterpart of
tpu_face/models/face_detection.py): model variants, weight files and SSD
anchor options.  The weights are read by path from the JAX package's
data directory; nothing of that package is imported."""

import enum
from pathlib import Path

from ..ops import anchors as anchors_lib

_DATA_DIR = Path(__file__).resolve().parents[2] / "tpu_face" / "data"


class FaceDetectionModel(enum.Enum):
    """Model variants (reference face_detection.rs:116-123)."""

    FRONT_CAMERA = 0
    BACK_CAMERA = 1
    SHORT = 2
    FULL = 3
    FULL_SPARSE = 4


_MODEL_FILES = {
    FaceDetectionModel.FRONT_CAMERA: "face_detection_front",
    FaceDetectionModel.BACK_CAMERA: "face_detection_back",
    FaceDetectionModel.SHORT: "face_detection_short_range",
    FaceDetectionModel.FULL: "face_detection_full_range",
    FaceDetectionModel.FULL_SPARSE: "face_detection_full_range_sparse",
}

_SSD_OPTS = {
    FaceDetectionModel.FRONT_CAMERA: anchors_lib.SSDOptions.front(),
    FaceDetectionModel.BACK_CAMERA: anchors_lib.SSDOptions.back(),
    FaceDetectionModel.SHORT: anchors_lib.SSDOptions.short(),
    FaceDetectionModel.FULL: anchors_lib.SSDOptions.full(),
    FaceDetectionModel.FULL_SPARSE: anchors_lib.SSDOptions.full(),
}
