"""The standalone models (counterparts of tpu_face.models): BlazeFace
detection (all five variants: FRONT, BACK, SHORT and the full-range FULL
and FULL_SPARSE), the 468-point face mesh and the iris landmarks, with the
ROI helpers that chain them.  Each takes ``warp_method`` "auto",
"pallas" (the warp kernels), "gather" or "mxu" (the banded hat-weight
matmuls, ``ops.image.mxu_sample``).  The embeddings model and the
render-data helpers are not ported yet."""

from .face_detection import FaceDetection, FaceDetectionModel, FaceIndex
from .face_landmark import (FACE_LANDMARK_CONNECTIONS, FaceLandmark,
                            face_detection_to_roi)
from .iris_landmark import (EYE_LANDMARK_CONNECTIONS, IrisIndex,
                            IrisLandmark, IrisResults, get_iris_depth,
                            get_iris_diameter, iris_roi_from_face_landmarks,
                            update_face_landmarks_with_iris_results)

__all__ = [
    "FaceDetection", "FaceDetectionModel", "FaceIndex",
    "FaceLandmark", "face_detection_to_roi", "FACE_LANDMARK_CONNECTIONS",
    "IrisLandmark", "IrisResults", "IrisIndex",
    "iris_roi_from_face_landmarks",
    "update_face_landmarks_with_iris_results",
    "get_iris_diameter", "get_iris_depth",
    "EYE_LANDMARK_CONNECTIONS",
]
