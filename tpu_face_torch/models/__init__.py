"""The standalone models (counterparts of tpu_face.models): BlazeFace
detection (all five variants: FRONT, BACK, SHORT and the full-range FULL
and FULL_SPARSE), the 468-point face mesh, the iris landmarks and the face
embeddings, with the ROI helpers that chain them and the render-data
helpers that draw their results (``tpu_face_torch.render``).  The
landmark models take ``warp_method`` "auto", "pallas" (the warp
kernels), "gather" or "mxu" (the banded hat-weight matmuls,
``ops.image.mxu_sample``); ``FaceEmbeddings``' axis-aligned crop takes the
separable hat matmuls for "pallas"."""

from .face_detection import FaceDetection, FaceDetectionModel, FaceIndex
from .face_embeddings import FaceEmbeddings, FeatureCount
from .face_landmark import (FACE_LANDMARK_CONNECTIONS, FaceLandmark,
                            face_detection_to_roi,
                            face_landmarks_to_render_data)
from .iris_landmark import (EYE_LANDMARK_CONNECTIONS, IrisIndex,
                            IrisLandmark, IrisResults,
                            eye_landmarks_to_render_data, get_iris_depth,
                            get_iris_diameter, iris_landmarks_to_render_data,
                            iris_roi_from_face_landmarks,
                            update_face_landmarks_with_iris_results)

__all__ = [
    "FaceDetection", "FaceDetectionModel", "FaceIndex",
    "FaceLandmark", "face_detection_to_roi", "FACE_LANDMARK_CONNECTIONS",
    "face_landmarks_to_render_data",
    "IrisLandmark", "IrisResults", "IrisIndex",
    "iris_roi_from_face_landmarks",
    "update_face_landmarks_with_iris_results",
    "get_iris_diameter", "get_iris_depth",
    "eye_landmarks_to_render_data", "iris_landmarks_to_render_data",
    "EYE_LANDMARK_CONNECTIONS",
    "FaceEmbeddings", "FeatureCount",
]
