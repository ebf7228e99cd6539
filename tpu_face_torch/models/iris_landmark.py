"""Iris landmark model (71 eye-contour + 5 iris points), the eye-ROI
derivation and the mesh-refinement helpers (counterpart of
tpu_face/models/iris_landmark.py).

API parity with the reference ``IrisLandmark`` (iris_landmark.rs:136-248,
consts :25-42, ROI derivation :268-292, refinement :380-398, metrics
:401-433): warp (the right eye mirrored through its coordinates), the
PReLU CNN and both landmark projections (un-mirrored) run on the model's
device in one pass per call; on the card the warp is the hand-written warp
kernel.  The flip is a per-call tensor, so left and right eyes share one
path.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import exact_f32, resolve_device
from ..ops import geometry
from ..ops import image as image_ops
from ..ops import postprocess as post
from ..programs import ProgramCache
from ..types import Landmark, Rect
from ..utils.image_io import load_image
from .face_detection import frames_on, load_net
from .face_landmark import _rect_to_abs

ROI_SCALE = (2.3, 2.3)  # 25% margin around the eye (iris_landmark.rs:27)
LEFT_EYE_START = 33  # iris_landmark.rs:29-35
LEFT_EYE_END = 133
RIGHT_EYE_START = 362
RIGHT_EYE_END = 263
NUM_FACE_LANDMARKS = 468
NUM_EYE_LANDMARKS = 71
NUM_IRIS_LANDMARKS = 5
IRIS_SIZE_IN_MM = 11.8  # average human iris diameter (iris_landmark.rs:100)

# Eye-contour connection pairs for rendering (iris_landmark.rs:44-60).
EYE_LANDMARK_CONNECTIONS = [
    (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8),
    (9, 10), (10, 11), (11, 12), (12, 13), (13, 14), (0, 9), (8, 14),
]

MAX_EYE_LANDMARK = len(EYE_LANDMARK_CONNECTIONS)

# Iris-stage contour index -> face-mesh index maps (71 entries each,
# iris_landmark.rs:64-95): eye contour, then successive surrounding
# "halo" rings and the eyebrow contours.
LEFT_EYE_TO_FACE_LANDMARK_INDEX = [
    33, 7, 163, 144, 145, 153, 154, 155, 133,
    246, 161, 160, 159, 158, 157, 173,
    130, 25, 110, 24, 23, 22, 26, 112, 243,
    247, 30, 29, 27, 28, 56, 190,
    226, 31, 228, 229, 230, 231, 232, 233, 244,
    113, 225, 224, 223, 222, 221, 189,
    35, 124, 46, 53, 52, 65,
    143, 111, 117, 118, 119, 120, 121, 128, 245,
    156, 70, 63, 105, 66, 107, 55, 193,
]

RIGHT_EYE_TO_FACE_LANDMARK_INDEX = [
    263, 249, 390, 373, 374, 380, 381, 382, 362,
    466, 388, 387, 386, 385, 384, 398,
    359, 255, 339, 254, 253, 252, 256, 341, 463,
    467, 260, 259, 257, 258, 286, 414,
    446, 261, 448, 449, 450, 451, 452, 453, 464,
    342, 445, 444, 443, 442, 441, 413,
    265, 353, 276, 283, 282, 295,
    372, 340, 346, 347, 348, 349, 350, 357, 465,
    383, 300, 293, 334, 296, 336, 285, 417,
]


class IrisIndex:
    """Iris keypoint indexes (iris_landmark.rs:102-110)."""

    CENTER = 0
    LEFT = 1
    TOP = 2
    RIGHT = 3
    BOTTOM = 4


class IrisResults:
    """Iris detection results: 71-point eye-region contour + 5 iris
    keypoints (iris_landmark.rs:115-129)."""

    def __init__(self, contour: List[Landmark], iris: List[Landmark]):
        self.contour = contour
        self.iris = iris

    def eyeball_contour(self) -> List[Landmark]:
        """First 15 contour points: the eyeball outline."""
        return self.contour[:MAX_EYE_LANDMARK]


def _eye_roi(landmarks, start: int, end: int,
             image_size: Tuple[int, int]) -> Rect:
    lm0, lm1 = landmarks[start], landmarks[end]
    xmin, ymin, xmax, ymax = geometry.bbox_from_landmarks_xy(
        np.array([lm0.x, lm1.x]), np.array([lm0.y, lm1.y]))
    cx, cy, w, h, rot = geometry.bbox_to_roi(
        float(xmin), float(ymin), float(xmax), float(ymax), image_size,
        rotation_keypoints=((lm0.x, lm0.y), (lm1.x, lm1.y)),
        scale=ROI_SCALE, size_mode=geometry.SIZE_MODE_SQUARE_LONG)
    return Rect(float(cx), float(cy), float(w), float(h), float(rot),
                normalized=True)


def iris_roi_from_face_landmarks(face_landmarks: List[Landmark],
                                 image_size: Tuple[int, int]
                                 ) -> Tuple[Rect, Rect]:
    """MediaPipe "iris_landmark_landmarks_to_roi": normalized (left,
    right) eye ROIs from the face mesh (iris_landmark.rs:268-292).
    Per eye: bbox of the two corner landmarks, rotation from the same
    pair, scale 2.3, square-long."""
    left = _eye_roi(face_landmarks, LEFT_EYE_START, LEFT_EYE_END,
                    image_size)
    right = _eye_roi(face_landmarks, RIGHT_EYE_START, RIGHT_EYE_END,
                     image_size)
    return left, right


def update_face_landmarks_with_iris_results(
        face_landmarks: List[Landmark],
        iris_data_left: IrisResults,
        iris_data_right: IrisResults) -> List[Landmark]:
    """Replace the 2x71 eye-region points of the 468 mesh with the
    refined iris-stage contours (iris_landmark.rs:380-398)."""
    if len(face_landmarks) != NUM_FACE_LANDMARKS:
        raise ValueError("unexpected number of items in face_landmarks")
    refined = list(face_landmarks)
    for n, point in enumerate(iris_data_left.contour):
        refined[LEFT_EYE_TO_FACE_LANDMARK_INDEX[n]] = point
    for n, point in enumerate(iris_data_right.contour):
        refined[RIGHT_EYE_TO_FACE_LANDMARK_INDEX[n]] = point
    return refined


def get_iris_diameter(iris_landmarks: List[Landmark],
                      image_size: Tuple[int, int]) -> float:
    """Iris diameter in pixels: mean of the horizontal and vertical
    keypoint extents (iris_landmark.rs:401-418)."""
    w, h = image_size

    def dist(a: Landmark, b: Landmark) -> float:
        dx = (a.x - b.x) * w
        dy = (a.y - b.y) * h
        return float(np.hypot(dx, dy))

    horiz = dist(iris_landmarks[IrisIndex.LEFT],
                 iris_landmarks[IrisIndex.RIGHT])
    vert = dist(iris_landmarks[IrisIndex.TOP],
                iris_landmarks[IrisIndex.BOTTOM])
    return (vert + horiz) / 2.0


def get_iris_depth(iris_landmarks: List[Landmark], focal_length_mm: float,
                   iris_size_px: float, image_size: Tuple[int, int]
                   ) -> float:
    """Iris depth in mm from the 11.8 mm human-iris prior
    (iris_landmark.rs:421-433).  The reference centers on the
    integer-divided image midpoint; kept for parity."""
    w, h = image_size
    center = iris_landmarks[IrisIndex.CENTER]
    x0, y0 = w // 2, h // 2
    x1, y1 = center.x * w, center.y * h
    y = float(np.hypot(x0 - x1, y0 - y1))
    x = float(np.hypot(focal_length_mm, y))
    return IRIS_SIZE_IN_MM * x / iris_size_px


def eye_landmarks_to_render_data(eye_contour, landmark_color,
                                 connection_color, thickness: float = 2.0,
                                 output=None):
    """Eyeball contour -> render annotations (reference
    iris_landmark.rs:312-328): the first 15 contour points with the 15
    eye connections."""
    from ..render import landmarks_to_render_data
    return landmarks_to_render_data(
        eye_contour[:MAX_EYE_LANDMARK], EYE_LANDMARK_CONNECTIONS,
        landmark_color=landmark_color, connection_color=connection_color,
        thickness=thickness, normalized_positions=True, output=output)


def iris_landmarks_to_render_data(iris_landmarks, landmark_color=None,
                                  oval_color=None, thickness: float = 1.0,
                                  image_size=None, output=None):
    """Iris keypoints -> render annotations (reference
    iris_landmark.rs:330-375): optional iris circle (drawn as the
    reference's rect-not-oval) + the 5 keypoints."""
    from ..render import Annotation, Point, RectOrOval

    annotations = []
    if oval_color is not None:
        if image_size is None:
            image_size = (-1, -1)
        w, h = image_size
        if w < 2 or h < 2:
            raise ValueError("oval_color requires a valid image_size arg")
        radius = get_iris_diameter(iris_landmarks, image_size) / 2.0
        center = iris_landmarks[IrisIndex.CENTER]
        oval = RectOrOval(center.x - radius / w, center.y - radius / h,
                          center.x + radius / w, center.y + radius / h,
                          oval=True)
        annotations.append(Annotation([oval], True, thickness, oval_color))
    if landmark_color is not None:
        points = [Point(lmk.x, lmk.y) for lmk in iris_landmarks]
        annotations.append(Annotation(points, True, thickness,
                                      landmark_color))
    if output is not None:
        output.extend(annotations)
        return output
    return annotations


def _landmarks(rows) -> List[Landmark]:
    return [Landmark(float(x), float(y), float(z)) for x, y, z in rows]


class IrisLandmark:
    """Iris + eye-contour landmarks from an eye ROI.  ``infer(image,
    roi, is_right_eye)`` mirrors the eye horizontally for the right eye
    before inference and un-mirrors the projected landmarks
    (iris_landmark.rs:158-248).  Runs on the card unless
    ``device="cpu"``.  ``compute_dtype`` float32 or bfloat16 sets the
    net's (``TFLiteNet``); the warp stays f32."""

    def __init__(self, model_path: Optional[str] = None,
                 compute_dtype=torch.float32, warp_method: str = "auto",
                 device=None):
        self.device = resolve_device(device)
        self.graph, self._net = load_net("iris_landmark.npz", model_path,
                                         compute_dtype, self.device)
        _, self.in_h, self.in_w, _ = self.graph.input_shape
        self._warp = image_ops.resolve_warp_method(warp_method, self.device)
        self._cache = ProgramCache(self.device)

    # ---- the device pass ----------------------------------------------

    def _pipeline(self, images, roi_abs, flip, image_size, method):
        """[B, H, W, 3] frames + [B, 5] absolute ROIs + [B] flip flags ->
        (contour [B, 71, 3], iris [B, 5, 3]) normalized."""
        size = (self.in_w, self.in_h)
        tensor, padding = image_ops.warp_image_to_tensor(
            images, roi_abs, size, keep_aspect_ratio=True,
            output_range=(0.0, 1.0), flip_horizontal=flip, method=method,
            band=image_ops.auto_band(max(images.shape[1:3]), self.in_h))
        raw_contour, raw_iris = self._net(tensor)
        b = images.shape[0]
        contour = post.project_landmarks(
            raw_contour.reshape(b, -1), size, image_size, padding, roi_abs,
            flip_horizontal=flip)
        iris = post.project_landmarks(
            raw_iris.reshape(b, -1), size, image_size, padding, roi_abs,
            flip_horizontal=flip)
        return contour, iris

    def _run(self, images, roi_abs, flips):
        images = frames_on(images, self.device)
        h, w = images.shape[1:3]
        method = image_ops.choose_warp_method(
            self._warp, roi_abs, (w, h), (self.in_w, self.in_h), True)
        rois = torch.from_numpy(roi_abs).to(self.device)
        flip = torch.from_numpy(flips).to(self.device)
        with torch.inference_mode(), exact_f32():
            contour, iris = self._cache(
                ("pipeline", method),
                lambda x, r, f: self._pipeline(x, r, f, (w, h), method),
                images, rois, flip)
        return contour.cpu().numpy(), iris.cpu().numpy()

    # ---- host API ------------------------------------------------------

    def infer(self, image, roi: Rect, is_right_eye: bool = False
              ) -> IrisResults:
        img = load_image(image)
        h, w = img.shape[:2]
        contour, iris = self._run(img[None], _rect_to_abs(roi, w, h)[None],
                                  np.array([bool(is_right_eye)]))
        return IrisResults(_landmarks(contour[0]), _landmarks(iris[0]))

    def infer_batch(self, images, rois, is_right_eye):
        """Batched iris: [B, H, W, 3] images + B normalized ``Rect``
        ROIs + B flip flags -> (contour [B, 71, 3], iris [B, 5, 3])
        np.ndarrays."""
        if not hasattr(images, "shape"):
            images = np.asarray(images)
        b, h, w = images.shape[:3]
        roi_abs = np.stack([_rect_to_abs(r, w, h) for r in rois])
        flips = np.asarray(is_right_eye, bool).reshape(b)
        return self._run(images, roi_abs.astype(np.float32), flips)
