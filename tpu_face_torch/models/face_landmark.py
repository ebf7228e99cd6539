"""FaceMesh 468-point face landmark model (counterpart of
tpu_face/models/face_landmark.py).

API parity with the reference ``FaceLandmark`` (face_landmark.rs:200-307,
consts :27-31): the rotated-ROI warp (no letterbox), the PReLU CNN and the
tensor -> image landmark projection run on the model's device in one pass
per call; on the card the warp is the hand-written warp kernel.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import exact_f32, resolve_device
from ..ops import geometry
from ..ops import image as image_ops
from ..ops import postprocess as post
from ..programs import ProgramCache
from ..types import Detection, Landmark, Rect
from ..utils.image_io import load_image
from .face_detection import FaceIndex, frames_on, load_net

NUM_LANDMARKS = 468  # reference face_landmark.rs:29
ROI_SCALE = (1.5, 1.5)  # reference face_landmark.rs:30
DETECTION_THRESHOLD = 0.5  # reference face_landmark.rs:31

# Landmark connection index pairs for rendering, from MediaPipe's
# face_landmarks_to_render_data_calculator.cc (reference
# face_landmark.rs:35-166): lips, left/right eye, left/right eyebrow,
# face oval.
FACE_LANDMARK_CONNECTIONS = [
    # lips
    (61, 146), (146, 91), (91, 181), (181, 84), (84, 17), (17, 314),
    (314, 405), (405, 321), (321, 375), (375, 291), (61, 185), (185, 40),
    (40, 39), (39, 37), (37, 0), (0, 267), (267, 269), (269, 270),
    (270, 409), (409, 291), (78, 95), (95, 88), (88, 178), (178, 87),
    (87, 14), (14, 317), (317, 402), (402, 318), (318, 324), (324, 308),
    (78, 191), (191, 80), (80, 81), (81, 82), (82, 13), (13, 312),
    (312, 311), (311, 310), (310, 415), (415, 308),
    # left eye
    (33, 7), (7, 163), (163, 144), (144, 145), (145, 153), (153, 154),
    (154, 155), (155, 133), (33, 246), (246, 161), (161, 160), (160, 159),
    (159, 158), (158, 157), (157, 173), (173, 133),
    # left eyebrow
    (46, 53), (53, 52), (52, 65), (65, 55), (70, 63), (63, 105),
    (105, 66), (66, 107),
    # right eye
    (263, 249), (249, 390), (390, 373), (373, 374), (374, 380),
    (380, 381), (381, 382), (382, 362), (263, 466), (466, 388),
    (388, 387), (387, 386), (386, 385), (385, 384), (384, 398),
    (398, 362),
    # right eyebrow
    (276, 283), (283, 282), (282, 295), (295, 285), (300, 293),
    (293, 334), (334, 296), (296, 336),
    # face oval
    (10, 338), (338, 297), (297, 332), (332, 284), (284, 251),
    (251, 389), (389, 356), (356, 454), (454, 323), (323, 361),
    (361, 288), (288, 397), (397, 365), (365, 379), (379, 378),
    (378, 400), (400, 377), (377, 152), (152, 148), (148, 176),
    (176, 149), (149, 150), (150, 136), (136, 172), (172, 58),
    (58, 132), (132, 93), (93, 234), (234, 127), (127, 162), (162, 21),
    (21, 54), (54, 103), (103, 67), (67, 109), (109, 10),
]


def face_detection_to_roi(face_detection: Detection,
                          image_size: Tuple[int, int],
                          size_mode: str = geometry.SIZE_MODE_SQUARE_LONG
                          ) -> Rect:
    """Detection -> normalized rotated ROI for ``FaceLandmark``
    (reference face_landmark.rs:180-198): eye keypoints give the
    rotation, scale 1.5, square-long."""
    absolute = face_detection.scaled_by_image_size(image_size)
    left_eye = absolute.keypoint(FaceIndex.LEFT_EYE)
    right_eye = absolute.keypoint(FaceIndex.RIGHT_EYE)
    b = face_detection.bbox()
    cx, cy, w, h, rot = geometry.bbox_to_roi(
        b.xmin, b.ymin, b.xmax, b.ymax, image_size,
        rotation_keypoints=(left_eye, right_eye),
        scale=ROI_SCALE, size_mode=size_mode)
    return Rect(float(cx), float(cy), float(w), float(h), float(rot),
                normalized=True)



def face_landmarks_to_render_data(face_landmarks, landmark_color,
                                  connection_color, thickness: float = 2.0,
                                  output=None):
    """Face mesh -> render annotations (reference
    face_landmark.rs:324-338): 124 connection lines + 468 points."""
    from ..render import landmarks_to_render_data
    return landmarks_to_render_data(
        face_landmarks, FACE_LANDMARK_CONNECTIONS,
        landmark_color=landmark_color, connection_color=connection_color,
        thickness=thickness, normalized_positions=True, output=output)

def _rect_to_abs(roi: Optional[Rect], w: int, h: int) -> np.ndarray:
    if roi is None:
        return np.array([0.5 * w, 0.5 * h, w, h, 0.0], np.float32)
    r = roi.scaled((float(w), float(h)), normalize=False)
    return np.array([r.x_center, r.y_center, r.width, r.height,
                     r.rotation], np.float32)


class FaceLandmark:
    """468-point face mesh. ``infer(image, roi)`` returns normalized
    ``Landmark`` objects (empty list when the presence score is below
    threshold, reference face_landmark.rs:292-296).  Runs on the card
    unless ``device="cpu"``.  ``compute_dtype`` float32 or bfloat16 sets
    the net's (``TFLiteNet``); the warp stays f32."""

    def __init__(self, model_path: Optional[str] = None,
                 compute_dtype=torch.float32, warp_method: str = "auto",
                 device=None):
        self.device = resolve_device(device)
        self.graph, self._net = load_net("face_landmark.npz", model_path,
                                         compute_dtype, self.device)
        _, self.in_h, self.in_w, _ = self.graph.input_shape
        self._warp = image_ops.resolve_warp_method(warp_method, self.device)
        self._cache = ProgramCache(self.device)

    # ---- the device pass ----------------------------------------------

    def _pipeline(self, images, roi_abs, image_size, method):
        """[B, H, W, 3] frames + [B, 5] absolute ROIs -> (landmarks
        [B, 468, 3] normalized, presence score [B]).

        The reference call stack face_landmark.rs:232-305: warp to
        192x192 with keep_aspect_ratio=False and range (0, 1), invoke,
        sigmoid the presence logit, project the mesh through the rotated
        ROI back to normalized image space."""
        tensor, padding = image_ops.warp_image_to_tensor(
            images, roi_abs, (self.in_w, self.in_h),
            keep_aspect_ratio=False, output_range=(0.0, 1.0),
            method=method, band=image_ops.auto_band(max(images.shape[1:3]),
                                                    self.in_h))
        raw_mesh, raw_flag = self._net(tensor)
        b = images.shape[0]
        score = torch.sigmoid(raw_flag.reshape(b))
        landmarks = post.project_landmarks(
            raw_mesh.reshape(b, -1), (self.in_w, self.in_h), image_size,
            padding, roi_abs)
        return landmarks, score

    def _run(self, images, roi_abs):
        images = frames_on(images, self.device)
        h, w = images.shape[1:3]
        method = image_ops.choose_warp_method(
            self._warp, roi_abs, (w, h), (self.in_w, self.in_h), False)
        rois = torch.from_numpy(roi_abs).to(self.device)
        with torch.inference_mode(), exact_f32():
            lmk, score = self._cache(
                ("pipeline", method),
                lambda x, r: self._pipeline(x, r, (w, h), method),
                images, rois)
        return lmk.cpu().numpy(), score.cpu().numpy()

    # ---- host API ------------------------------------------------------

    def infer(self, image, roi: Optional[Rect] = None) -> List[Landmark]:
        img = load_image(image)
        h, w = img.shape[:2]
        lmk, score = self._run(img[None], _rect_to_abs(roi, w, h)[None])
        if float(score[0]) <= DETECTION_THRESHOLD:
            return []
        return [Landmark(float(x), float(y), float(z)) for x, y, z in lmk[0]]

    def infer_batch(self, images, rois):
        """Batched mesh: [B, H, W, 3] images + B normalized ``Rect``
        ROIs -> (landmarks [B, 468, 3] np.ndarray, presence [B]).
        Low-presence entries are NOT filtered (check ``presence``
        against the 0.5 threshold)."""
        if not hasattr(images, "shape"):
            images = np.asarray(images)
        h, w = images.shape[1:3]
        roi_abs = np.stack([_rect_to_abs(r, w, h) for r in rois])
        return self._run(images, roi_abs.astype(np.float32))
