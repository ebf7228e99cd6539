"""BlazeFace face detection (counterpart of
tpu_face/models/face_detection.py).

API parity with the reference ``FaceDetection`` (face_detection.rs:146-
267): preprocessing (rotated-ROI warp + letterbox + normalize), the CNN,
box decoding, clamped sigmoid scoring, weighted NMS and letterbox removal
run on the model's device in one batched pass per call.  On the card the
warp is the hand-written warp kernel (``ops/image.warp_image_to_tensor``,
method "pallas") and the detector's residual runs are the fused block
kernel (``compiler/lowering.py``), and the pass is a CUDA graph captured
on the first call at each geometry (``programs.ProgramCache``, the JAX
model's ``_get_jitted``).  The weights are read by path from the
JAX package's data directory; nothing of that package is imported.
"""

import enum
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .. import exact_f32, resolve_device
from ..compiler import Graph, build_torch_fn
from ..programs import ProgramCache
from ..ops import anchors as anchors_lib
from ..ops import image as image_ops
from ..ops import postprocess as post
from ..types import Detection, Rect
from ..utils.image_io import load_image

_DATA_DIR = Path(__file__).resolve().parents[2] / "tpu_face" / "data"


class FaceDetectionModel(enum.Enum):
    """Model variants (reference face_detection.rs:116-123)."""

    FRONT_CAMERA = 0
    BACK_CAMERA = 1
    SHORT = 2
    FULL = 3
    FULL_SPARSE = 4


class FaceIndex(enum.IntEnum):
    """Keypoint indexes (reference face_detection.rs:89-98)."""

    LEFT_EYE = 0
    RIGHT_EYE = 1
    NOSE_TIP = 2
    MOUTH = 3
    LEFT_EYE_TRAGION = 4
    RIGHT_EYE_TRAGION = 5


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

def frames_on(images, device):
    """A frame batch [B, H, W, 3] (numpy, torch or a list of arrays) as a
    contiguous tensor on ``device``."""
    if not hasattr(images, "shape"):
        images = np.asarray(images)
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.require(images, requirements="CW"))
    return images.to(device)


def load_net(file_name: str, model_path, compute_dtype, device):
    """(graph, lowered net on ``device`` computing in ``compute_dtype``,
    float32 or bfloat16; any other raises) of
    ``<model_path>/<file_name>``."""
    base = Path(model_path) if model_path else _DATA_DIR
    npz = base / file_name
    if not npz.exists():
        raise FileNotFoundError(
            f"converted model not found: {npz} — run "
            f"tools/convert_tflite.py on the .tflite first")
    graph = Graph(npz)
    return graph, build_torch_fn(graph, device,
                                 compute_dtype=compute_dtype)


class FaceDetection:
    """BlazeFace detector. ``infer`` accepts an RGB image (array, PIL,
    path or bytes) and an optional ROI ``Rect``; returns normalized
    ``Detection`` objects, strongest first.

    Runs on the card unless ``device="cpu"`` (and raises without one).
    Every ``FaceDetectionModel`` is ported (FULL and FULL_SPARSE, the
    full-range pair at 192x192, run op by op: their bottleneck residual
    blocks are no run for the fused kernel).  Any ``compute_dtype`` but
    f32 and bf16 raises ``NotImplementedError``.  In bf16 the net
    computes in bf16 (as JAX's ``build_jax_fn(...,
    compute_dtype=jnp.bfloat16)``); the warp and the post-processing stay
    f32.  ``warp_method`` "mxu" samples with ``auto_band``'s band, as
    JAX's models do.
    ``nms_top_m`` is accepted for signature parity: the weighted NMS
    always merges over the full pool, as in JAX."""

    def __init__(self,
                 model_type: FaceDetectionModel = FaceDetectionModel.SHORT,
                 model_path: Optional[str] = None,
                 max_faces: int = 16,
                 compute_dtype=torch.float32,
                 warp_method: str = "auto",
                 nms_top_m: int = 128,
                 device=None):
        self.device = resolve_device(device)
        self.model_type = model_type
        self.graph, self._net = load_net(f"{_MODEL_FILES[model_type]}.npz",
                                         model_path, compute_dtype,
                                         self.device)
        self.anchors = torch.from_numpy(anchors_lib.ssd_generate_anchors(
            _SSD_OPTS[model_type])).to(self.device)
        _, self.in_h, self.in_w, _ = self.graph.input_shape
        self.max_faces = max_faces
        self.nms_top_m = nms_top_m
        self._warp = image_ops.resolve_warp_method(warp_method, self.device)
        self._cache = ProgramCache(self.device)

    # ---- the device pass ----------------------------------------------

    def _pipeline(self, images, roi_abs, method, two_stage=None):
        """[B, H, W, 3] frames + [B, 5] absolute ROIs -> (data
        [B, T, P, 2], score [B, T], valid [B, T]).  ``two_stage``: the
        static intermediate geometry of the exact double-resize letterbox
        (whole-image ROI where the fused single map is inexact;
        ``image_ops.letterbox_two_stage_params``)."""
        b, h, w = images.shape[:3]
        if two_stage is not None:
            tensor, padding = image_ops.letterbox_two_stage(
                images.float(), (w, h), (self.in_w, self.in_h), two_stage,
                (-1.0, 1.0))
        else:
            tensor, padding = image_ops.warp_image_to_tensor(
                images, roi_abs, (self.in_w, self.in_h),
                keep_aspect_ratio=True, output_range=(-1.0, 1.0),
                method=method, band=image_ops.auto_band(max(h, w),
                                                        self.in_h))
            padding = padding[:, None]           # per frame, every face
        raw_boxes, raw_scores = self._net(tensor)
        boxes = post.decode_boxes(raw_boxes, self.anchors, float(self.in_h))
        scores = post.clamped_sigmoid(raw_scores.reshape(b, -1))
        valid = post.detection_validity(boxes, scores)
        out_d, out_s, out_v = post.weighted_nms(boxes, scores, valid,
                                                max_outputs=self.max_faces)
        return post.letterbox_removal(out_d, padding), out_s, out_v

    def _run(self, images, rois, method, two_stage):
        images = frames_on(images, self.device)
        rois = torch.from_numpy(np.ascontiguousarray(rois, np.float32)).to(
            self.device)
        with torch.inference_mode(), exact_f32():
            out = self._cache(
                ("pipeline", method, two_stage),
                lambda x, r: self._pipeline(x, r, method, two_stage),
                images, rois)
        return [t.cpu().numpy() for t in out]

    # ---- host API ------------------------------------------------------

    def infer(self, image, roi: Optional[Rect] = None) -> List[Detection]:
        img = load_image(image)
        h, w = img.shape[:2]
        two = None
        if roi is None:
            roi_abs = np.array([0.5 * w, 0.5 * h, w, h, 0.0], np.float32)
            # whole-image ROI: geometries where int-truncated pads make
            # the reference's first resize non-identity take the exact
            # double-resize path
            two = image_ops.letterbox_two_stage_params(
                (w, h), (self.in_w, self.in_h))
        else:
            r = roi.scaled((float(w), float(h)), normalize=False)
            roi_abs = np.array([r.x_center, r.y_center, r.width, r.height,
                                r.rotation], np.float32)
        method = image_ops.choose_warp_method(
            self._warp, roi_abs, (w, h), (self.in_w, self.in_h), True)
        out_d, out_s, out_v = self._run(img[None], roi_abs[None], method,
                                        two)
        return [Detection(out_d[0, i], out_s[0, i])
                for i in range(out_v.shape[1]) if out_v[0, i]]

    def infer_batch(self, images) -> List[List[Detection]]:
        """Batched detection: [B, H, W, 3] uint8/float frames of one size
        (numpy, torch or a list) -> per-image detection lists, in one
        pass on the device."""
        if not hasattr(images, "shape"):
            images = np.asarray(images)
        b, h, w = images.shape[:3]
        rois = np.broadcast_to(
            np.array([0.5 * w, 0.5 * h, w, h, 0.0], np.float32), (b, 5))
        method = image_ops.choose_warp_method(
            self._warp, rois[0], (w, h), (self.in_w, self.in_h), True)
        two = image_ops.letterbox_two_stage_params(
            (w, h), (self.in_w, self.in_h))
        out_d, out_s, out_v = self._run(images, rois, method, two)
        return [[Detection(out_d[i, j], out_s[i, j])
                 for j in range(out_v.shape[1]) if out_v[i, j]]
                for i in range(b)]
