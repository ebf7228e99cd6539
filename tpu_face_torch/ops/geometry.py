"""ROI-derivation geometry (DetectionsToRect + RectTransformation), a
copy of tpu_face/ops/geometry.py for the standalone models' host APIs.

Array-module-polymorphic as the original: the models pass ``xp=numpy``
(float64, reference parity).
Reference: transform.rs:16-109 (SizeMode, bbox_to_roi, select_roi_size),
transform.rs:146-165 (bbox_from_landmarks).
"""

import math
from typing import Tuple

import numpy as np

SIZE_MODE_DEFAULT = "default"
SIZE_MODE_SQUARE_LONG = "square_long"
SIZE_MODE_SQUARE_SHORT = "square_short"


def normalize_rotation(angle, xp=np):
    """Normalize to (-pi, pi] (reference transform.rs:68-71)."""
    two_pi = 2.0 * math.pi
    return angle - two_pi * xp.floor((angle + math.pi) / two_pi)


def rotation_from_keypoints(kp0_x, kp0_y, kp1_x, kp1_y, xp=np):
    """Rotation from two keypoints, e.g. the eye pair
    (reference transform.rs:62-75)."""
    angle = -xp.arctan2(kp0_y - kp1_y, kp1_x - kp0_x)
    return normalize_rotation(angle, xp)


def select_roi_size(xmin, ymin, xmax, ymax, image_size: Tuple[int, int],
                    size_mode: str, xp=np):
    """Normalized ROI (width, height) per size mode
    (reference transform.rs:87-109)."""
    iw, ih = float(image_size[0]), float(image_size[1])
    aw = (xmax - xmin) * iw
    ah = (ymax - ymin) * ih
    if size_mode == SIZE_MODE_SQUARE_LONG:
        long_side = xp.maximum(aw, ah)
        return long_side / iw, long_side / ih
    if size_mode == SIZE_MODE_SQUARE_SHORT:
        short_side = xp.minimum(aw, ah)
        return short_side / iw, short_side / ih
    return (xmax - xmin), (ymax - ymin)


def bbox_to_roi(xmin, ymin, xmax, ymax, image_size: Tuple[int, int],
                rotation_keypoints=None,
                scale: Tuple[float, float] = (1.0, 1.0),
                size_mode: str = SIZE_MODE_DEFAULT, xp=np):
    """Normalized bbox -> rotated ROI (cx, cy, w, h, rotation), normalized.

    ``rotation_keypoints``: optional ((x0, y0), (x1, y1)) in normalized
    image coordinates. Reference transform.rs:44-85.
    """
    w, h = select_roi_size(xmin, ymin, xmax, ymax, image_size, size_mode, xp)
    w = w * scale[0]
    h = h * scale[1]
    cx = xmin + (xmax - xmin) / 2.0
    cy = ymin + (ymax - ymin) / 2.0
    if rotation_keypoints is None:
        rot = xp.zeros(()) if xp is not np else 0.0
    else:
        (x0, y0), (x1, y1) = rotation_keypoints
        rot = rotation_from_keypoints(x0, y0, x1, y1, xp)
    return cx, cy, w, h, rot


def bbox_from_landmarks_xy(xs, ys, xp=np):
    """Enclosing bbox of landmark points (reference transform.rs:146-165)."""
    return xp.min(xs), xp.min(ys), xp.max(xs), xp.max(ys)


def roi_to_abs(roi, image_size: Tuple[int, int], xp=np):
    """(cx, cy, w, h, rot) normalized -> absolute pixels, stacked (5,)."""
    w, h = float(image_size[0]), float(image_size[1])
    cx, cy, rw, rh, rot = roi
    return xp.stack([xp.asarray(cx * w, dtype=xp.float32),
                     xp.asarray(cy * h, dtype=xp.float32),
                     xp.asarray(rw * w, dtype=xp.float32),
                     xp.asarray(rh * h, dtype=xp.float32),
                     xp.asarray(rot, dtype=xp.float32)])


def crop_roi_from_detection(box, image_size: Tuple[int, int], xp=np):
    """Detection corner rows -> the reference's int-truncated
    axis-aligned crop rect, intersected with the frame.

    ``box`` is [..., 2, 2] normalized ((xmin, ymin), (xmax, ymax)) — the
    first two rows of a Detection.  Reference semantics
    face_embeddings.rs:101-109: int() of xmin/ymin and of the float
    width/height; the frame intersection is ours (Mat::roi would
    error out of bounds).  Degenerate boxes clamp to a 1-px crop
    instead of failing.  Returns float32 (roi_abs [..., 5], crop_bbox
    [..., 4] = (x0, y0, x1, y1) absolute), f32 like every other ROI
    producer.  ``xp`` is numpy or torch (a batch of boxes on the
    device, as ``pipeline.EmbedCascade`` and
    ``models.FaceEmbeddings.embed_boxes`` give it)."""
    w, h = image_size
    if xp is np:
        box = np.asarray(box, np.float32)
        stack = lambda vs: np.stack(vs, axis=-1).astype(np.float32)
        lower = np.maximum
    else:
        box = box.to(xp.float32)
        stack = lambda vs: xp.stack(vs, dim=-1)
        lower = xp.maximum
    x = xp.trunc(box[..., 0, 0] * w)
    y = xp.trunc(box[..., 0, 1] * h)
    cw = xp.trunc((box[..., 1, 0] - box[..., 0, 0]) * w)
    ch = xp.trunc((box[..., 1, 1] - box[..., 0, 1]) * h)
    x0 = xp.clip(x, 0.0, w - 1.0)
    y0 = xp.clip(y, 0.0, h - 1.0)
    # clip(v, lo, hi) with a per-box lo: min(max(v, lo), hi)
    x1 = xp.clip(lower(x + cw, x0 + 1.0), None, float(w))
    y1 = xp.clip(lower(y + ch, y0 + 1.0), None, float(h))
    roi_abs = stack([(x0 + x1) / 2.0, (y0 + y1) / 2.0, x1 - x0, y1 - y0,
                     xp.zeros_like(x0)])
    return roi_abs, stack([x0, y0, x1, y1])
