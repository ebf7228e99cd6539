"""Core data types: ImageTensor, Rect, BBox, Landmark, Detection
(a copy of tpu_face/types.py: numpy only, so the port keeps its own).

API-parity layer mirroring the reference's core types
(reference: src/face_detection_lite/types.rs:5-246).  These are host-side
containers; on-device code works with raw tensors and only materializes
these types at the API boundary.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import math
import numpy as np


@dataclass
class ImageTensor:
    """Tensor data + letterbox padding + original image size.

    Mirrors reference types.rs:5-22. ``padding`` is (left, top, right,
    bottom) as fractions of the output tensor; ``original_size`` is
    (width, height) in pixels.
    """

    tensor_data: np.ndarray
    padding: Tuple[float, float, float, float]
    original_size: Tuple[int, int]


@dataclass(frozen=True)
class Rect:
    """Rotated rectangle (center, size, clockwise rotation in radians).

    Mirrors reference types.rs:24-97 including the truncate-to-int
    behaviour of ``size()`` for absolute-coordinate rects.
    """

    x_center: float
    y_center: float
    width: float
    height: float
    rotation: float = 0.0
    normalized: bool = True

    def size(self) -> Tuple[float, float]:
        if self.normalized:
            return (self.width, self.height)
        return (float(int(self.width)), float(int(self.height)))

    def scaled(self, size: Tuple[float, float], normalize: bool = False
               ) -> "Rect":
        if self.normalized == normalize:
            return self
        sx, sy = (1.0 / size[0], 1.0 / size[1]) if normalize else size
        return Rect(self.x_center * sx, self.y_center * sy,
                    self.width * sx, self.height * sy,
                    self.rotation, normalize)

    def points(self):
        """Corner points (tl, tr, br, bl), rotated about the center."""
        x, y = self.x_center, self.y_center
        w, h = self.width / 2.0, self.height / 2.0
        pts = [(x - w, y - h), (x + w, y - h), (x + w, y + h), (x - w, y + h)]
        if self.rotation != 0.0:
            s, c = math.sin(self.rotation), math.cos(self.rotation)
            pts = [(x + (px - x) * c - (py - y) * s,
                    y + (px - x) * s + (py - y) * c) for px, py in pts]
        return pts


@dataclass(frozen=True)
class BBox:
    """Axis-aligned box. Mirrors reference types.rs:99-174 (including the
    heuristic ``normalized()`` check that ignores ymax)."""

    xmin: float
    ymin: float
    xmax: float
    ymax: float

    def as_tuple(self):
        return (self.xmin, self.ymin, self.xmax, self.ymax)

    @property
    def width(self) -> float:
        return self.xmax - self.xmin

    @property
    def height(self) -> float:
        return self.ymax - self.ymin

    @property
    def empty(self) -> bool:
        return self.width <= 0 or self.height <= 0

    @property
    def normalized(self) -> bool:
        return self.xmin >= -1 and self.xmax < 2 and self.ymin >= -1

    @property
    def area(self) -> float:
        return 0.0 if self.empty else self.width * self.height

    def intersect(self, other: "BBox") -> Optional["BBox"]:
        xmin, ymin = max(self.xmin, other.xmin), max(self.ymin, other.ymin)
        xmax, ymax = min(self.xmax, other.xmax), min(self.ymax, other.ymax)
        if xmin < xmax and ymin < ymax:
            return BBox(xmin, ymin, xmax, ymax)
        return None

    def scale(self, size: Tuple[float, float]) -> "BBox":
        sx, sy = size
        return BBox(self.xmin * sx, self.ymin * sy,
                    self.xmax * sx, self.ymax * sy)

    def absolute(self, size: Tuple[int, int]) -> "BBox":
        if not self.normalized:
            return self
        return self.scale((float(size[0]), float(size[1])))


@dataclass(frozen=True)
class Landmark:
    """3d landmark point (reference types.rs:176-187)."""

    x: float
    y: float
    z: float = 0.0


class Detection:
    """Detection result: data of shape [2 + K, 2] plus a score.

    Row 0 = (xmin, ymin), row 1 = (xmax, ymax), rows 2.. = keypoints.
    Mirrors reference types.rs:189-246.
    """

    def __init__(self, data, score: float):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            assert data.size >= 4, "need at least a bounding box"
            data = data.reshape(-1, 2)
        self.data = data
        self.score = float(score)

    @property
    def keypoint_count(self) -> int:
        return self.data.shape[0] - 2

    def keypoint(self, key: int) -> Tuple[float, float]:
        row = self.data[key + 2]
        return (float(row[0]), float(row[1]))

    def bbox(self) -> BBox:
        return BBox(float(self.data[0, 0]), float(self.data[0, 1]),
                    float(self.data[1, 0]), float(self.data[1, 1]))

    def scaled(self, factor: float) -> "Detection":
        return Detection(self.data * factor, self.score)

    def scaled_by_image_size(self, image_size: Tuple[int, int]
                             ) -> "Detection":
        scale = np.array([[image_size[0], image_size[1]]], dtype=np.float32)
        return Detection(self.data * scale, self.score)

    def __repr__(self):
        b = self.bbox()
        return (f"Detection(score={self.score:.4f}, "
                f"bbox=({b.xmin:.4f},{b.ymin:.4f})-({b.xmax:.4f},"
                f"{b.ymax:.4f}), keypoints={self.keypoint_count})")
