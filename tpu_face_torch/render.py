"""Annotation data model + host-side rasterizer (a copy of
tpu_face/render.py: host numpy and Pillow, so the images are the JAX
package's bit for bit).

API parity with the reference render layer (reference: render.rs:6-479).
Rasterization is host-side numpy (the reference uses the ``imageproc``
crate) and deliberately keeps the reference's rendering quirks so golden
images stay comparable:

* ovals are drawn as hollow rectangles — both branches of the oval test
  are identical in the reference (render.rs:446-462, :468-472);
* detection keypoint annotations include the two bbox-corner rows, since
  the reference iterates ALL detection data rows (render.rs:288-298);
* points render as filled squares of half-width ``max(thickness/2, 1)``
  (render.rs:423-433) — the reference's u32 underflow for points within
  ``thickness/2`` of the left/top edge (SURVEY.md §2.2.5) is fixed here
  by clipping to the image instead of wrapping.
"""

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class Color:
    """RGB color with optional alpha (reference render.rs:6-27)."""

    r: int = 0
    g: int = 0
    b: int = 0
    a: Optional[int] = None

    def as_tuple(self):
        return (self.r, self.g, self.b, self.a)

    @property
    def rgba(self) -> Tuple[int, int, int, int]:
        return (self.r, self.g, self.b, 255 if self.a is None else self.a)


class Colors:
    """Default palette (reference render.rs:29-68)."""

    BLACK = Color(0, 0, 0)
    RED = Color(255, 0, 0)
    GREEN = Color(0, 255, 0)
    BLUE = Color(0, 0, 255)
    PINK = Color(255, 0, 255)
    WHITE = Color(255, 255, 255)


@dataclass(frozen=True)
class Point:
    """2d point (reference render.rs:70-92)."""

    x: float
    y: float

    def as_tuple(self):
        return (self.x, self.y)

    def scaled(self, factor: Tuple[float, float]) -> "Point":
        return Point(self.x * factor[0], self.y * factor[1])


@dataclass(frozen=True)
class RectOrOval:
    """Rectangle or oval between corners (reference render.rs:94-128)."""

    left: float
    top: float
    right: float
    bottom: float
    oval: bool = False

    def as_tuple(self):
        return (self.left, self.top, self.right, self.bottom)

    def scaled(self, factor: Tuple[float, float]) -> "RectOrOval":
        sx, sy = factor
        return RectOrOval(self.left * sx, self.top * sy,
                          self.right * sx, self.bottom * sy, self.oval)


@dataclass(frozen=True)
class FilledRectOrOval:
    """Filled rect/oval (reference render.rs:130-147)."""

    rect: RectOrOval
    fill: Color

    def scaled(self, factor: Tuple[float, float]) -> "FilledRectOrOval":
        return FilledRectOrOval(self.rect.scaled(factor), self.fill)


@dataclass(frozen=True)
class Line:
    """Line segment (reference render.rs:149-184)."""

    x_start: float
    y_start: float
    x_end: float
    y_end: float
    dashed: bool = False

    def as_tuple(self):
        return (self.x_start, self.y_start, self.x_end, self.y_end)

    def scaled(self, factor: Tuple[float, float]) -> "Line":
        sx, sy = factor
        return Line(self.x_start * sx, self.y_start * sy,
                    self.x_end * sx, self.y_end * sy, self.dashed)


AnnotationData = Union[Point, RectOrOval, FilledRectOrOval, Line]


@dataclass
class Annotation:
    """A group of drawables sharing thickness/color
    (reference render.rs:207-244)."""

    data: List[AnnotationData]
    normalized_positions: bool
    thickness: float
    color: Color

    def scaled(self, factor: Tuple[float, float]) -> "Annotation":
        if not self.normalized_positions:
            raise ValueError("position data must be normalized")
        return Annotation([d.scaled(factor) for d in self.data],
                          False, self.thickness, self.color)


def detections_to_render_data(
        detections: Sequence,
        bounds_color: Optional[Color] = None,
        keypoint_color: Optional[Color] = None,
        line_width: int = 1,
        point_width: int = 3,
        normalized_positions: bool = True,
        output: Optional[List[Annotation]] = None) -> List[Annotation]:
    """MediaPipe DetectionToRenderDataCalculator with keypoints
    (reference render.rs:262-313).  Note the keypoint annotation
    includes every detection data row — bbox corners too — matching the
    reference's row iteration."""
    annotations: List[Annotation] = []
    if bounds_color is not None and line_width > 0:
        bounds = [RectOrOval(d.bbox().xmin, d.bbox().ymin,
                             d.bbox().xmax, d.bbox().ymax, False)
                  for d in detections]
        annotations.append(Annotation(bounds, normalized_positions,
                                      float(line_width), bounds_color))
    if keypoint_color is not None and point_width > 0:
        points = [Point(float(row[0]), float(row[1]))
                  for d in detections for row in np.asarray(d.data)]
        annotations.append(Annotation(points, normalized_positions,
                                      float(point_width), keypoint_color))
    out = output if output is not None else []
    out.extend(annotations)
    return out


def landmarks_to_render_data(
        landmarks: Sequence,
        landmark_connections: Sequence[Tuple[int, int]],
        landmark_color: Color = Colors.RED,
        connection_color: Color = Colors.RED,
        thickness: float = 1.0,
        normalized_positions: bool = True,
        output: Optional[List[Annotation]] = None) -> List[Annotation]:
    """Connection lines + landmark points
    (reference render.rs:315-359)."""
    lines = [Line(landmarks[s].x, landmarks[s].y,
                  landmarks[e].x, landmarks[e].y, False)
             for s, e in landmark_connections]
    points = [Point(lmk.x, lmk.y) for lmk in landmarks]
    line_annotation = Annotation(lines, normalized_positions,
                                 float(thickness), connection_color)
    point_annotation = Annotation(points, normalized_positions,
                                  float(thickness), landmark_color)
    if output is not None:
        output.append(line_annotation)
        output.append(point_annotation)
        return output
    return [line_annotation, point_annotation]


# ---- rasterizer --------------------------------------------------------


def _draw_filled_rect(buf: np.ndarray, x0: int, y0: int, x1: int, y1: int,
                      rgba) -> None:
    h, w = buf.shape[:2]
    x0c, y0c = max(x0, 0), max(y0, 0)
    x1c, y1c = min(x1, w), min(y1, h)
    if x0c < x1c and y0c < y1c:
        buf[y0c:y1c, x0c:x1c] = rgba


def _draw_hollow_rect(buf: np.ndarray, x0: int, y0: int, x1: int, y1: int,
                      rgba) -> None:
    """1-px hollow rectangle spanning x0..x1-1, y0..y1-1 (imageproc
    ``Rect::at(x0, y0).of_size(x1-x0, y1-y0)`` covers x0..x0+w-1)."""
    _draw_filled_rect(buf, x0, y0, x1, y0 + 1, rgba)
    _draw_filled_rect(buf, x0, y1 - 1, x1, y1, rgba)
    _draw_filled_rect(buf, x0, y0, x0 + 1, y1, rgba)
    _draw_filled_rect(buf, x1 - 1, y0, x1, y1, rgba)


def _draw_line(buf: np.ndarray, x0: float, y0: float, x1: float, y1: float,
               rgba) -> None:
    """Bresenham-style segment (imageproc draw_line_segment)."""
    h, w = buf.shape[:2]
    steps = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, steps)).astype(np.int64)
    ys = np.rint(np.linspace(y0, y1, steps)).astype(np.int64)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    buf[ys[ok], xs[ok]] = rgba


def render_to_image(annotations: Sequence[Annotation], image,
                    blend_mode: bool = False):
    """Draw annotations onto an image; returns a PIL RGBA image
    (reference render.rs:361-479).  Normalized annotations are scaled by
    the image dimensions."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        pil = Image.fromarray(image)
    else:
        pil = image
    buf = np.array(pil.convert("RGBA"))
    h, w = buf.shape[:2]

    for annotation in annotations:
        scaled = (annotation.scaled((float(w), float(h)))
                  if annotation.normalized_positions else annotation)
        thickness = int(scaled.thickness)
        rgba = np.array(scaled.color.rgba, dtype=np.uint8)
        for item in scaled.data:
            if isinstance(item, Point):
                # reference: rect at (x-w, y-w) of size (2w, 2w)
                # -> spans x-w .. x+w-1 (render.rs:423-433)
                half = max(thickness // 2, 1)
                x, y = int(item.x), int(item.y)
                _draw_filled_rect(buf, x - half, y - half,
                                  x + half, y + half, rgba)
                continue
            elif isinstance(item, Line):
                _draw_line(buf, int(item.x_start), int(item.y_start),
                           int(item.x_end), int(item.y_end), rgba)
            elif isinstance(item, RectOrOval):
                # oval branch == rect branch, reference quirk kept
                _draw_hollow_rect(buf, int(item.left), int(item.top),
                                  int(item.right), int(item.bottom), rgba)
            elif isinstance(item, FilledRectOrOval):
                r = item.rect
                _draw_filled_rect(buf, int(r.left), int(r.top),
                                  int(r.right), int(r.bottom),
                                  np.array(item.fill.rgba, dtype=np.uint8))
    return Image.fromarray(buf)
