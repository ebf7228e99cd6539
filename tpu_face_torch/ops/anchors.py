"""SSD anchor generation (MediaPipe ssd_anchors_calculator).

Pure numpy, executed once at model construction
(reference: face_detection.rs:366-413; options structs :28-86).
Verified counts: front/short/back -> 896 anchors, full/full_sparse -> 2304.
"""

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class SSDOptions:
    num_layers: int
    input_size_height: int
    input_size_width: int
    anchor_offset_x: float
    anchor_offset_y: float
    strides: Tuple[int, ...]
    interpolated_scale_aspect_ratio: float

    @staticmethod
    def front() -> "SSDOptions":
        return SSDOptions(4, 128, 128, 0.5, 0.5, (8, 16, 16, 16), 1.0)

    @staticmethod
    def back() -> "SSDOptions":
        return SSDOptions(4, 256, 256, 0.5, 0.5, (16, 32, 32, 32), 1.0)

    @staticmethod
    def short() -> "SSDOptions":
        return SSDOptions(4, 128, 128, 0.5, 0.5, (8, 16, 16, 16), 1.0)

    @staticmethod
    def full() -> "SSDOptions":
        return SSDOptions(1, 192, 192, 0.5, 0.5, (4, 0, 0, 0), 0.0)


def ssd_generate_anchors(opts: SSDOptions) -> np.ndarray:
    """Return anchors [N, 2] of normalized (x_center, y_center)."""
    anchors: List[Tuple[float, float]] = []
    layer_id = 0
    while layer_id < opts.num_layers:
        last_same_stride_layer = layer_id
        repeats = 0
        while (last_same_stride_layer < opts.num_layers
               and opts.strides[last_same_stride_layer]
               == opts.strides[layer_id]):
            last_same_stride_layer += 1
            repeats += 2 if opts.interpolated_scale_aspect_ratio == 1.0 else 1
        stride = opts.strides[layer_id]
        fm_h = opts.input_size_height // stride
        fm_w = opts.input_size_width // stride
        for y in range(fm_h):
            y_center = (y + opts.anchor_offset_y) / fm_h
            for x in range(fm_w):
                x_center = (x + opts.anchor_offset_x) / fm_w
                anchors.extend([(x_center, y_center)] * repeats)
        layer_id = last_same_stride_layer
    return np.asarray(anchors, dtype=np.float32)
