"""The port's copies of tpu_face/types.py and tpu_face/ops/geometry.py
against the originals, on seeded random boxes, ROIs and keypoints.  Both
are numpy code, so the results must be equal (to float64 rounding)."""

import numpy as np
import pytest

from tpu_face import types as jtypes
from tpu_face.ops import geometry as jgeo
from tpu_face_torch import types as ttypes
from tpu_face_torch.ops import geometry as tgeo

SEEDS = [0, 1, 2]
SIZES = [(540, 360), (200, 225), (1920, 1080)]


def _boxes(rng, n=16):
    lo = rng.uniform(-0.2, 0.8, (n, 2))
    hi = lo + rng.uniform(-0.05, 0.6, (n, 2))   # some empty boxes
    return np.concatenate([lo, hi], axis=1)


@pytest.mark.parametrize("seed", SEEDS)
def test_rect_matches(seed):
    rng = np.random.default_rng(seed)
    for cx, cy, w, h, rot in rng.uniform(-1.0, 2.0, (16, 5)):
        for normalized in (True, False):
            a = ttypes.Rect(cx, cy, w * 300, h * 300, rot, normalized)
            b = jtypes.Rect(cx, cy, w * 300, h * 300, rot, normalized)
            assert a.size() == b.size()
            for size in SIZES:
                for norm in (True, False):
                    sa, sb = a.scaled(size, norm), b.scaled(size, norm)
                    assert (sa.x_center, sa.y_center, sa.width, sa.height,
                            sa.rotation, sa.normalized) == \
                        (sb.x_center, sb.y_center, sb.width, sb.height,
                         sb.rotation, sb.normalized)
            np.testing.assert_array_equal(a.points(), b.points())


@pytest.mark.parametrize("seed", SEEDS)
def test_bbox_matches(seed):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng)
    for p, q in zip(boxes, boxes[::-1]):
        a, b = ttypes.BBox(*p), jtypes.BBox(*p)
        oa, ob = ttypes.BBox(*q), jtypes.BBox(*q)
        assert a.as_tuple() == b.as_tuple()
        assert (a.width, a.height, a.empty, a.normalized, a.area) == \
            (b.width, b.height, b.empty, b.normalized, b.area)
        ia, ib = a.intersect(oa), b.intersect(ob)
        assert (ia is None) == (ib is None)
        if ia is not None:
            assert ia.as_tuple() == ib.as_tuple()
        for size in SIZES:
            assert a.scale(size).as_tuple() == b.scale(size).as_tuple()
            assert a.absolute(size).as_tuple() == \
                b.absolute(size).as_tuple()


@pytest.mark.parametrize("seed", SEEDS)
def test_detection_and_landmark_match(seed):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 1.0, (8, 2)).astype(np.float32)
    a = ttypes.Detection(data.reshape(-1), 0.75)
    b = jtypes.Detection(data.reshape(-1), 0.75)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.keypoint_count == b.keypoint_count == 6
    assert [a.keypoint(k) for k in range(6)] == \
        [b.keypoint(k) for k in range(6)]
    assert a.bbox().as_tuple() == b.bbox().as_tuple()
    np.testing.assert_array_equal(a.scaled(2.5).data, b.scaled(2.5).data)
    for size in SIZES:
        np.testing.assert_array_equal(a.scaled_by_image_size(size).data,
                                      b.scaled_by_image_size(size).data)
    assert repr(a) == repr(b)
    assert ttypes.Landmark(1.0, 2.0) == ttypes.Landmark(1.0, 2.0, 0.0)
    it = ttypes.ImageTensor(data, (0.0, 0.1, 0.0, 0.1), (540, 360))
    assert it.original_size == (540, 360) and it.padding[1] == 0.1


@pytest.mark.parametrize("seed", SEEDS)
def test_rotation_and_roi_size_match(seed):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-10.0, 10.0, 32)
    np.testing.assert_array_equal(tgeo.normalize_rotation(angles),
                                  jgeo.normalize_rotation(angles))
    kp = rng.uniform(0.0, 1.0, (32, 4))
    np.testing.assert_array_equal(tgeo.rotation_from_keypoints(*kp.T),
                                  jgeo.rotation_from_keypoints(*kp.T))
    boxes = _boxes(rng)
    for size in SIZES:
        for mode in (tgeo.SIZE_MODE_DEFAULT, tgeo.SIZE_MODE_SQUARE_LONG,
                     tgeo.SIZE_MODE_SQUARE_SHORT):
            np.testing.assert_array_equal(
                tgeo.select_roi_size(*boxes.T, size, mode),
                jgeo.select_roi_size(*boxes.T, size, mode))


@pytest.mark.parametrize("seed", SEEDS)
def test_bbox_to_roi_and_helpers_match(seed):
    rng = np.random.default_rng(seed)
    for box in _boxes(rng):
        kps = tuple(map(tuple, rng.uniform(0.0, 1.0, (2, 2))))
        for size in SIZES:
            for kw in ({}, {"rotation_keypoints": kps, "scale": (1.5, 1.5),
                            "size_mode": tgeo.SIZE_MODE_SQUARE_LONG},
                       {"rotation_keypoints": kps, "scale": (2.3, 2.3),
                        "size_mode": tgeo.SIZE_MODE_SQUARE_SHORT}):
                assert tgeo.bbox_to_roi(*box, size, **kw) == \
                    jgeo.bbox_to_roi(*box, size, **kw)
            roi = tgeo.bbox_to_roi(*box, size)
            np.testing.assert_array_equal(tgeo.roi_to_abs(roi, size),
                                          jgeo.roi_to_abs(roi, size))
            corners = box.reshape(2, 2)
            for t, j in zip(tgeo.crop_roi_from_detection(corners, size),
                            jgeo.crop_roi_from_detection(corners, size)):
                np.testing.assert_array_equal(t, j)
    xs, ys = rng.uniform(0.0, 1.0, (2, 468))
    assert tgeo.bbox_from_landmarks_xy(xs, ys) == \
        jgeo.bbox_from_landmarks_xy(xs, ys)
