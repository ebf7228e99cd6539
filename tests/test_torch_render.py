"""tpu_face_torch.render and the models' render-data helpers, against
tpu_face's.

Rendering is host numpy and Pillow in both packages, so the same
annotations must give bit-identical RGBA images: detections (bounds and
every data row as a keypoint), the face mesh with its connections, both
eye contours, the iris keypoints with the iris "oval" (a hollow rect, the
reference's quirk), filled rects, lines and points at and past the frame
edge (clipped, not wrapped), absolute and normalized positions.  The
helpers (``detections_to_render_data``, ``landmarks_to_render_data``,
``face_landmarks_to_render_data``, ``eye_landmarks_to_render_data``,
``iris_landmarks_to_render_data``) give equal annotations.
"""

import dataclasses

import numpy as np
import pytest

from test_rotation_e2e import ROT
from tpu_face import models as jmodels
from tpu_face import render as jrender
from tpu_face import types as jtypes
from tpu_face_torch import models as tmodels
from tpu_face_torch import render as trender
from tpu_face_torch import types as ttypes
from tpu_face_torch.utils.image_io import load_image

PACKAGES = {"jax": (jrender, jmodels, jtypes),
            "torch": (trender, tmodels, ttypes)}


@pytest.fixture(scope="module")
def image():
    return load_image(ROT / "man_rotp15.png")


@pytest.fixture(scope="module")
def points():
    """Seeded normalized landmarks: a 468-point mesh (a few past the
    edges), a 71-point eye contour and 5 iris points."""
    rng = np.random.default_rng(5)
    mesh = rng.uniform(-0.02, 1.02, (468, 3))
    eye = rng.uniform(0.3, 0.5, (71, 3))
    iris = np.array([[0.4, 0.35, 0.0], [0.42, 0.35, 0.0],
                     [0.4, 0.33, 0.0], [0.38, 0.35, 0.0],
                     [0.4, 0.37, 0.0]])
    det = np.array([[0.34, 0.22], [0.59, 0.59], [0.4, 0.34], [0.5, 0.3],
                    [0.47, 0.41], [0.49, 0.49], [0.36, 0.41],
                    [0.0, 0.999]], np.float32)
    return mesh, eye, iris, det


def _annotations(pkg, points):
    render, models, types = PACKAGES[pkg]
    mesh, eye, iris, det = points
    lm = lambda rows: [types.Landmark(*map(float, r))  # noqa: E731
                       for r in rows]
    detection = types.Detection(det, 0.9)
    anns = render.detections_to_render_data(
        [detection], bounds_color=render.Colors.GREEN,
        keypoint_color=render.Colors.PINK, line_width=4, point_width=3)
    anns = models.face_landmarks_to_render_data(
        lm(mesh), render.Colors.RED, render.Colors.RED, output=anns)
    anns = models.eye_landmarks_to_render_data(
        lm(eye), render.Colors.BLUE, render.Colors.BLUE, output=anns)
    anns = models.iris_landmarks_to_render_data(
        lm(iris), landmark_color=render.Colors.WHITE,
        oval_color=render.Color(10, 200, 30, 128), image_size=(540, 360),
        output=anns)
    anns.append(render.Annotation(
        [render.FilledRectOrOval(render.RectOrOval(500.0, 300.0, 560.0,
                                                   380.0),
                                 render.Color(1, 2, 3)),
         render.Line(-20.0, 10.0, 600.0, 350.0, dashed=True),
         render.Point(0.0, 0.0), render.Point(539.0, 359.0),
         render.RectOrOval(100.0, 100.0, 140.0, 130.0, oval=True)],
        False, 5.0, render.Colors.BLACK))
    return anns


def _plain(annotations):
    """Annotations as nested tuples of class names and field values."""
    def item(x):
        if dataclasses.is_dataclass(x):
            return (type(x).__name__,) + tuple(
                item(getattr(x, f.name)) for f in dataclasses.fields(x))
        if isinstance(x, list):
            return tuple(item(v) for v in x)
        return x
    return item(annotations)


def test_helpers_give_equal_annotations(points):
    assert _plain(_annotations("torch", points)) == _plain(
        _annotations("jax", points))


@pytest.mark.parametrize("as_pil", [False, True])
def test_render_is_bit_identical(image, points, as_pil):
    from PIL import Image

    outs = {}
    for pkg in PACKAGES:
        src = Image.fromarray(image) if as_pil else image
        out = PACKAGES[pkg][0].render_to_image(_annotations(pkg, points),
                                               src)
        assert out.mode == "RGBA"
        outs[pkg] = np.asarray(out)
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    # something was drawn, and the frame outside the drawing is intact
    changed = (outs["torch"][..., :3] != image).any(-1)
    assert 0.001 < changed.mean() < 0.5


def test_iris_oval_needs_an_image_size(points):
    _, _, iris, _ = points
    lmks = [ttypes.Landmark(*map(float, r)) for r in iris]
    with pytest.raises(ValueError, match="image_size"):
        tmodels.iris_landmarks_to_render_data(
            lmks, oval_color=trender.Colors.RED)


def test_palette_and_scaling_match():
    for name in ("BLACK", "RED", "GREEN", "BLUE", "PINK", "WHITE"):
        assert getattr(trender.Colors, name).rgba == getattr(
            jrender.Colors, name).rgba
    t = trender.Annotation([trender.Point(0.5, 0.25)], True, 2.0,
                           trender.Colors.RED).scaled((540.0, 360.0))
    j = jrender.Annotation([jrender.Point(0.5, 0.25)], True, 2.0,
                           jrender.Colors.RED).scaled((540.0, 360.0))
    assert _plain([t]) == _plain([j])
    with pytest.raises(ValueError, match="normalized"):
        t.scaled((2.0, 2.0))
