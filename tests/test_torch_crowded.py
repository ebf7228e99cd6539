"""Crowded scenes on tpu_face_torch (the cases of tests/test_crowded_nms.py,
on the repository's own frames):

* ``ops.postprocess.weighted_nms`` on a 300-candidate pool (more than
  any other port test gives it) against the sequential reference loop
  ``test_postprocess.oracle_weighted_nms``: the same count, every merged
  box within 2e-5 and every score within 1e-6, as the JAX test holds
  ``tpu_face``'s;
* ``FaceCascade(FULL_SPARSE, max_faces=8, nms_top_m=2304,
  warp_method="gather")`` on twelve copies of ``man_rotp15.png``'s face
  on a 3x4 grid (a 630x840 canvas) against ``tpu_face``'s cascade on the
  same canvas: eight valid faces in eight distinct cells, each nose
  inside its face's box, within the cascade contract
  (tests/test_torch_cascade.py: 0.25 px, 1e-3 rad, 1e-3).
"""

import numpy as np
import pytest

from test_postprocess import oracle_weighted_nms
from test_rotation_e2e import ROT
from test_torch_cascade import _compare
from test_torch_threads import share_cores  # noqa: F401
from tpu_face.models import FaceDetectionModel as JaxModel
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch.models import FaceDetectionModel
from tpu_face_torch.ops import postprocess as post
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

ROWS, COLS = 3, 4


@pytest.fixture(scope="module")
def face_grid():
    """Twelve copies of man_rotp15.png's face (rows 40:250, columns
    150:360) tiled 3x4 on one 630x840 canvas."""
    crop = load_image(ROT / "man_rotp15.png")[40:250, 150:360]
    return np.tile(crop, (ROWS, COLS, 1))


def test_weighted_nms_300_candidates():
    import torch

    rng = np.random.default_rng(11)
    n = 300
    centers = rng.uniform(0.1, 0.9, (n, 2))
    sizes = rng.uniform(0.04, 0.12, (n, 2))
    data = np.zeros((n, 3, 2), np.float32)
    data[:, 0] = centers - sizes / 2
    data[:, 1] = centers + sizes / 2
    data[:, 2] = centers
    scores = rng.uniform(0.55, 1.0, n).astype(np.float32)

    want = oracle_weighted_nms(data.astype(np.float64), scores, 0.3, 0.5)
    got_d, got_s, got_v = (t.numpy() for t in post.weighted_nms(
        torch.from_numpy(data), torch.from_numpy(scores),
        torch.ones(n, dtype=torch.bool), max_outputs=n))
    assert int(got_v.sum()) == len(want) > 100
    assert not got_v[len(want):].any()
    for k, (wd, ws) in enumerate(want):
        np.testing.assert_allclose(got_d[k], wd, atol=2e-5)
        np.testing.assert_allclose(got_s[k], ws, atol=1e-6)


def test_cascade_max_faces_8_on_grid(face_grid):
    kw = dict(max_faces=8, nms_top_m=2304, warp_method="gather")
    res = FaceCascade(FaceDetectionModel.FULL_SPARSE, device="cpu",
                      **kw).infer_batch(face_grid[None])
    ref = JaxFaceCascade(JaxModel.FULL_SPARSE, **kw).infer_batch(
        face_grid[None])
    h, w = face_grid.shape[:2]
    assert bool(res.face_valid.all()) and bool(res.mesh_valid.all())
    _compare(res, ref, (w, h))
    mesh, det = res.mesh[0].numpy(), res.detection[0].numpy()
    cells = set()
    for i in range(8):
        nose = mesh[i, 1]
        cells.add((int(nose[1] * ROWS), int(nose[0] * COLS)))
        assert det[i, 0, 0] <= nose[0] <= det[i, 1, 0]
        assert det[i, 0, 1] <= nose[1] <= det[i, 1, 1]
    assert len(cells) == 8
