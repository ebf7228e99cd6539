"""The K-face path of tpu_face_torch on the CPU against the JAX package.

* ``ops.postprocess.weighted_nms`` for K = 2, 4 and 8 against
  ``tpu_face.ops.postprocess.weighted_nms`` (its full-pool scan) on random
  pools: clustered boxes, tied top scores, zero-area boxes (which stop
  the loop through the sticky ``stopped`` flag) and fewer valid
  candidates than K.  Max abs 1e-6 on coordinates and scores (f32 in the
  same operation order; the weighted sum's order may differ by an ulp),
  exact on bools.
* ``pipeline.FaceCascade(max_faces=K)`` against
  ``tpu_face.pipeline.FaceCascade(warp_method="gather", max_faces=K)``
  on chip_smoke.py's canvases: (b) two faces on 1280x824 (bf16 planes,
  the strip kernel's tier; K=2, and K=4 with two dead slots) and (c) the
  four rotated 540p frames as a 2x2 grid on 1080x720 (f32 planes, the
  resident kernel's tier; K=4).  Every bool equal in every slot; valid
  slots within test_torch_cascade.py's 0.25 px, 1e-3 rad and 1e-3.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_cascade import _compare
from test_torch_threads import share_cores  # noqa: F401
from tpu_face.ops import postprocess as jpost
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch.ops import postprocess as tpost
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

TOL = 1e-6


def _pool(case, rng, b=3, n=96):
    """Candidate pools [b, n, 8, 2] with scores and validity: a few
    clusters of overlapping boxes (so merges happen), then the case's
    twist."""
    centres = rng.uniform(0.15, 0.85, (b, 5, 1, 2))
    which = rng.integers(0, 5, (b, n))
    pts = (np.take_along_axis(centres, which[:, :, None, None], 1)
           + rng.normal(0, 0.02, (b, n, 8, 2)))
    size = rng.uniform(0.08, 0.15, (b, n, 1, 2))
    pts[:, :, 1] = pts[:, :, 0] + size[:, :, 0]
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = scores > 0.4
    if case == "ties":
        scores[:, [3, 17, 40]] = 0.995           # tied top scores
        scores[:, [5, 6]] = 0.9                  # and a tied second rank
        valid[:, [3, 5, 6, 17, 40]] = True
    elif case == "zero_area":
        # high-scoring boxes of zero width: once one is on top its merge
        # set is empty, which stops the loop for good
        np.minimum(scores, 0.95, out=scores)
        for i, j in enumerate((2, 7, 11)):
            pts[i, j, 1, 0] = pts[i, j, 0, 0]
            scores[i, j] = 0.99 - 0.01 * i
            valid[i, j] = True
    elif case == "few_valid":
        valid[:] = False
        valid[0, [1, 2]] = True                  # 2 candidates
        valid[1, 9] = True                       # 1 candidate, then none
    return pts.astype(np.float32), scores, valid


@lru_cache(maxsize=None)
def _jax_nms(k):
    """JAX's weighted NMS with K outputs, per frame of a batch, compiled
    once per K."""
    return jax.jit(jax.vmap(partial(jpost.weighted_nms, max_outputs=k)))


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("case", ["clusters", "ties", "zero_area",
                                  "few_valid"])
def test_weighted_nms_matches_jax_scan(case, k):
    rng = np.random.default_rng(k * 31 + len(case))
    data, scores, valid = _pool(case, rng)
    got = tpost.weighted_nms(torch.from_numpy(data),
                             torch.from_numpy(scores),
                             torch.from_numpy(valid), max_outputs=k)
    assert tuple(got[0].shape) == (3, k, 8, 2)
    assert tuple(got[1].shape) == tuple(got[2].shape) == (3, k)
    want = _jax_nms(k)(jnp.asarray(data), jnp.asarray(scores),
                       jnp.asarray(valid))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=TOL)
    if case == "zero_area":
        # the zero-area top stopped every frame after its first output
        assert not got[2][:, 1:].any()
    if case == "few_valid":
        n = got[2].sum(-1).tolist()
        assert n[0] in (1, 2) and n[1:] == [1, 0], n


def test_weighted_nms_first_output_matches_top1():
    """The loop's first output is the single-merge path's output."""
    rng = np.random.default_rng(9)
    data, scores, valid = (torch.from_numpy(a)
                           for a in _pool("clusters", rng))
    one = tpost.weighted_nms(data, scores, valid, max_outputs=1)
    four = tpost.weighted_nms(data, scores, valid, max_outputs=4)
    for a, b in zip(one, four):
        torch.testing.assert_close(a, b[:, :1], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def canvases():
    return {"b": chip_smoke.canvas_two_faces(load_image),
            "c": chip_smoke.canvas_grid(load_image)}


@pytest.mark.parametrize("canvas, k, n_valid", [("b", 2, 2), ("b", 4, 2),
                                                ("c", 4, 4)])
def test_cascade_matches_jax_gather(canvases, canvas, k, n_valid):
    img = canvases[canvas][None]
    h, w = img.shape[1:3]
    res = FaceCascade(device="cpu", max_faces=k).infer_batch(img)
    assert tuple(res.mesh.shape) == (1, k, 468, 3)
    assert int(res.mesh_valid.sum()) == n_valid
    assert bool(res.mesh_valid[0, :n_valid].all())
    ref = JaxFaceCascade(warp_method="gather", max_faces=k).infer_batch(img)
    _compare(res, ref, (w, h))


def test_faces_of_a_frame_do_not_depend_on_batch(canvases):
    """Two copies of canvas (c) in one batch, the second mirrored: each
    frame's faces are its own (the [B, K*P] warp layout maps every row to
    its frame's planes)."""
    img = canvases["c"]
    batch = np.stack([img, img[:, ::-1]])
    cascade = FaceCascade(device="cpu", max_faces=4)
    res = cascade.infer_batch(batch)
    for i in range(2):
        one = cascade.infer_batch(batch[i])
        for f in res._fields:
            a, b = getattr(res, f)[i], getattr(one, f)[0]
            if a.dtype == torch.bool:
                assert torch.equal(a, b), (i, f)
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
