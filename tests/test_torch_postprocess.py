"""tpu_face_torch.ops.postprocess (and the SSD anchors) against
tpu_face.ops.postprocess on the same numpy inputs.

The port runs each function once over a leading batch; the JAX package
runs it per frame.  Tolerances: max abs 1e-6 on normalized coordinates
and scores (f32 in the same operation order; the weighted average's sum
order may differ by an ulp), exact on indices and bools.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import share_cores  # noqa: F401
from tpu_face.ops import anchors as janchors
from tpu_face.ops import postprocess as jpost
from tpu_face_torch.ops import anchors as tanchors
from tpu_face_torch.ops import postprocess as tpost

TOL = 1e-6


def test_anchors_match():
    for opts in ("front", "back", "short", "full"):
        got = tanchors.ssd_generate_anchors(
            getattr(tanchors.SSDOptions, opts)())
        want = janchors.ssd_generate_anchors(
            getattr(janchors.SSDOptions, opts)())
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def anchors():
    return janchors.ssd_generate_anchors(janchors.SSDOptions.back())


def _raw(rng, b, n=896):
    return rng.normal(0.0, 20.0, (b, n, 16)).astype(np.float32)


def test_decode_boxes(anchors):
    raw = _raw(np.random.default_rng(0), 3)
    got = tpost.decode_boxes(torch.from_numpy(raw),
                             torch.from_numpy(anchors), 256.0)
    assert tuple(got.shape) == (3, 896, 8, 2)
    for i in range(3):
        want = jpost.decode_boxes(jnp.asarray(raw[i]), jnp.asarray(anchors),
                                  256.0)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=TOL)


def test_clamped_sigmoid_and_validity(anchors):
    rng = np.random.default_rng(1)
    s = np.concatenate([rng.normal(0, 5, 200), [-200.0, 200.0, 0.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(
        tpost.clamped_sigmoid(torch.from_numpy(s)).numpy(),
        np.asarray(jpost.clamped_sigmoid(jnp.asarray(s))), rtol=0, atol=TOL)
    boxes = rng.uniform(0, 1, (203, 8, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, 203).astype(np.float32)
    np.testing.assert_array_equal(
        tpost.detection_validity(torch.from_numpy(boxes),
                                 torch.from_numpy(scores)).numpy(),
        np.asarray(jpost.detection_validity(jnp.asarray(boxes),
                                            jnp.asarray(scores))))


def _candidates(rng, b, n=64):
    """Clustered boxes (so IoU merges happen) with random scores."""
    centre = rng.uniform(0.3, 0.7, (b, 1, 1, 2))
    pts = centre + rng.normal(0, 0.03, (b, n, 8, 2))
    size = rng.uniform(0.1, 0.3, (b, n, 1, 2))
    pts[:, :, 1] = pts[:, :, 0] + size[:, :, 0]
    scores = rng.uniform(0, 1, (b, n))
    return pts.astype(np.float32), scores.astype(np.float32)


def _nms_both(data, scores, valid):
    got = tpost.weighted_nms(torch.from_numpy(data),
                             torch.from_numpy(scores),
                             torch.from_numpy(valid), max_outputs=1)
    for i in range(data.shape[0]):
        want = jpost.weighted_nms(jnp.asarray(data[i]),
                                  jnp.asarray(scores[i]),
                                  jnp.asarray(valid[i]), max_outputs=1)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=TOL)
        np.testing.assert_array_equal(got[1][i].numpy(),
                                      np.asarray(want[1]))
        np.testing.assert_array_equal(got[2][i].numpy(),
                                      np.asarray(want[2]))
    return got


def test_weighted_nms_top1():
    rng = np.random.default_rng(2)
    data, scores = _candidates(rng, 4)
    valid = scores > 0.3
    d, s, v = _nms_both(data, scores, valid)
    assert tuple(d.shape) == (4, 1, 8, 2) and tuple(s.shape) == (4, 1)
    assert v.all()


def test_weighted_nms_no_valid_candidate():
    rng = np.random.default_rng(3)
    data, scores = _candidates(rng, 2)
    _, _, v = _nms_both(data, scores, np.zeros_like(scores, bool))
    assert not v.any()


def test_weighted_nms_tied_top_scores():
    """Equal top scores: the first index wins (argmax tie-break), as in
    the reference's stable descending sort."""
    rng = np.random.default_rng(4)
    data, scores = _candidates(rng, 2)
    scores *= 0.9
    scores[:, [5, 9, 30]] = 0.99
    data[:, 30] += 0.5                     # a far-away tied box
    _, s, _ = _nms_both(data, scores, scores > 0.5)
    assert (s.numpy() == np.float32(0.99)).all()


def test_weighted_nms_more_outputs_not_ported():
    """More than one output is ported now (tests/test_torch_multiface.py
    holds it against JAX): an empty pool gives K invalid outputs, and
    zero outputs are refused."""
    d, s, v = tpost.weighted_nms(torch.zeros(4, 8, 2), torch.zeros(4),
                                 torch.zeros(4, dtype=torch.bool),
                                 max_outputs=2)
    assert tuple(d.shape) == (2, 8, 2) and tuple(s.shape) == (2,)
    assert not v.any()
    with pytest.raises(ValueError):
        tpost.weighted_nms(torch.zeros(4, 8, 2), torch.zeros(4),
                           torch.zeros(4, dtype=torch.bool), max_outputs=0)


def test_letterbox_removal():
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 1, (3, 1, 8, 2)).astype(np.float32)
    pad = np.array([0.0, 1.0 / 6.0, 0.0, 1.0 / 6.0], np.float32)
    got = tpost.letterbox_removal(torch.from_numpy(data),
                                  torch.from_numpy(pad))
    for i in range(3):
        want = jpost.letterbox_removal(jnp.asarray(data[i]),
                                       jnp.asarray(pad))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("with_roi", [False, True])
def test_project_landmarks(flip, with_roi):
    rng = np.random.default_rng(6)
    raw = rng.uniform(0, 64, (3, 71 * 3)).astype(np.float32)
    pads = rng.uniform(0, 0.1, (3, 4)).astype(np.float32)
    rois = np.stack([rng.uniform(100, 400, 3), rng.uniform(100, 300, 3),
                     rng.uniform(20, 80, 3), rng.uniform(20, 80, 3),
                     rng.uniform(-0.8, 0.8, 3)], -1).astype(np.float32)
    got = tpost.project_landmarks(
        torch.from_numpy(raw), (64, 64), (540, 360), torch.from_numpy(pads),
        torch.from_numpy(rois) if with_roi else None, flip_horizontal=flip)
    assert tuple(got.shape) == (3, 71, 3)
    for i in range(3):
        want = jpost.project_landmarks(
            jnp.asarray(raw[i]), (64, 64), (540, 360), jnp.asarray(pads[i]),
            jnp.asarray(rois[i]) if with_roi else None,
            flip_horizontal=flip)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=TOL)


def test_project_landmarks_per_frame_flip_tensor():
    rng = np.random.default_rng(7)
    raw = torch.from_numpy(rng.uniform(0, 64, (2, 15)).astype(np.float32))
    pads = torch.zeros(2, 4)
    flip = torch.tensor([True, False])
    got = tpost.project_landmarks(raw, (64, 64), (540, 360), pads, None,
                                  flip_horizontal=flip)
    for i in range(2):
        want = tpost.project_landmarks(raw[i], (64, 64), (540, 360),
                                       pads[i], None,
                                       flip_horizontal=bool(flip[i]))
        torch.testing.assert_close(got[i], want, rtol=0, atol=0)
