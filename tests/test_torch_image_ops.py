"""tpu_face_torch.ops.image against tpu_face.ops.image on the same
numpy inputs.

Tolerances:
* coordinates (``_source_coords``, letterbox pads, derivatives):
  <= 1e-4 px absolute — f32 arithmetic in the same order; the only
  differences are the sin/cos of the two libraries (an ulp or so);
* sampled pixels (0-255 units, before rounding): <= 1e-3 — the hat
  matmuls and the gather compute the same two-tap sums;
* ``_normalize_pixels``: exact, including round-half-to-even ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_face.ops import image as jimage
from tpu_face_torch.ops import image as timage

COORD_TOL = 1e-4
PIX_TOL = 1e-3


def _rois(rng, n, w, h):
    """Random rotated ROIs (±45 deg) over a w x h frame, some reaching
    past the edges."""
    side = rng.uniform(20.0, 0.8 * min(w, h), n)
    return np.stack([rng.uniform(-0.1 * w, 1.1 * w, n),
                     rng.uniform(-0.1 * h, 1.1 * h, n),
                     side, side * rng.uniform(0.7, 1.4, n),
                     rng.uniform(-np.pi / 4, np.pi / 4, n)],
                    -1).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("keep_aspect", [False, True])
@pytest.mark.parametrize("out_size", [(192, 192), (64, 64)])
def test_source_coords(keep_aspect, flip, out_size):
    rng = np.random.default_rng(int(keep_aspect) * 2 + int(flip))
    rois = _rois(rng, 6, 540, 360)
    tx, ty, tp = timage._source_coords(torch.from_numpy(rois), out_size,
                                       keep_aspect, flip)
    assert tuple(tx.shape) == (6, out_size[1], out_size[0])
    for i, roi in enumerate(rois):
        jx, jy, jp = jimage._source_coords(jnp.asarray(roi), out_size,
                                           keep_aspect, flip)
        np.testing.assert_allclose(tx[i].numpy(), jx, rtol=0,
                                   atol=COORD_TOL)
        np.testing.assert_allclose(ty[i].numpy(), jy, rtol=0,
                                   atol=COORD_TOL)
        np.testing.assert_allclose(tp[i].numpy(), jp, rtol=0, atol=1e-7)


def test_source_coords_per_frame_flip():
    """A bool tensor flips frame by frame (left eye, mirrored right)."""
    rng = np.random.default_rng(7)
    rois = torch.from_numpy(_rois(rng, 2, 540, 360))
    flip = torch.tensor([False, True])
    tx, _, _ = timage._source_coords(rois, (64, 64), True, flip)
    for i in range(2):
        want, _, _ = timage._source_coords(rois[i], (64, 64), True,
                                           bool(flip[i]))
        torch.testing.assert_close(tx[i], want, rtol=0, atol=0)


def test_letterbox_padding_540x360_is_exactly_90():
    pad_x, pad_y, ph, pv = timage.letterbox_padding(
        torch.tensor(540.0), torch.tensor(360.0), (256, 256))
    assert float(pv) == 90.0 and float(ph) == 0.0
    assert float(pad_x) == 0.0
    assert abs(float(pad_y) - (1 - 360 / 540) / 2) < 1e-7


def test_letterbox_padding_matches_jax():
    rng = np.random.default_rng(1)
    dims = np.concatenate([
        rng.uniform(10.0, 800.0, (40, 2)),
        np.array([[540, 360], [360, 540], [200, 225], [704, 704],
                  [1280, 720]], np.float64)]).astype(np.float32)
    for out_size in ((256, 256), (64, 64), (192, 192)):
        got = timage.letterbox_padding(torch.from_numpy(dims[:, 0]),
                                       torch.from_numpy(dims[:, 1]),
                                       out_size)
        want = jimage.letterbox_padding(jnp.asarray(dims[:, 0]),
                                        jnp.asarray(dims[:, 1]), out_size)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=COORD_TOL)


@pytest.mark.parametrize("keep_aspect", [False, True])
def test_warp_derivatives(keep_aspect):
    rois = _rois(np.random.default_rng(2), 8, 540, 360)
    got = timage.warp_derivatives(torch.from_numpy(rois), (64, 64),
                                  keep_aspect)
    for i, roi in enumerate(rois):
        want = jimage.warp_derivatives(jnp.asarray(roi), (64, 64),
                                       keep_aspect)
        for g, w in zip(got, want):
            assert abs(float(g[i]) - float(w)) <= COORD_TOL


def test_letterbox_two_stage_params_match():
    for size in ((200, 225), (540, 360), (704, 704), (225, 200),
                 (201, 300), (1280, 720)):
        assert (timage.letterbox_two_stage_params(size, (256, 256))
                == jimage.letterbox_two_stage_params(size, (256, 256)))


@pytest.fixture(scope="module")
def frame_200x225():
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (225, 200, 3)).astype(np.float32)


@pytest.mark.parametrize("planar", [False, True])
def test_letterbox_two_stage_200x225(frame_200x225, planar):
    params = jimage.letterbox_two_stage_params((200, 225), (256, 256))
    assert params is not None
    img = frame_200x225
    jt, jp = jimage.letterbox_two_stage(jnp.asarray(img), (200, 225),
                                        (256, 256), params, (-1.0, 1.0))
    src = torch.from_numpy(img)
    if planar:
        src = src.permute(2, 0, 1).contiguous()
    tt, tp = timage.letterbox_two_stage(src[None], (200, 225), (256, 256),
                                        params, (-1.0, 1.0), planar=planar)
    assert tuple(tt.shape) == (1, 256, 256, 3)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # Outputs are rint-quantized levels scaled to [-1, 1].  The stage-1
    # uint8 rounding meets exact .5 ties on random pixels, where the two
    # libraries' f32 sums may differ in the last ulp (the pre-rounding
    # values agree to PIX_TOL, test_separable_sample): at most one level
    # on a few pixels.
    levels = np.abs(tt[0].numpy() - np.asarray(jt)) * 127.5
    assert levels.max() <= 1.0 + 1e-4
    assert (levels > 1e-4).mean() <= 1e-3


def _axis_aligned(w, h, out):
    whole = jnp.array([0.5 * w, 0.5 * h, w, h, 0.0], jnp.float32)
    return jimage._source_coords(whole, out, True, False)


@pytest.mark.parametrize("size", [(540, 360), (100, 160)])
def test_separable_sample(size):
    w, h = size
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, h, w, 3)).astype(np.float32)
    jx, jy, _ = _axis_aligned(w, h, (256, 256))
    tx, ty = torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jy))
    got = timage.separable_sample(torch.from_numpy(imgs), tx, ty)
    planes = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
    got_planar = timage.separable_sample_planar(planes, tx, ty)
    for i in range(2):
        want = np.asarray(jimage.separable_sample(jnp.asarray(imgs[i]),
                                                  jx, jy))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=PIX_TOL)
        np.testing.assert_allclose(got_planar[i].numpy(), want, rtol=0,
                                   atol=PIX_TOL)
        jpl = [jnp.asarray(imgs[i][..., c]) for c in range(3)]
        want_pl = np.asarray(jimage.separable_sample_planar(jpl, jx, jy))
        np.testing.assert_allclose(got_planar[i].numpy(), want_pl,
                                   rtol=0, atol=PIX_TOL)


@pytest.mark.parametrize("size", [(64, 64), (540, 360)])
def test_bilinear_sample(size):
    w, h = size
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (3, h, w, 3)).astype(np.float32)
    rois = _rois(rng, 3, w, h)
    tx, ty, _ = timage._source_coords(torch.from_numpy(rois), (48, 40),
                                      True, torch.tensor([0, 1, 0]) > 0)
    got = timage.bilinear_sample(torch.from_numpy(imgs), tx, ty)
    assert tuple(got.shape) == (3, 40, 48, 3)
    for i in range(3):
        want = jimage.bilinear_sample(jnp.asarray(imgs[i]),
                                      jnp.asarray(tx[i].numpy()),
                                      jnp.asarray(ty[i].numpy()))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=PIX_TOL)


def test_normalize_pixels_rounds_half_to_even():
    x = np.array([0.5, 1.5, 2.5, 3.5, 254.5, 2.4999, 2.5001, 127.0],
                 np.float32)
    for rng_, quant in (((0.0, 1.0), True), ((-1.0, 1.0), True),
                        ((0.0, 1.0), False)):
        got = timage._normalize_pixels(torch.from_numpy(x), rng_, quant)
        want = jimage._normalize_pixels(jnp.asarray(x), rng_, quant)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert timage._normalize_pixels(torch.tensor([2.5]), (0.0, 255.0),
                                    True).item() == 2.0
