"""tpu_face_torch.ops.warp on the CPU: the plain path of the warp.

The CUDA kernel cannot run here (no card, no nvcc); chip_smoke.py holds
it against this plain version on the card.  Here the plain version is
held against the JAX package:

* ``tpu_face.ops.image.bilinear_sample`` (the exact gather): max abs
  <= 1e-3 in 0-255 units, on random ROIs to ±45 deg, mirrored grids and
  taps past the frame edge, at frames from 64x64 to 1280x720;
* the Pallas kernel ``pallas_warp.warp_sample_multi(..., interpret=True)``
  on ROIs inside its envelope (``envelope_ok``): <= 1e-3 with f32 dots,
  and within one uint8 level after rounding with its default bf16 dots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_face.ops import image as jimage
from tpu_face.ops import pallas_warp
from tpu_face_torch.ops import image as timage
from tpu_face_torch.ops import warp

PIX_TOL = 1e-3


def _frames(rng, b, w, h):
    return rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _rois(rng, b, w, h, max_rot=np.pi / 4, scale=(0.05, 0.7), edge=0.1):
    side = rng.uniform(*scale, b) * min(w, h)
    return torch.from_numpy(np.stack(
        [rng.uniform(-edge * w, (1 + edge) * w, b),
         rng.uniform(-edge * h, (1 + edge) * h, b), side,
         side * rng.uniform(0.8, 1.25, b),
         rng.uniform(-max_rot, max_rot, b)], -1).astype(np.float32))


def _grids(rng, b, w, h, **kw):
    """The cascade's two warp calls: a 192x192 mesh grid, and the 64x64
    left + mirrored right iris grids."""
    mx, my, _ = timage._source_coords(_rois(rng, b, w, h, **kw),
                                      (192, 192), False, False)
    lx, ly, _ = timage._source_coords(_rois(rng, b, w, h, **kw), (64, 64),
                                      True, False)
    rx, ry, _ = timage._source_coords(_rois(rng, b, w, h, **kw), (64, 64),
                                      True, True)
    return [[(mx, my)], [(lx, ly), (rx, ry)]]


def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(0)
    planes = warp.make_planes(torch.from_numpy(_frames(rng, 2, 80, 60)))
    before = warp.LAUNCHES
    for coords in _grids(rng, 2, 80, 60):
        warp.warp_sample_multi(planes, coords)
    assert warp.LAUNCHES == before


@pytest.mark.parametrize("size", [(64, 64), (160, 120), (540, 360),
                                  (1280, 720)])
def test_plain_matches_bilinear_sample(size):
    w, h = size
    rng = np.random.default_rng(w)
    frames = _frames(rng, 2, w, h)
    planes = warp.make_planes(torch.from_numpy(frames))
    for coords in _grids(rng, 2, w, h):
        outs = warp.warp_sample_multi(planes, coords)
        for (sx, sy), out in zip(coords, outs):
            assert tuple(out.shape) == tuple(sx.shape) + (3,)
            for i in range(2):
                want = jimage.bilinear_sample(
                    jnp.asarray(frames[i], jnp.float32),
                    jnp.asarray(sx[i].numpy()), jnp.asarray(sy[i].numpy()))
                np.testing.assert_allclose(out[i].numpy(), np.asarray(want),
                                           rtol=0, atol=PIX_TOL)


def test_planar_layout_gives_same_planes():
    frames = torch.from_numpy(_frames(np.random.default_rng(1), 2, 50, 40))
    torch.testing.assert_close(
        warp.make_planes(frames),
        warp.make_planes(frames.permute(0, 3, 1, 2).contiguous(), "planar"),
        rtol=0, atol=0)


@pytest.fixture(scope="module")
def pallas_case():
    """A 160x120 frame (w x h) with mesh (32x32) and iris (2x 16x32)
    grids inside the Pallas kernel's envelope, and the kernel's
    interpret-mode results with f32 and bf16 dots."""
    rng = np.random.default_rng(2)
    w, h = 160, 120
    frame = _frames(rng, 1, w, h)
    band, cw, rt = 48, 32, 8
    for _ in range(100):
        mesh = _rois(rng, 1, w, h, max_rot=0.4, scale=(0.3, 0.6), edge=0.0)
        eyes = _rois(rng, 2, w, h, max_rot=0.4, scale=(0.1, 0.25),
                     edge=0.0)
        mx, my, _ = timage._source_coords(mesh, (32, 32), False, False)
        # 16x32 eye grids, the right one mirrored
        ex, ey, _ = timage._source_coords(eyes, (32, 16), False,
                                          torch.tensor([False, True]))
        grids = [(mx[0], my[0]), (ex[0], ey[0]), (ex[1], ey[1])]
        if all(bool(pallas_warp.envelope_ok(jnp.asarray(x.numpy()),
                                            jnp.asarray(y.numpy()), cw,
                                            band))
               for x, y in grids):
            break
    else:
        pytest.fail("no ROI set inside the Pallas envelope")
    img = jnp.asarray(frame[0], jnp.float32)
    jgrids = [(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
              for x, y in grids]
    results = {}
    for name, dot in (("f32", None), ("bf16", jnp.bfloat16)):
        (m,) = pallas_warp.warp_sample_multi(img, jgrids[:1], band=band,
                                             dot_dtype=dot, interpret=True,
                                             cw=cw, rt=rt)
        li, ri = pallas_warp.warp_sample_multi(img, jgrids[1:], band=band,
                                               dot_dtype=dot,
                                               interpret=True, cw=cw, rt=rt)
        results[name] = [np.asarray(m), np.asarray(li), np.asarray(ri)]
    planes = warp.make_planes(torch.from_numpy(frame))
    (pm,) = warp.warp_sample_multi(planes, [(mx, my)])
    pl, pr = warp.warp_sample_multi(planes, [(ex[:1], ey[:1]),
                                             (ex[1:], ey[1:])])
    ours = [pm[0].numpy(), pl[0].numpy(), pr[0].numpy()]
    return ours, results


def test_plain_matches_pallas_kernel_f32_dots(pallas_case):
    ours, results = pallas_case
    for got, want in zip(ours, results["f32"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=PIX_TOL)


def test_plain_within_one_level_of_pallas_kernel_bf16_dots(pallas_case):
    ours, results = pallas_case
    for got, want in zip(ours, results["bf16"]):
        assert np.max(np.abs(np.rint(got) - np.rint(want))) <= 1.0


def test_rejects_bad_inputs():
    planes = torch.zeros(2, 3, 8, 8)
    xs = torch.zeros(2, 5)
    with pytest.raises(TypeError):
        warp.warp_bilinear(planes.double(), xs, xs)
    with pytest.raises(ValueError):
        warp.warp_bilinear(planes[:, :2], xs, xs)
    with pytest.raises(ValueError):
        warp.warp_bilinear(planes, xs[:1], xs[:1])
    with pytest.raises(ValueError):
        warp.warp_bilinear(planes.to("meta"), xs.to("meta"),
                           xs.to("meta"))
