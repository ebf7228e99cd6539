"""The strip warp (K2's counterpart) and the plane tier rule on the CPU.

The CUDA kernel ``csrc/warp_bilinear_strips.cu`` cannot run here (no
card, no nvcc); chip_smoke.py holds it against its plain version on the
card.  Here the plain version is held against the JAX package:

* ``tpu_face.ops.image.bilinear_sample`` (the exact gather): max abs
  <= 1e-3 in 0-255 units, with bf16 and f32 planes, on ROIs past the
  frame edge, mirrored grids and a frame taller than 2560 px (300x2700);
* the Pallas strip kernel ``pallas_warp.warp_sample_multi(...,
  interpret=True)`` on stacked bf16 planes, with two faces sharing each
  frame's planes under a nested vmap: within one uint8 level (its bf16
  hat dots set that bound);
* the plane type of every frame size against JAX's ``_plane_cfg``, and
  the detection warp over bf16 planes against the f32 planes (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_face.ops import image as jimage
from tpu_face.ops import pallas_warp
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch.ops import image as timage
from tpu_face_torch.ops import warp
from tpu_face_torch.pipeline import FaceCascade

PIX_TOL = 1e-3
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _frames(rng, b, w, h):
    return rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _rois(rng, n, w, h, scale=(0.05, 0.7), edge=0.1, max_rot=np.pi / 4):
    side = rng.uniform(*scale, n) * min(w, h)
    return np.stack([rng.uniform(-edge * w, (1 + edge) * w, n),
                     rng.uniform(-edge * h, (1 + edge) * h, n), side,
                     side * rng.uniform(0.8, 1.25, n),
                     rng.uniform(-max_rot, max_rot, n)],
                    -1).astype(np.float32)


def _case_coords(case, rng, b, w, h):
    """[(src_x, src_y)] grids [B, K, Ho, Wo] of one test case."""
    if case == "edge":
        # 192x192 mesh grids centred on the frame's corners and edges
        rois = _rois(rng, b * 2, w, h, edge=0.0)
        rois[:, 0] = rng.choice([0.0, w - 1.0], b * 2)
        rois[:, 1] = rng.choice([0.0, h / 2, h - 1.0], b * 2)
        x, y, _ = timage._source_coords(
            torch.from_numpy(rois.reshape(b, 2, 5)), (192, 192), False,
            False)
        return [(x, y)]
    # the cascade's iris call: left and mirrored right 64x64 grids
    rois = torch.from_numpy(_rois(rng, b * 4, w, h).reshape(b, 2, 2, 5))
    lx, ly, _ = timage._source_coords(rois[:, :, 0], (64, 64), True, False)
    rx, ry, _ = timage._source_coords(rois[:, :, 1], (64, 64), True, True)
    return [(lx, ly), (rx, ry)]


CASES = {"edge": (160, 120), "mirrored": (200, 120),
         "narrow_tall": (300, 2700)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_bilinear_sample(case, dtype):
    w, h = CASES[case]
    rng = np.random.default_rng(w + h)
    frames = _frames(rng, 2, w, h)
    planes = warp.make_planes(torch.from_numpy(frames), dtype=DTYPES[dtype])
    assert planes.dtype == DTYPES[dtype]
    coords = _case_coords(case, rng, 2, w, h)
    xs = torch.cat([x.reshape(2, -1) for x, _ in coords], 1)
    ys = torch.cat([y.reshape(2, -1) for _, y in coords], 1)
    got = warp.warp_bilinear_strips(planes, xs, ys)
    torch.testing.assert_close(
        got, warp.warp_bilinear_strips_plain(planes, xs, ys), rtol=0,
        atol=0)
    for i in range(2):
        want = jimage.bilinear_sample(jnp.asarray(frames[i], jnp.float32),
                                      jnp.asarray(xs[i:i + 1].numpy()),
                                      jnp.asarray(ys[i:i + 1].numpy()))
        np.testing.assert_allclose(got[i].numpy(),
                                   np.asarray(want)[0].T, rtol=0,
                                   atol=PIX_TOL)


def test_sample_multi_dispatches_on_plane_type(monkeypatch):
    """bf16 planes take the strip kernel's wrapper (the grids
    concatenated), f32 planes the resident one's segment wrapper (one
    segment per grid, as it lies, its rows as wide as the grid's); K
    faces per frame share one call."""
    calls = []
    real_strips, real_segments = (warp.warp_bilinear_strips,
                                  warp.warp_bilinear_segments)
    monkeypatch.setattr(
        warp, "warp_bilinear_strips",
        lambda p, x, y: calls.append(("warp_bilinear_strips",
                                      tuple(x.shape)))
        or real_strips(p, x, y))
    monkeypatch.setattr(
        warp, "warp_bilinear_segments",
        lambda p, segs: calls.append(("warp_bilinear_segments", [
            (tuple(x.shape), wd) for x, _, wd in segs]))
        or real_segments(p, segs))
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(_frames(rng, 2, 160, 120))
    coords = _case_coords("mirrored", rng, 2, 160, 120)
    before = (warp.LAUNCHES, warp.STRIP_LAUNCHES)
    outs = {}
    for dtype in ("f32", "bf16"):
        planes = warp.make_planes(frames, dtype=DTYPES[dtype])
        outs[dtype] = warp.warp_sample_multi(planes, coords)
    assert calls == [("warp_bilinear_segments",
                      [((2, 2, 64, 64), 64), ((2, 2, 64, 64), 64)]),
                     ("warp_bilinear_strips", (2, 2 * 2 * 64 * 64))]
    assert (warp.LAUNCHES, warp.STRIP_LAUNCHES) == before  # CPU: plain
    for a, b, (x, _) in zip(outs["f32"], outs["bf16"], coords):
        assert tuple(b.shape) == tuple(x.shape) + (3,)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_within_one_level_of_pallas_strip_kernel():
    """JAX's K2 in interpret mode on stacked bf16 [3, Hp, Wp] planes, two
    faces sharing each frame's planes under a nested vmap (the
    ``custom_vmap`` rule's g // plane_ratio map), against the port's
    [B, K*P] layout of the same coordinates."""
    rng = np.random.default_rng(11)
    w, h, band, cw, rt = 200, 120, 64, 32, 8
    frames = _frames(rng, 2, w, h)
    for _ in range(200):
        rois = _rois(rng, 8, w, h, scale=(0.15, 0.3), edge=0.0,
                     max_rot=0.4).reshape(2, 2, 2, 5)
        lx, ly, _ = timage._source_coords(
            torch.from_numpy(rois[:, :, 0]), (64, 64), True, False)
        rx, ry, _ = timage._source_coords(
            torch.from_numpy(rois[:, :, 1]), (64, 64), True, True)
        grids = [(lx, ly), (rx, ry)]
        if all(bool(pallas_warp.envelope_ok(
                jnp.asarray(x[i, k].numpy()), jnp.asarray(y[i, k].numpy()),
                cw, band, 16, 256 - 129, rt))
               for x, y in grids for i in range(2) for k in range(2)):
            break
    else:
        pytest.fail("no ROI set inside the Pallas envelope")

    hp, wp = -(-h // 16) * 16, pallas_warp.padded_width(w)
    stacked = jnp.pad(jnp.asarray(frames, jnp.float32).transpose(0, 3, 1, 2),
                      ((0, 0), (0, 0), (0, hp - h), (0, wp - w))
                      ).astype(jnp.bfloat16)               # [B, 3, Hp, Wp]

    def per_face(planes, lx_, ly_, rx_, ry_):
        return pallas_warp.warp_sample_multi(
            None, [(lx_, ly_), (rx_, ry_)], band=band, planes=planes,
            cw=cw, rt=rt, interpret=True)

    def per_frame(planes, *face_coords):
        return jax.vmap(per_face, in_axes=(None, 0, 0, 0, 0))(
            planes, *face_coords)

    jl, jr = jax.vmap(per_frame)(
        stacked, *(jnp.asarray(t.numpy()) for t in (lx, ly, rx, ry)))
    planes = warp.make_planes(torch.from_numpy(frames), dtype=torch.bfloat16)
    tl, tr = warp.warp_sample_multi(planes, grids)
    for got, want in ((tl, jl), (tr, jr)):
        assert tuple(got.shape) == want.shape == (2, 2, 64, 64, 3)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1.0


SIZES = [(1920, 1080), (1280, 824), (1280, 720), (1080, 720)]


@pytest.mark.parametrize("size", SIZES)
def test_plane_type_matches_jax_plane_cfg(size):
    w, h = size
    want = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
        JaxFaceCascade._plane_cfg(size)[0]]
    assert FaceCascade._plane_cfg(size) == want
    assert warp.planes_fit_vmem(h, w) == pallas_warp.planes_fit_vmem(h, w)
    frame = torch.zeros(1, h, w, 3, dtype=torch.uint8)
    assert warp.make_planes(frame, dtype=want).dtype == want


@pytest.mark.parametrize("w", [64, 200, 256, 257, 1280, 1281, 3840])
def test_tier_rule_copies_match(w):
    assert warp.padded_width(w) == pallas_warp.padded_width(w)
    for h in (8, 360, 720, 823, 824, 1080, 2160):
        assert warp.planes_fit_vmem(h, w) == pallas_warp.planes_fit_vmem(
            h, w)


def test_bf16_planes_are_exact_and_planar_matches_hwc():
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(_frames(rng, 2, 70, 50))
    bf = warp.make_planes(frames, dtype=torch.bfloat16)
    torch.testing.assert_close(bf.float(), warp.make_planes(frames),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        bf, warp.make_planes(frames.permute(0, 3, 1, 2).contiguous(),
                             "planar", torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(TypeError):
        warp.make_planes(frames, dtype=torch.float16)


def test_detection_warp_over_bf16_planes(monkeypatch):
    """The separable detection warp upcasts bf16 planes chunk by chunk:
    the same numbers as over f32 planes (and as JAX over stacked bf16
    planes with ``dot_dtype=None``)."""
    rng = np.random.default_rng(4)
    w, h = 300, 200
    frames = _frames(rng, 5, w, h)
    whole = jnp.array([0.5 * w, 0.5 * h, w, h, 0.0], jnp.float32)
    jx, jy, _ = jimage._source_coords(whole, (256, 256), True, False)
    tx, ty = torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jy))
    f32 = timage.separable_sample_planar(
        warp.make_planes(torch.from_numpy(frames)), tx, ty)
    # two frames per chunk: three chunks for five frames
    monkeypatch.setattr(timage, "UPCAST_CHUNK_BYTES", 2 * 3 * h * w * 4)
    bf = timage.separable_sample_planar(
        warp.make_planes(torch.from_numpy(frames), dtype=torch.bfloat16),
        tx, ty)
    torch.testing.assert_close(bf, f32, rtol=0, atol=0)
    stacked = jnp.asarray(frames[0], jnp.bfloat16).transpose(2, 0, 1)
    want = jimage.separable_sample_planar(stacked, jx, jy)
    np.testing.assert_allclose(bf[0].numpy(), np.asarray(want), rtol=0,
                               atol=PIX_TOL)


def test_strip_wrapper_rejects_bad_inputs():
    planes = torch.zeros(2, 3, 8, 8, dtype=torch.bfloat16)
    xs = torch.zeros(2, 5)
    with pytest.raises(TypeError):
        warp.warp_bilinear_strips(planes.half(), xs, xs)
    with pytest.raises(TypeError):
        warp.warp_bilinear(planes, xs, xs)     # K1 takes f32 planes only
    with pytest.raises(ValueError):
        warp.warp_bilinear_strips(planes, xs[:1], xs[:1])
    with pytest.raises(ValueError):
        warp.warp_bilinear_strips(planes.to("meta"), xs.to("meta"),
                                  xs.to("meta"))
