"""The image and post-processing ops the standalone models add to
tpu_face_torch, on the CPU: the warp-method dispatch (``resolve_warp_method``,
``choose_warp_method`` and ``warp_image_to_tensor``'s "pallas" path, which
takes K1 or K2 over f32 planes by the residency rule), ``image_to_tensor``
and ``whole_image_roi`` against tpu_face.ops.image, and ``plain_nms``
against tpu_face.ops.postprocess."""

import numpy as np
import pytest
import torch

import chip_smoke
from test_rotation_e2e import ROT
from tpu_face import types as jtypes
from tpu_face.ops import image as jimage
from tpu_face.ops import postprocess as jpost
from tpu_face_torch import types as ttypes
from tpu_face_torch.ops import image as timage
from tpu_face_torch.ops import postprocess as tpost
from tpu_face_torch.ops import warp
from tpu_face_torch.utils.image_io import load_image


def test_warp_methods_resolve():
    assert timage.resolve_warp_method("auto", "cpu") == "gather"
    assert timage.resolve_warp_method("auto", "cuda") == "pallas"
    assert timage.resolve_warp_method("auto") == "pallas"
    for m in ("gather", "pallas", "mxu", "separable"):
        assert timage.resolve_warp_method(m, "cpu") == m
        assert timage.choose_warp_method(m, np.zeros(5), (640, 480),
                                         (192, 192), False) == m
    with pytest.raises(ValueError):
        timage.choose_warp_method("bogus", np.zeros(5), (640, 480),
                                  (192, 192), False)


@pytest.mark.parametrize("frame,kernel", [("540p", "warp_bilinear"),
                                          ("1080p", "warp_bilinear_strips")])
def test_pallas_method_dispatch(monkeypatch, frame, kernel):
    """Method "pallas" builds f32 planes and takes K1 where the planes
    fit the TPU kernel's residency budget and K2 beyond it (at 1080p);
    on the CPU both run their plain versions, count no launch, and equal
    the plain gather."""
    img = (load_image(ROT / "man_rotp15.png") if frame == "540p"
           else chip_smoke.canvas_1080p(load_image))
    h, w = img.shape[:2]
    seen = []
    real = getattr(warp, kernel)

    def spy(planes, xs, ys):
        seen.append(planes.dtype)
        return real(planes, xs, ys)

    monkeypatch.setattr(warp, kernel, spy)
    frames = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    rois = torch.tensor([[0.45 * w, 0.4 * h, 0.3 * h, 0.3 * h, 0.4],
                         [0.5 * w, 0.5 * h, 0.2 * h, 0.25 * h, -0.3]])
    flips = torch.tensor([False, True])
    before = (warp.LAUNCHES, warp.STRIP_LAUNCHES)
    for keep in (False, True):
        got, pad = timage.warp_image_to_tensor(
            frames, rois, (64, 64), keep, (0.0, 1.0), flips,
            method="pallas")
        want, wpad = timage.warp_image_to_tensor(
            frames, rois, (64, 64), keep, (0.0, 1.0), flips,
            method="gather")
        assert torch.equal(pad, wpad)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert seen == [torch.float32, torch.float32]
    assert (warp.LAUNCHES, warp.STRIP_LAUNCHES) == before


@pytest.mark.parametrize("keep", [False, True])
def test_warp_image_to_tensor_matches_jax(keep):
    """The gather path against JAX on one frame and rotated ROI, before
    the uint8 rounding, in 0-255 units."""
    img = load_image(ROT / "man_rotm30.png")
    roi = np.array([270.0, 150.0, 140.0, 120.0, 0.5], np.float32)
    got, pad = timage.warp_image_to_tensor(
        torch.from_numpy(img.copy()), torch.from_numpy(roi), (48, 64), keep,
        (0.0, 255.0), True, quantize_uint8=False)
    want, wpad = jimage.warp_image_to_tensor(
        img, roi, (48, 64), keep, (0.0, 255.0), True, quantize_uint8=False)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3
    np.testing.assert_allclose(pad.numpy(), np.asarray(wpad), atol=1e-7)


@pytest.mark.parametrize("case", ["whole_letterbox", "portrait_two_stage",
                                  "rotated_roi_flipped"])
def test_image_to_tensor_matches_jax(case):
    if case == "portrait_two_stage":
        img = load_image(ROT / "russ2_rotp20.png")
        kw = {"output_size": (128, 128), "keep_aspect_ratio": True}
    else:
        img = load_image(ROT / "man_rotp30.png")
        kw = {"output_size": (64, 96), "keep_aspect_ratio": True,
              "output_range": (-1.0, 1.0)}
    if case == "rotated_roi_flipped":
        kw["roi"] = jtypes.Rect(0.45, 0.42, 0.3, 0.35, -0.4)
        kw["flip_horizontal"] = True
    mine_kw = dict(kw)
    if "roi" in kw:
        r = kw["roi"]
        mine_kw["roi"] = ttypes.Rect(
            r.x_center, r.y_center, r.width, r.height, r.rotation)
    got = timage.image_to_tensor(img, device="cpu", **mine_kw)
    want = jimage.image_to_tensor(img, **kw)
    assert got.original_size == want.original_size
    np.testing.assert_allclose(got.padding, want.padding, atol=1e-7)
    diff = np.abs(got.tensor_data - want.tensor_data)
    # the uint8 rounding may flip one level on an exact .5 tie
    step = (kw.get("output_range", (0.0, 1.0))[1]
            - kw.get("output_range", (0.0, 1.0))[0]) / 255.0
    assert diff.max() <= step + 1e-6 and (diff > 1e-5).mean() <= 1e-3


def test_whole_image_roi():
    roi = timage.whole_image_roi((540, 360), device="cpu")
    np.testing.assert_array_equal(
        roi.numpy(), np.asarray(jimage.whole_image_roi((540, 360))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_nms_matches_jax(seed):
    """Greedy NMS on random overlapping boxes with ties and invalid rows,
    a batch of two against the JAX version frame by frame."""
    rng = np.random.default_rng(seed)
    n = 300
    centre = rng.uniform(0.2, 0.8, (2, n, 1, 2))
    half = rng.uniform(0.01, 0.1, (2, n, 1, 2))
    data = np.concatenate([centre - half, centre + half,
                           rng.uniform(0, 1, (2, n, 6, 2))], axis=2)
    data = data.astype(np.float32)
    scores = np.round(rng.uniform(0.3, 1.0, (2, n)), 2).astype(np.float32)
    valid = scores > 0.5
    got = tpost.plain_nms(torch.from_numpy(data), torch.from_numpy(scores),
                          torch.from_numpy(valid), max_outputs=16)
    for b in range(2):
        want = jpost.plain_nms(data[b], scores[b], valid[b],
                               max_outputs=16)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
