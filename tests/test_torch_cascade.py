"""tpu_face_torch.pipeline.FaceCascade on the CPU against the JAX
package and the rotated-frame ground truth.

* Against ``tpu_face.pipeline.FaceCascade(warp_method="gather")`` on the
  four 540p rotated frames, the 704x704 close-up and chip_smoke.py's
  1920x1080 canvas (a) (bf16 planes, the strip kernel's tier), field by
  field: equal bools; landmarks, detection points and ROI centres/sizes
  within 0.25 px; rotations within 1e-3 rad; scores within 1e-3.
* Against the ground-truth rows of tests/test_rotation_e2e.py on all
  seven rotated frames (including the two 200x225 portraits that take
  the two-stage letterbox): bbox IoU >= 0.99, landmarks <= 1 px.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_rotation_e2e import FRAMES_540, GT, GT_PORTRAIT, ROT, _check_cascade
from test_torch_threads import share_cores  # noqa: F401
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

PX_TOL = 0.25
ROT_TOL = 1e-3
SCORE_TOL = 1e-3
JAX_FRAMES = FRAMES_540 + ["man_closeup_rotp30.png"]


@pytest.fixture(scope="module")
def cascade():
    return FaceCascade(device="cpu")


@pytest.fixture(scope="module")
def jax_cascade():
    return JaxFaceCascade(warp_method="gather")


def _frame(name):
    return load_image(ROT / name)


def _compare(res, ref, size):
    """Port result vs JAX result for the same batch, field by field:
    every bool in every slot, and the numbers of the slots where the face
    is valid (with a face axis, an invalid slot holds the stages' output
    for a dead NMS slot, which nothing reads)."""
    w, h = size
    assert res._fields == ref._fields
    for f in res._fields:
        a = getattr(res, f).numpy()
        b = np.asarray(getattr(ref, f))
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
    ok = res.face_valid.numpy()

    def diff(f):
        return np.abs(getattr(res, f).numpy()[ok]
                      - np.asarray(getattr(ref, f))[ok])

    px = np.array([w, h, w], np.float32)
    for f in ("mesh", "mesh_raw", "iris"):
        d = diff(f)
        assert (d * px).max() <= PX_TOL, (f, (d * px).max())
    assert (diff("detection") * px[:2]).max() <= PX_TOL
    for f in ("face_roi", "eye_rois"):
        d = diff(f)
        scale = np.array([w, h, w, h], np.float32)
        assert (d[..., :4] * scale).max() <= PX_TOL, f
        assert d[..., 4].max() <= ROT_TOL, f
    for f in ("score", "mesh_score"):
        assert diff(f).max() <= SCORE_TOL, f


@pytest.mark.parametrize("name", JAX_FRAMES)
def test_cascade_matches_jax_gather(cascade, jax_cascade, name):
    img = _frame(name)[None]
    res = cascade.infer_batch(img)
    _compare(res, jax_cascade.infer_batch(img), GT[name]["size"])


def test_canvas_1080p_matches_jax_gather(cascade, jax_cascade):
    """Canvas (a): one face on a 1920x1080 frame, past the f32 residency
    budget, so the port's planes are bf16 and its warps take the strip
    kernel's wrapper."""
    img = chip_smoke.canvas_1080p(load_image)
    assert cascade._plane_cfg((1920, 1080)) == torch.bfloat16
    res = cascade.infer_batch(img[None])
    assert bool(res.mesh_valid[0])
    _compare(res, jax_cascade.infer_batch(img[None]), (1920, 1080))


@pytest.mark.parametrize("name", JAX_FRAMES + sorted(GT_PORTRAIT))
def test_cascade_matches_ground_truth(cascade, name):
    gt = GT.get(name) or GT_PORTRAIT[name]
    _check_cascade(cascade.infer_batch(_frame(name)[None]), gt)


def test_batch_matches_single_frames(cascade):
    """The explicit batch dimension: four 540p frames in one call give
    the per-frame results."""
    batch = np.stack([_frame(n) for n in FRAMES_540])
    res = cascade.infer_batch(batch)
    for i, name in enumerate(FRAMES_540):
        one = cascade.infer_batch(batch[i])
        for f in res._fields:
            a, b = getattr(res, f)[i], getattr(one, f)[0]
            if a.dtype == torch.bool:
                assert torch.equal(a, b), (name, f)
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_planar_layout_matches_hwc(cascade):
    batch = np.stack([_frame(n) for n in FRAMES_540[:2]])
    planar = FaceCascade(device="cpu", input_layout="planar")
    a = cascade.infer_batch(batch)
    b = planar.infer_batch(np.ascontiguousarray(batch.transpose(0, 3, 1, 2)))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_default_device_is_the_card():
    """FaceCascade() runs on CUDA; with no card it raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        assert FaceCascade().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FaceCascade()


def test_unported_options_raise():
    """bf16 nets construct and run (tests/test_torch_bf16.py holds them
    against JAX), other dtypes raise; ``max_faces=2`` runs and gives
    every field a face axis after the batch axis."""
    bf16 = FaceCascade(device="cpu", compute_dtype=torch.bfloat16)
    res = bf16.infer_batch(_frame(FRAMES_540[0])[None])
    assert bool(res.mesh_valid[0]) and res.mesh.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        FaceCascade(device="cpu", compute_dtype=torch.float16)
    two = FaceCascade(device="cpu", max_faces=2)
    res = two.infer_batch(_frame(FRAMES_540[0])[None])
    assert tuple(res.mesh.shape) == (1, 2, 468, 3)
    assert tuple(res.iris.shape) == (1, 2, 2, 5, 3)
    assert tuple(res.face_valid.shape) == (1, 2)
    assert bool(res.face_valid[0, 0])


def test_signature_parity_options():
    """``warp_profile`` is validated and ignored (the card's kernels
    sample every ROI exactly); ``nms_top_m`` is accepted and unused by
    the weighted NMS, as in JAX."""
    img = _frame(FRAMES_540[1])[None]
    base = FaceCascade(device="cpu").infer_batch(img)
    for profile in ("coverage", "speed", "auto"):
        res = FaceCascade(device="cpu", warp_profile=profile,
                          nms_top_m=16).infer_batch(img)
        for f in res._fields:
            assert torch.equal(getattr(res, f), getattr(base, f)), f
    with pytest.raises(ValueError):
        FaceCascade(device="cpu", warp_profile="fast")
    with pytest.raises(ValueError):
        FaceCascade(device="cpu", max_faces=0)


def test_chip_smoke_ground_truth_matches_tests():
    """chip_smoke.py carries its own copy of the ground truth (it must
    not import the JAX tests); the copy must not drift."""
    rows = {**GT, **GT_PORTRAIT}
    assert set(chip_smoke.GT) == set(rows)
    for name, row in chip_smoke.GT.items():
        for key, value in row.items():
            assert value == rows[name][key], (name, key)
    assert set(chip_smoke.FRAMES_540) == set(FRAMES_540)
