"""tpu_face_torch.pipeline.EmbedCascade (detect -> crop -> embed) on the
CPU, against tpu_face.pipeline.EmbedCascade with the demo embedding graph
(``tpu_face/data/demo``) and the BACK detector.

* f32, ``warp_method`` "pallas" (the separable crop over the frame
  planes), "gather" and "mxu", on the rotated frames: equal
  ``face_valid``, ``crop_bbox`` equal, detection within 0.25 px and
  scores within 1e-3 (tests/test_torch_cascade.py's rules), embeddings
  within 1e-4 max abs.  JAX runs un-jitted (``jax.disable_jit``): its
  jitted crop rounds a few uint8 levels one apart from its eager result
  (1.20e-4 on the embedding at man_rotp15), and the port computes eager
  JAX's arithmetic (<= 1.5e-5 from it).
* bf16 nets against JAX's jitted bf16 cascade, both crops: every crop
  edge within 1 px and cosine >= 0.99 (the lowest measured: 0.99504, on
  man_rotm30; the int-truncated crop moves by a pixel where the bf16
  detections differ).
* ``max_faces=2`` on a 1280x824 canvas with two faces (bf16 planes):
  both faces, with the face axis, against JAX.
* The constructor's parameters are JAX's in its order plus ``device``;
  "pallas" launches no warp kernel; no card and no ``device`` raises.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rotation_e2e import FRAMES_540, ROT
from test_torch_threads import share_cores  # noqa: F401
from tpu_face.pipeline import EmbedCascade as JaxEmbedCascade
from tpu_face_torch.models import FaceDetectionModel
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.ops import warp
from tpu_face_torch.pipeline import EmbedCascade, EmbedResult
from tpu_face_torch.utils.image_io import load_image

DEMO = str(_DATA_DIR / "demo")
PX_TOL = 0.25
SCORE_TOL = 1e-3
EMB_TOL = 1e-4
BF16_CROP_PX = 1.0
BF16_COSINE = 0.99


@pytest.fixture(scope="module")
def frames540():
    return np.stack([load_image(ROT / n) for n in FRAMES_540])


@pytest.fixture(scope="module")
def canvas():
    c = np.zeros((824, 1280, 3), np.uint8)
    c[232:592, 50:590] = load_image(ROT / "man_rotp15.png")
    c[232:592, 690:1230] = load_image(ROT / "man_rotm30.png")
    return c[None]


def _run(frames, method, dtype="float32", max_faces=1, eager=True):
    kw = dict(embed_model_path=DEMO, warp_method=method,
              max_faces=max_faces)
    ref = JaxEmbedCascade(compute_dtype=getattr(jnp, dtype), **kw)
    if eager:
        with jax.disable_jit():
            want = ref.infer_batch(frames)
    else:
        want = ref.infer_batch(frames)
    got = EmbedCascade(compute_dtype=getattr(torch, dtype), device="cpu",
                       **kw).infer_batch(frames)
    assert isinstance(got, EmbedResult)
    return got, EmbedResult(*(np.asarray(f) for f in want))


def _compare_f32(got, want, size):
    w, h = size
    np.testing.assert_array_equal(got.face_valid.numpy(), want.face_valid)
    ok = want.face_valid
    assert ok.any()
    np.testing.assert_array_equal(got.crop_bbox.numpy()[ok],
                                  want.crop_bbox[ok])
    det = np.abs(got.detection.numpy()[ok] - want.detection[ok])
    assert float((det * np.array([w, h])).max()) <= PX_TOL
    assert float(np.abs(got.score.numpy()[ok] - want.score[ok]).max()) \
        <= SCORE_TOL
    emb = got.embedding.numpy()
    assert emb.shape == want.embedding.shape
    assert float(np.abs(emb[ok] - want.embedding[ok]).max()) <= EMB_TOL
    np.testing.assert_allclose(np.linalg.norm(emb[ok], axis=-1), 1.0,
                               atol=1e-5)


def test_parameters_follow_the_reference_order():
    ours = list(inspect.signature(EmbedCascade.__init__).parameters)
    ref = list(inspect.signature(JaxEmbedCascade.__init__).parameters)
    assert ours == ref + ["device"]
    cas = EmbedCascade(FaceDetectionModel.BACK_CAMERA, None, DEMO,
                       torch.float32, "gather", 2, device="cpu")
    assert (cas.max_faces, cas.warp_method) == (2, "gather")


# the 540p frames each method runs (eager JAX takes seconds a frame)
SUBSETS = {"pallas": [0, 3], "gather": [1, 2], "mxu": [1]}


@pytest.mark.parametrize("method", ["pallas", "gather", "mxu"])
def test_f32_matches_jax(frames540, method):
    frames = frames540[SUBSETS[method]]
    got, want = _run(frames, method)
    assert tuple(got.embedding.shape) == (len(frames), 128)
    assert tuple(got.crop_bbox.shape) == (len(frames), 4)
    _compare_f32(got, want, (540, 360))


@pytest.mark.parametrize("name", ["man_closeup_rotp30.png",
                                  "russ2_rotp20.png"])
def test_f32_matches_jax_other_geometries(name):
    """The 704x704 close-up and a 200x225 portrait (the two-stage
    letterbox in the detector)."""
    img = load_image(ROT / name)[None]
    got, want = _run(img, "pallas")
    _compare_f32(got, want, (img.shape[2], img.shape[1]))


@pytest.mark.parametrize("method", ["pallas", "gather"])
def test_bf16_matches_jax(frames540, method):
    got, want = _run(frames540, method, dtype="bfloat16", eager=False)
    np.testing.assert_array_equal(got.face_valid.numpy(), want.face_valid)
    assert want.face_valid.all()
    crop = np.abs(got.crop_bbox.numpy() - want.crop_bbox)
    assert float(crop.max()) <= BF16_CROP_PX
    cosine = (got.embedding.numpy() * want.embedding).sum(-1)
    assert float(cosine.min()) >= BF16_COSINE, cosine


def test_two_faces_on_a_canvas(canvas):
    got, want = _run(canvas, "pallas", max_faces=2)
    assert tuple(got.embedding.shape) == (1, 2, 128)
    assert tuple(got.crop_bbox.shape) == (1, 2, 4)
    assert want.face_valid.all()
    _compare_f32(got, want, (1280, 824))


def test_pallas_launches_no_warp_kernel(frames540, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("EmbedCascade called a warp kernel")

    for name in ("warp_bilinear", "warp_bilinear_strips",
                 "warp_bilinear_segments", "warp_sample_multi"):
        monkeypatch.setattr(warp, name, refuse)
    res = EmbedCascade(embed_model_path=DEMO, warp_method="pallas",
                       device="cpu").infer_batch(frames540[:1])
    assert bool(res.face_valid.all())


def test_missing_embeddings_model(tmp_path):
    with pytest.raises(FileNotFoundError, match="not bundled"):
        EmbedCascade(embed_model_path=str(tmp_path), device="cpu")


def test_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbedCascade(embed_model_path=DEMO)
