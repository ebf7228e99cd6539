"""tpu_face_torch's face embeddings (``models.FaceEmbeddings``) on the CPU,
against tpu_face.

* The demo embedding graph (``tpu_face/data/demo/face_embeddings.npz``, a
  MobileFaceNet at width 0.5 with synthetic weights: ADD, CONV_2D, MUL,
  MINIMUM, RELU, DEPTHWISE_CONV_2D, MEAN, LOGISTIC, FULLY_CONNECTED)
  against ``build_jax_fn`` on the same seeded input: f32 within 1e-4 of
  max|JAX output|, bf16 within 2e-2 of it; no residual run for the fused
  kernel.
* ``infer``, ``infer_batch`` and ``embed_boxes`` (corner rows
  ``[B, 2, 2]`` and ``[B, 4]``, mesh landmarks ``[B, N, 3]``, a face axis
  K, planar frames, ``as_numpy=False``) against JAX's with the same
  ``warp_method`` ("gather", "pallas", "mxu"), the same frames and boxes:
  embedding max abs <= 1e-4.  JAX runs un-jitted (``jax.disable_jit``):
  its jitted crop rounds some uint8 levels one apart from its own eager
  result (23 of 37,632 crop values on man_rotm15's face box, 1.07e-4 on
  the embedding with "gather"), while the port computes eager JAX's
  arithmetic (2.7e-7 from it).
* "pallas" crops with the separable hat matmuls: no warp kernel wrapper
  is called.
* The missing-model and empty-bbox errors, the shape checks,
  ``FeatureCount``, ``l2_norm`` and ``similarity_score``, and the device
  rule (no card: raise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import build_jax_fn
from tpu_face.models import FaceEmbeddings as JaxFaceEmbeddings
from tpu_face.models import FeatureCount as JaxFeatureCount
from tpu_face.types import BBox as JaxBBox
from tpu_face.utils import image_io as jio
from tpu_face_torch.compiler import Graph, TFLiteNet
from tpu_face_torch.models import FaceEmbeddings, FeatureCount
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.ops import warp
from tpu_face_torch.types import BBox
from tpu_face_torch.utils import image_io
from tpu_face_torch.utils.image_io import load_image

DEMO = str(_DATA_DIR / "demo")
ROT = _DATA_DIR.parents[1] / "assets" / "rotated"
FRAMES = ["man_rotm15.png", "man_rotp30.png"]
# face boxes of the two frames, absolute px (fractional: the reference
# truncates them)
BOXES = [(207.3, 72.5, 346.9, 211.2), (178.4, 88.7, 301.1, 211.4)]
EMB_TOL = 1e-4
METHODS = ["gather", "pallas", "mxu"]


@pytest.fixture(scope="module")
def frames():
    return np.stack([load_image(ROT / n) for n in FRAMES])


@pytest.fixture(scope="module")
def models():
    return {m: (JaxFaceEmbeddings(model_path=DEMO, warp_method=m),
                FaceEmbeddings(model_path=DEMO, warp_method=m,
                               device="cpu"))
            for m in METHODS}


def _norm_boxes(size):
    w, h = size
    return np.array([[[x0 / w, y0 / h], [x1 / w, y1 / h]]
                     for x0, y0, x1, y1 in BOXES], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demo_net_matches_build_jax_fn(dtype):
    path = _DATA_DIR / "demo" / "face_embeddings.npz"
    jg, tg = JaxGraph(path), Graph(path)
    x = np.random.default_rng(0).uniform(0, 1, (3, 112, 112, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(build_jax_fn(
        jg, compute_dtype=getattr(jnp, dtype)))(x)[0])
    net = TFLiteNet(tg, compute_dtype=getattr(torch, dtype)).eval()
    assert net.runs == []
    with torch.inference_mode():
        (got,) = net(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (3, 128)
    tol = 1e-4 if dtype == "float32" else 2e-2
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("method", METHODS)
def test_infer_matches_jax(models, frames, method):
    jm, tm = models[method]
    for img, box in zip(frames, BOXES):
        with jax.disable_jit():
            want = jm.infer(img, JaxBBox(*box))
        got = tm.infer(img, BBox(*box))
        assert got.shape == want.shape == (128,)
        assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
        assert float(np.abs(got - want).max()) <= EMB_TOL, method
        # a (xmin, ymin, xmax, ymax) tuple means the same box
        np.testing.assert_array_equal(tm.infer(img, box), got)


@pytest.mark.parametrize("method", METHODS)
def test_infer_batch_matches_jax(models, frames, method):
    jm, tm = models[method]
    with jax.disable_jit():
        want = jm.infer_batch(frames, BOXES)
    got = tm.infer_batch(frames, BOXES)
    assert got.shape == want.shape == (2, 128)
    assert float(np.abs(got - want).max()) <= EMB_TOL
    with pytest.raises(ValueError, match="bboxes"):
        tm.infer_batch(frames, BOXES[:1])


@pytest.mark.parametrize("form", ["corners", "rows4", "mesh", "faces",
                                  "planar", "device"])
def test_embed_boxes_matches_jax(models, frames, form):
    jm, tm = models["pallas"]
    size = (frames.shape[2], frames.shape[1])
    boxes = _norm_boxes(size)
    images, layout, as_numpy = frames, "hwc", True
    if form == "rows4":
        boxes = boxes.reshape(2, 4)
    elif form == "mesh":
        # 468 landmarks inside each box, with both corners among them
        rng = np.random.default_rng(1)
        t = rng.uniform(0, 1, (2, 468, 2)).astype(np.float32)
        t[:, 0], t[:, 1] = 0.0, 1.0
        xy = boxes[:, :1] + t * (boxes[:, 1:] - boxes[:, :1])
        boxes = np.concatenate([xy, rng.uniform(-0.1, 0.1, (2, 468, 1))
                                .astype(np.float32)], axis=-1)
    elif form == "faces":
        # a face axis K = 3: the box, the other frame's box, a
        # degenerate box (finite garbage)
        boxes = np.stack([boxes, boxes[::-1],
                          np.zeros((2, 2, 2), np.float32)], axis=1)
    elif form == "planar":
        images, layout = np.ascontiguousarray(
            frames.transpose(0, 3, 1, 2)), "planar"
    elif form == "device":
        boxes, as_numpy = torch.from_numpy(boxes), False
    with jax.disable_jit():
        want = jm.embed_boxes(images, np.asarray(boxes), layout=layout)
    got = tm.embed_boxes(images, boxes, as_numpy=as_numpy, layout=layout)
    if form == "device":
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= EMB_TOL, form


def test_embed_boxes_crop_matches_infer(models, frames):
    """A box given as normalized corners crops what ``infer`` crops from
    the same absolute box (the shared int-truncated rule)."""
    _, tm = models["pallas"]
    size = (frames.shape[2], frames.shape[1])
    got = tm.embed_boxes(frames, _norm_boxes(size))
    want = tm.infer_batch(frames, BOXES)
    assert float(np.abs(got - want).max()) <= EMB_TOL


def test_pallas_crop_calls_no_warp_kernel(models, frames, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the embedding crop called a warp kernel")

    for name in ("warp_bilinear", "warp_bilinear_strips",
                 "warp_bilinear_segments", "warp_sample_multi"):
        monkeypatch.setattr(warp, name, refuse)
    _, tm = models["pallas"]
    out = tm.infer_batch(frames, BOXES)
    assert np.isfinite(out).all()


def test_embed_boxes_rejects_bad_shapes(models, frames):
    _, tm = models["pallas"]
    boxes = _norm_boxes((540, 360))
    with pytest.raises(ValueError, match="leading dims"):
        tm.embed_boxes(frames, boxes[:1])
    with pytest.raises(ValueError, match="layout"):
        tm.embed_boxes(frames, boxes, layout="chw")
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\]"):
        tm.embed_boxes(frames[0], boxes)


def test_missing_model_and_empty_bbox(tmp_path, models, frames):
    with pytest.raises(FileNotFoundError, match="not bundled"):
        FaceEmbeddings(model_path=str(tmp_path), device="cpu")
    # the JAX package's data directory holds no real embeddings model
    with pytest.raises(FileNotFoundError, match="convert_tflite"):
        FaceEmbeddings(device="cpu")
    _, tm = models["gather"]
    with pytest.raises(ValueError, match="empty crop"):
        tm.infer(frames[0], BBox(10.0, 10.0, 10.0, 50.0))


def test_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FaceEmbeddings(model_path=DEMO)


def test_feature_count_and_vector_helpers():
    assert {int(f) for f in FeatureCount} == {int(f) for f in
                                              JaxFeatureCount} == {128, 512}
    assert [f.name for f in FeatureCount] == [f.name for f in
                                              JaxFeatureCount]
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 128)).astype(np.float32)
    np.testing.assert_array_equal(image_io.l2_norm(a), jio.l2_norm(a))
    m = rng.normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_array_equal(image_io.l2_norm(m), jio.l2_norm(m))
    assert image_io.similarity_score(a, b) == jio.similarity_score(a, b)
    assert image_io.similarity_score(a, a) == pytest.approx(1.0, abs=1e-6)
