"""tpu_face_torch with bf16 nets (``compute_dtype=torch.bfloat16``) on the
CPU, against the JAX package's bf16 path.

* ``TFLiteNet`` in bf16 against ``build_jax_fn(..., compute_dtype=
  jnp.bfloat16)`` for the BACK, FRONT and SHORT detectors and the mesh
  and iris nets, on the same seeded input at batch 2: max abs error <=
  2e-2 * max|JAX output| (chip_smoke.py's bf16 tolerance for the BACK
  net fused against op by op); the residual runs against the op-by-op
  net in bf16.
* ``separable_sample_planar(..., dot_dtype=bf16)`` against JAX's at
  1280x720 and 1920x1080: at most one uint8 level.
* ``FaceCascade(compute_dtype=bf16)`` on the five ground-truth frames
  (the rotated 540p frames and the 704x704 close-up) against the ground
  truth (bbox IoU >= 0.99, landmarks <= 1 px) and against JAX's bf16
  cascade (``warp_method="gather"``).  The two libraries round their bf16
  convolutions at other places, so their nets' outputs differ by a bf16
  step here and there.  Held, as measured on these frames: equal bools;
  scores within 1e-2 (measured <= 5.3e-3); the detection, the iris points
  and the nose within 1 px (<= 0.80 px); the mesh in steps of the mesh
  net's bf16 output (1.0 in its 192-px input above 128, i.e. ROI / 192
  px in the frame, 0.95-1.8 px here): on average within half a step
  (<= 0.39) and everywhere within two steps (<= 1.54).
* The same cascade on a 1280x720 frame, where the bf16 detection dots
  switch on, against JAX's: the same rules (mesh <= 0.42 steps on
  average, <= 1.73 at most), with the detection within 2 px (measured
  1.38 px; one step of the detector's bf16 box output is ~2.5 px at this
  frame size).

The bf16 standalone models are in tests/test_torch_bf16_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rotation_e2e import FRAMES_540, GT, ROT, _check_cascade
from test_torch_threads import share_cores  # noqa: F401
from tpu_face.compiler import Graph as JaxGraph
from tpu_face.compiler import build_jax_fn
from tpu_face.ops import image as jimage
from tpu_face.pipeline import FaceCascade as JaxFaceCascade
from tpu_face_torch import exact_f32
from tpu_face_torch import models as tm
from tpu_face_torch.compiler import Graph, TFLiteNet, params_from_consts
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.ops import fused_block
from tpu_face_torch.ops import image as timage
from tpu_face_torch.ops import warp
from tpu_face_torch.pipeline import FaceCascade
from tpu_face_torch.utils.image_io import load_image

BF16 = torch.bfloat16
DETECTORS = ("face_detection_back", "face_detection_front",
             "face_detection_short_range")
NETS = DETECTORS + ("face_landmark", "iris_landmark")
NET_TOL = 2e-2          # x max|JAX output|
PX_TOL = 1.0            # detection, iris, nose
MESH_MEAN_STEPS = 0.5   # bf16 steps of the mesh net's output (ROI / 192)
MESH_STEPS = 2.0
SCORE_TOL = 1e-2
FRAMES = FRAMES_540 + ["man_closeup_rotp30.png"]


@pytest.fixture(scope="module")
def graphs():
    return {n: (JaxGraph(_DATA_DIR / f"{n}.npz"),
                Graph(_DATA_DIR / f"{n}.npz")) for n in NETS}


@pytest.mark.parametrize("name", NETS)
def test_net_matches_build_jax_fn_bf16(graphs, name):
    jg, tg = graphs[name]
    params = params_from_consts(jg.ops, jg.consts)
    net = TFLiteNet(tg, params, compute_dtype=BF16).eval()
    x = np.random.default_rng(0).uniform(
        -1.0, 1.0, (2,) + tuple(jg.input_shape[1:])).astype(np.float32)
    want = jax.jit(build_jax_fn(jg, compute_dtype=jnp.bfloat16))(x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= NET_TOL * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("name", DETECTORS)
def test_residual_runs_match_op_by_op_bf16(graphs, name):
    """The runs go to ``fused_blocks`` with bf16 activations (on the CPU
    its plain version, the per-op arithmetic, bit for bit), and the net
    counts the launches of the bf16 plan."""
    _, tg = graphs[name]
    fused = TFLiteNet(tg, compute_dtype=BF16).eval()
    per_op = TFLiteNet(tg, fuse_blocks=False, compute_dtype=BF16).eval()
    assert fused.runs and all(getattr(fused, f"run{k}_wd").dtype == BF16
                              for k in range(len(fused.runs)))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.0, 1.0, (2,) + tuple(tg.input_shape[1:])).astype(np.float32))
    seen = []
    real = fused_block.fused_blocks

    def spy(x_, *w, **kw):
        seen.append(x_.dtype)
        return real(x_, *w, **kw)

    fused_block.fused_blocks = spy
    try:
        with torch.inference_mode():
            got, want = fused(x), per_op(x)
    finally:
        fused_block.fused_blocks = real
    assert seen == [BF16] * len(fused.runs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused.fused_launches() == fused.fused_launches(2) == sum(
        len(fused_block.plan(c, h, w, n, 2)[1])
        for c, h, w, n in fused.run_shapes)


def test_compute_dtypes(graphs):
    """bf16 nets hold bf16 weights, f32 nets f32 ones; other types
    raise."""
    _, tg = graphs["iris_landmark"]
    for dtype in (torch.float32, BF16):
        net = TFLiteNet(tg, compute_dtype=dtype)
        assert {b.dtype for b in net.buffers()} == {dtype}
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError):
            TFLiteNet(tg, compute_dtype=dtype)
        with pytest.raises(NotImplementedError):
            FaceCascade(device="cpu", compute_dtype=dtype)
        with pytest.raises(NotImplementedError):
            tm.IrisLandmark(device="cpu", compute_dtype=dtype)


@pytest.mark.parametrize("size", [(1280, 720), (1920, 1080)])
def test_detection_dots_bf16_match_jax(size):
    w, h = size
    frame = np.random.default_rng(w).integers(0, 256, (h, w, 3),
                                              dtype=np.uint8)
    whole = jnp.array([0.5 * w, 0.5 * h, w, h, 0.0], jnp.float32)
    jx, jy, _ = jimage._source_coords(whole, (256, 256), True, False)
    want = np.asarray(jimage.separable_sample_planar(
        jnp.asarray(frame, jnp.bfloat16).transpose(2, 0, 1), jx, jy,
        dot_dtype=jnp.bfloat16))
    planes = warp.make_planes(torch.from_numpy(frame[None]), dtype=BF16)
    tx, ty = torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jy))
    with exact_f32():
        got = timage.separable_sample_planar(planes, tx, ty, dot_dtype=BF16)
        exact = timage.separable_sample_planar(planes, tx, ty)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 256, 256,
                                                               3)
    assert np.abs(np.round(got[0].numpy()) - np.round(want)).max() <= 1.0
    assert float((got.round() - exact.round()).abs().max()) <= 1.0
    with pytest.raises(ValueError):
        timage.separable_sample_planar(planes, tx, ty,
                                       dot_dtype=torch.float16)


def _px(a, b, size):
    """Per-point x/y distance in px of [..., P, >=2] normalized points,
    flattened to [faces, P]."""
    d = np.abs(np.asarray(a)[..., :2] - np.asarray(b)[..., :2])
    d = (d * np.array(size, np.float32)).max(-1)
    return d.reshape(-1, d.shape[-1])


def _compare(res, ref, size, det_tol=PX_TOL):
    """Port bf16 result vs JAX bf16 result for the same frames ([B]
    leading axis, one face each), by the rules of the module doc."""
    for f in res._fields:
        a = getattr(res, f).numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(a, np.asarray(getattr(ref, f)),
                                          err_msg=f)
    for f in ("score", "mesh_score"):
        d = np.abs(getattr(res, f).numpy() - np.asarray(getattr(ref, f)))
        assert d.max() <= SCORE_TOL, (f, d.max())
    assert _px(res.detection, ref.detection, size).max() <= det_tol
    assert _px(res.iris.reshape(-1, 10, 3), np.asarray(ref.iris).reshape(
        -1, 10, 3), size).max() <= PX_TOL
    mesh = np.maximum(_px(res.mesh, ref.mesh, size),
                      _px(res.mesh_raw, ref.mesh_raw, size))
    assert mesh[:, 1].max() <= PX_TOL, mesh[:, 1]            # the nose
    roi_px = (np.asarray(ref.face_roi)[:, 2:4]
              * np.array(size, np.float32)).max(-1)
    _check_mesh_steps(mesh, roi_px)


def _check_mesh_steps(mesh, roi_px):
    """Mesh differences [faces, 468] px in steps of the mesh net's bf16
    output, ROI / 192 px for faces of ROI side ``roi_px`` [faces]."""
    steps = mesh / (np.asarray(roi_px, np.float32)[:, None] / 192.0)
    assert steps.mean(-1).max() <= MESH_MEAN_STEPS, steps.mean(-1)
    assert steps.max() <= MESH_STEPS, steps.max()


@pytest.fixture(scope="module")
def cascades():
    return (FaceCascade(device="cpu", compute_dtype=BF16),
            JaxFaceCascade(warp_method="gather", compute_dtype=jnp.bfloat16))


@pytest.fixture(scope="module")
def results(cascades):
    """{frame: (port result, JAX result)}, one frame each (the 540p frames
    computed as one batch)."""
    mine, theirs = cascades
    batch = np.stack([load_image(ROT / n) for n in FRAMES_540])
    a, b = mine.infer_batch(batch), theirs.infer_batch(batch)
    out = {n: (type(a)(*(f[i:i + 1] for f in a)),
               type(b)(*(f[i:i + 1] for f in b)))
           for i, n in enumerate(FRAMES_540)}
    img = load_image(ROT / "man_closeup_rotp30.png")[None]
    out["man_closeup_rotp30.png"] = (mine.infer_batch(img),
                                     theirs.infer_batch(img))
    return out


@pytest.mark.parametrize("name", FRAMES)
def test_cascade_bf16_matches_ground_truth(results, name):
    _check_cascade(results[name][0], GT[name])


@pytest.mark.parametrize("name", FRAMES)
def test_cascade_bf16_matches_jax(results, name):
    _compare(*results[name], GT[name]["size"])


def test_cascade_bf16_at_720p_takes_bf16_dots(cascades, monkeypatch):
    """A 1280x720 frame (man_rotp15.png doubled, on black): above 720 px
    the bf16 cascade's detection warp runs bf16 dots (f32 planes, as the
    plane type follows the frame size alone); the f32 cascade's does not.
    JAX's gather arm takes no bf16 dots (its detection input is the exact
    warp, within one level of the dots: the test above), so the detection
    is held to 2 px here."""
    mine, theirs = cascades
    frame = np.zeros((720, 1280, 3), np.uint8)
    frame[:, 100:1180] = np.repeat(np.repeat(
        load_image(ROT / "man_rotp15.png"), 2, 0), 2, 1)
    dots = []
    real = timage.separable_sample_planar

    def spy(planes, x, y, dot_dtype=None):
        dots.append((planes.dtype, dot_dtype))
        return real(planes, x, y, dot_dtype=dot_dtype)

    monkeypatch.setattr(timage, "separable_sample_planar", spy)
    res = mine.infer_batch(frame[None])
    FaceCascade(device="cpu").infer_batch(frame[None])
    assert dots == [(torch.float32, BF16), (torch.float32, None)]
    assert bool(res.mesh_valid[0])
    _compare(res, theirs.infer_batch(frame[None]), (1280, 720), det_tol=2.0)
