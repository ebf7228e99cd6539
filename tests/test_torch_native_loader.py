"""tpu_face_torch.utils.native_loader: the ctypes binding of
native/jpeg_loader.cc, built by the port into build/tpu_face_torch/.

* The library is compiled from the source at first use into the
  git-ignored ``build/tpu_face_torch/`` under a name keyed by the
  source's hash, and loaded from there (never from ``native/``).
* JPEGs written by Pillow into ``tmp_path`` from the rotated frames decode
  equal to the JAX package's loader (the same source and libjpeg) and
  within the JAX loader test's bound of Pillow (mean < 1 level, max <= 16);
  ``jpeg_info``, ``decode_jpeg_batch`` (hwc and planar, zero-filled bad
  frames, ``strict``), ``load_jpeg_batch`` and ``mjpeg_split`` as in the
  JAX module.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from test_rotation_e2e import ROT
from tpu_face.utils import native_loader as jloader
from tpu_face_torch.utils import native_loader
from tpu_face_torch.utils.image_io import load_image

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["man_rotp15.png", "man_rotm30.png", "russ2_rotp20.png"]


@pytest.fixture(autouse=True)
def built():
    """Decided in a fixture, not at import: the workers must collect the
    same tests."""
    if not native_loader.available():
        pytest.skip("the native loader needs g++ and libjpeg")


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """{name: (path, bytes)} of JPEGs Pillow wrote from the frames."""
    d = tmp_path_factory.mktemp("jpeg")
    out = {}
    for name in NAMES:
        path = d / name.replace(".png", ".jpg")
        Image.fromarray(load_image(ROT / name)).save(path, quality=90)
        out[name] = (path, path.read_bytes())
    return out


def test_library_is_built_under_build(jpegs):
    so = native_loader.library_path()
    assert so.parent == ROOT / "build" / "tpu_face_torch"
    assert so.exists() and so.name.startswith("libtpuface_loader_")
    assert Path(native_loader._load()._name) == so
    assert native_loader.SOURCE == ROOT / "native" / "jpeg_loader.cc"


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_jax_loader_and_pillow(jpegs, name):
    path, data = jpegs[name]
    pil = load_image(path)
    assert native_loader.jpeg_info(data) == (pil.shape[1], pil.shape[0])
    ours = native_loader.decode_jpeg(data)
    assert ours.shape == pil.shape and ours.dtype == np.uint8
    if jloader.available():
        np.testing.assert_array_equal(ours, jloader.decode_jpeg(data))
    diff = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
    assert diff.mean() < 1.0 and diff.max() <= 16, (diff.mean(),
                                                    diff.max())


def test_batches(jpegs):
    path, data = jpegs["man_rotp15.png"]
    one = native_loader.decode_jpeg(data)
    hwc = native_loader.decode_jpeg_batch([data] * 3, 540, 360,
                                          num_threads=2)
    assert hwc.shape == (3, 360, 540, 3)
    for frame in hwc:
        np.testing.assert_array_equal(frame, one)
    planar = native_loader.decode_jpeg_batch([data] * 2, 540, 360,
                                             planar=True)
    np.testing.assert_array_equal(planar, hwc[:2].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        native_loader.load_jpeg_batch([path, path], 540, 360), hwc[:2])
    with pytest.warns(UserWarning, match="1/2 frames"):
        out = native_loader.decode_jpeg_batch([data, b"not a jpeg"], 540,
                                              360)
    assert out[1].sum() == 0
    np.testing.assert_array_equal(out[0], one)
    with pytest.raises(ValueError, match="failed to decode"):
        native_loader.decode_jpeg_batch([data], 123, 45, strict=True)
    assert native_loader.decode_jpeg(b"not a jpeg") is None
    assert native_loader.decode_jpeg_batch([], 540, 360).shape == (
        0, 360, 540, 3)


def test_mjpeg_split_roundtrip(jpegs):
    datas = [jpegs[n][1] for n in NAMES]
    stream = b"".join(datas)
    assert native_loader.mjpeg_split(stream) == datas
    assert native_loader.mjpeg_split(stream, max_frames=2) == datas[:2]
    if jloader.available():
        assert jloader.mjpeg_split(stream) == datas
