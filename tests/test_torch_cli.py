"""``python -m tpu_face_torch`` on the CPU (``--device cpu``), against
``python -m tpu_face`` given the same arguments on the rotated frames.

The JSON lines must match field by field: the same keys, equal counts,
flags and ``crop_bbox`` values; scores within 1e-3, coordinates within
0.25 px (``--pixels``; tests/test_torch_cascade.py's rules), and the
rounded cosine similarities within 1e-3 (the embeddings agree within
1.2e-4, tests/test_torch_embed_cascade.py).  Covered: ``detect`` (with
``--render``), ``mesh``, ``iris``, ``embed`` (a missing model, and the
demo graph beside the BACK detector in one model directory),
``cascade``, ``identify`` (the demo graph by default), ``track`` over
frames (with ``--smooth``) and over an MJPEG stream, and ``info``.
Without ``--device`` a command needs the card and raises without one.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from test_rotation_e2e import ROT
from tpu_face.__main__ import main as jax_main
from tpu_face_torch.__main__ import main
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.utils import native_loader
from tpu_face_torch.utils.image_io import load_image

PX_TOL = 0.25
SCORE_TOL = 1e-3
COSINE_TOL = 1e-3
FRAMES = [str(ROT / n) for n in ("man_rotp15.png", "man_rotm30.png",
                                 "man_rotp30.png")]


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, [json.loads(line) for line in
                out.getvalue().strip().splitlines()]


def _close(got, want, key=""):
    """Recursive JSON comparison under the module's rules."""
    if isinstance(want, dict):
        assert set(got) == set(want), (key, set(got) ^ set(want))
        for k in want:
            _close(got[k], want[k], k)
    elif isinstance(want, list):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _close(g, w, key)
    elif isinstance(want, bool) or isinstance(want, str) or key in (
            "crop_bbox", "dim", "frame", "frames", "detector_skipped_on"):
        assert got == want, (key, got, want)
    else:
        tol = {"score": SCORE_TOL,
               "cosine_similarity": COSINE_TOL}.get(key, PX_TOL)
        assert abs(got - want) <= tol, (key, got, want)


def _both(argv):
    """The port's JSON lines, once both CLIs exited 0 and the lines
    matched."""
    jrc, want = _run(jax_main, argv)
    rc, got = _run(main, argv + ["--device", "cpu"])
    assert rc == jrc == 0, (rc, jrc, got)
    _close(got, want)
    return got


@pytest.mark.parametrize("model", ["back", "short"])
def test_detect(model, tmp_path):
    (out,) = _both(["detect", FRAMES[0], "--model", model, "--pixels"])
    assert len(out["faces"]) == 1
    png = tmp_path / "det.png"
    rc, (rendered,) = _run(main, ["detect", FRAMES[0], "--render",
                                  str(png), "--device", "cpu"])
    assert rc == 0 and rendered["render"] == str(png)
    assert Image.open(png).size == (540, 360)


@pytest.mark.parametrize("cmd", ["mesh", "iris"])
def test_mesh_and_iris(cmd):
    (out,) = _both([cmd, FRAMES[1], "--pixels"])
    assert len(out["mesh"]) == 468


def test_embed(tmp_path):
    rc, (err,) = _run(main, ["embed", FRAMES[0], FRAMES[1], "--device",
                             "cpu"])
    assert rc == 1 and "convert_tflite" in err["error"]
    # one model directory holds the detector and the embeddings graph,
    # as the reference's constructor takes it
    for src in (_DATA_DIR / "face_detection_back.npz",
                _DATA_DIR / "demo" / "face_embeddings.npz"):
        (tmp_path / src.name).symlink_to(src)
    (out,) = _both(["embed", FRAMES[0], FRAMES[1], "--model-path",
                    str(tmp_path)])
    assert out["dim"] == 128


def test_cascade():
    lines = _both(["cascade", *FRAMES, "--pixels", "--max-faces", "2"])
    assert len(lines) == 3
    assert all(len(line["faces"]) == 1 for line in lines)


def test_identify_defaults_to_the_demo_graph():
    lines = _both(["identify", *FRAMES])
    assert len(lines) == 4
    assert all(line["demo_weights"] is True for line in lines)
    assert len(lines[3]["pairs"]) == 3


@pytest.fixture(scope="module")
def panned(tmp_path_factory):
    """Four frames of man_rotp15 panned 3 px a frame, as PNG files and as
    one MJPEG stream."""
    d = tmp_path_factory.mktemp("track")
    img = load_image(ROT / "man_rotp15.png")
    paths, jpegs = [], []
    for i in range(4):
        frame = Image.fromarray(np.roll(img, 3 * i, axis=1))
        paths.append(str(d / f"f{i}.png"))
        frame.save(paths[-1])
        buf = io.BytesIO()
        frame.save(buf, format="JPEG", quality=92)
        jpegs.append(buf.getvalue())
    stream = d / "clip.mjpeg"
    stream.write_bytes(b"".join(jpegs))
    return paths, str(stream)


@pytest.mark.parametrize("smooth", [False, True])
def test_track_frames(panned, smooth):
    paths, _ = panned
    lines = _both(["track", *paths, "--pixels"]
                  + (["--smooth"] if smooth else []))
    assert [line.get("detector_skipped") for line in lines[:4]] == [
        False, True, True, True]
    assert lines[4] == {"frames": 4, "detector_skipped_on": 3,
                        "smoothing": smooth}


def test_track_mjpeg(panned):
    if not native_loader.available():
        pytest.skip("the native loader needs g++ and libjpeg")
    _, stream = panned
    lines = _both(["track", stream, "--pixels", "--max-faces", "2"])
    assert len(lines) == 5 and all(len(line["faces"]) == 1
                                   for line in lines[:4])


def test_info():
    rc, (out,) = _run(main, ["info", "--device", "cpu"])
    assert rc == 0
    assert (out["backend"], out["device"]) == ("cpu", "cpu")
    assert out["torch"] == torch.__version__
    assert {"back", "full", "face_landmark", "iris_landmark",
            "face_embeddings_demo"} <= set(out["models"])
    assert isinstance(out["native_loader"], bool)


@pytest.mark.parametrize("argv", [["info"], ["cascade", FRAMES[0]],
                                  ["identify", FRAMES[0]]])
def test_needs_the_card_unless_told(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
