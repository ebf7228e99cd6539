"""tpu_face_torch.utils.profiling: stage labels for torch.profiler.

* ``stage(name)`` is a no-op until enabled (``enable()`` or
  ``TPU_FACE_PROFILE``), then a ``record_function`` event
  ``tpu_face/<name>``.
* ``EmbedCascade.infer_batch`` and ``FaceCascade.infer_batch`` label the
  call and their stages (the JAX package's ``named_scope`` names) while
  profiling is on, and nothing while it is off.
* ``device_trace(log_dir)`` writes a Chrome trace of the region.
"""

import importlib
import json

import pytest
import torch

from test_rotation_e2e import ROT
from tpu_face_torch.models.face_detection import _DATA_DIR
from tpu_face_torch.pipeline import EmbedCascade, FaceCascade
from tpu_face_torch.utils import profiling
from tpu_face_torch.utils.image_io import load_image


@pytest.fixture
def profiling_on():
    profiling.enable()
    yield
    profiling.enable(False)


def _labels(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events() if e.name.startswith("tpu_face/")}


def _work():
    with profiling.stage("unit"):
        torch.ones(8).add_(1)


def test_stage_is_a_no_op_until_enabled():
    assert not profiling.enabled()
    assert _labels(_work) == set()


def test_stage_records_when_enabled(profiling_on):
    assert profiling.enabled()
    assert _labels(_work) == {"tpu_face/unit"}


def test_switch_reads_the_environment(monkeypatch):
    try:
        monkeypatch.setenv("TPU_FACE_PROFILE", "1")
        assert importlib.reload(profiling).enabled()
        monkeypatch.setenv("TPU_FACE_PROFILE", "0")
        assert not importlib.reload(profiling).enabled()
    finally:
        monkeypatch.delenv("TPU_FACE_PROFILE")
        importlib.reload(profiling)


@pytest.fixture(scope="module")
def frame():
    return load_image(ROT / "man_rotp15.png")[None]


def test_cascades_label_their_stages(frame, profiling_on):
    embed = EmbedCascade(embed_model_path=str(_DATA_DIR / "demo"),
                         device="cpu")
    assert _labels(lambda: embed.infer_batch(frame)) == {
        "tpu_face/embed_cascade.infer_batch", "tpu_face/detect",
        "tpu_face/nms", "tpu_face/embed_crop", "tpu_face/embed"}
    cascade = FaceCascade(device="cpu")
    assert _labels(lambda: cascade.infer_batch(frame)) == {
        "tpu_face/cascade.infer_batch", "tpu_face/detect", "tpu_face/nms",
        "tpu_face/mesh_warp", "tpu_face/mesh", "tpu_face/iris_warp",
        "tpu_face/iris"}
    profiling.enable(False)
    assert _labels(lambda: cascade.infer_batch(frame)) == set()


def test_device_trace_writes_a_chrome_trace(tmp_path, profiling_on):
    with profiling.device_trace(tmp_path / "trace") as prof:
        _work()
    assert any(e.name == "tpu_face/unit" for e in prof.events())
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "tpu_face/unit" for e in events)
