"""tpu_face_torch.bench (``python -m tpu_face_torch.bench``) on the CPU.

* ``_distinct_batch``: the shape, frame 0 untouched, the same seed gives
  the same batch.
* The accuracy gate holds frame 0 (man_rotp15.png) to its ground truth:
  it passes on the port's CPU cascade and fails on a shifted box or nose.
* ``mfu_pct`` / ``hbm_gbps`` from given frames/s against the H100's
  peaks, null off the card; the FLOPs and bytes per frame are the
  graphs' and the traffic model's.
* ``main`` in-process at batch 2 with short windows: the last line is
  the record, naming the CPU, with ``mfu_pct`` and ``hbm_gbps`` null.
  The rows it leaves off (latencies, variants, hires) run on the card in
  chip_smoke.py's bench phase.
* ``main`` without ``--device`` raises without a card; a row that fails
  raises and prints no record (no ``*_error`` keys).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_threads import share_cores  # noqa: F401
from tpu_face_torch import bench, pipeline
from tpu_face_torch.compiler import Graph, graph_flops, traffic
from tpu_face_torch.models.face_detection import (_DATA_DIR,
                                                  FaceDetectionModel)
from tpu_face_torch.utils.image_io import load_image

SMALL = ["--device", "cpu", "--batch", "2", "--iters", "1", "--warmup",
         "0", "--repeats", "1", "--skip-p50", "--no-hires", "--no-variants",
         "--dtype", "f32"]


@pytest.fixture(scope="module")
def img():
    return load_image(bench.ROT / bench.FRAME)


@pytest.fixture(scope="module")
def result(img):
    """The port's CPU cascade on the gate's frame."""
    return pipeline.FaceCascade(device="cpu")(
        torch.from_numpy(img[None].copy()))


class _HostValues(TorchDispatchMode):
    """Records the ops that bring a host value into a tensor or read one
    back: a CUDA graph cannot capture them."""

    OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kw", [{}, {"compute_dtype": torch.bfloat16},
                                {"max_faces": 2}])
def test_cascade_call_is_graph_capturable(img, kw):
    """The device-only latency rows capture one cascade call as a CUDA
    graph: the call (after its first, which caches the detection warp's
    coordinates) neither copies a host value in nor reads one back."""
    cascade = pipeline.FaceCascade(warp_method="pallas", device="cpu", **kw)
    x = torch.from_numpy(img[None].copy())
    cascade(x)
    with _HostValues() as mode:
        cascade(x)
    assert mode.seen == []


def test_distinct_batch(img):
    a = bench._distinct_batch(img, 12, np.random.default_rng(0))
    assert a.shape == (12,) + img.shape and a.dtype == np.uint8
    np.testing.assert_array_equal(a[0], img)
    np.testing.assert_array_equal(
        a, bench._distinct_batch(img, 12, np.random.default_rng(0)))
    b = bench._distinct_batch(img, 12, np.random.default_rng(1))
    assert not np.array_equal(a[1:], b[1:])
    # every other frame is shifted, mirrored, jittered or a portrait
    assert all(not np.array_equal(f, img) for f in a[1:])
    assert bench._distinct_batch(img, 1, np.random.default_rng(0)).shape \
        == (1,) + img.shape


def test_gate_passes_on_the_cpu_cascade(result):
    ok, iou, nose = bench._accuracy_ok(result)
    assert ok and iou >= 0.99
    assert abs(nose[0] - bench.GT["nose"][0]) <= 1.0
    worst, box_iou = bench._points_px(result)
    assert worst <= 1.0 and box_iou == pytest.approx(iou)


def test_gate_fails_on_a_shifted_box_or_nose(result):
    det = result.detection.clone()
    det[:, :2, 0] += 3.0 / 540                  # the box 3 px to the right
    ok, iou, _ = bench._accuracy_ok(result._replace(detection=det))
    assert not ok and iou < 0.99
    raw = result.mesh_raw.clone()
    raw[:, 1, 1] += 1.5 / 360                   # the nose 1.5 px down
    assert not bench._accuracy_ok(result._replace(mesh_raw=raw))[0]


def test_box_iou():
    assert bench.box_iou((0, 0, 2, 2), (0, 0, 2, 2)) == 1.0
    assert bench.box_iou((0, 0, 2, 2), (1, 0, 3, 2)) == pytest.approx(1 / 3)
    assert bench.box_iou((0, 0, 1, 1), (2, 2, 3, 3)) == 0.0


def test_utilization_arithmetic():
    fps, flops, nbytes = 2000.0, 1.5e9, 7.0e7
    mfu, peak, gbps = bench.utilization(fps, flops, nbytes, torch.bfloat16,
                                        "cuda")
    assert peak == 989.0
    assert mfu == pytest.approx(100 * 2000 * 1.5e9 / 989e12)
    assert gbps == pytest.approx(2000 * 7.0e7 / 1e9)
    mfu, peak, _ = bench.utilization(fps, flops, nbytes, torch.float32,
                                     "cuda:0")
    assert peak == 67.0 and mfu == pytest.approx(100 * 3e12 / 67e12)
    assert bench.utilization(fps, flops, nbytes, torch.float32, "cpu") \
        == (None, None, None)


@pytest.mark.parametrize("act_bytes", [2, 4])
def test_cascade_costs(act_bytes):
    flops, bpf = bench.cascade_costs(FaceDetectionModel.BACK_CAMERA,
                                     (540, 360), 64, act_bytes)
    graphs = [Graph(_DATA_DIR / f"{n}.npz") for n in (
        "face_detection_back", "face_landmark", "iris_landmark")]
    assert flops == (graph_flops(graphs[0]) + graph_flops(graphs[1])
                     + 2 * graph_flops(graphs[2]))
    assert bpf == traffic.cascade_bytes_per_frame((540, 360), 64, *graphs,
                                                  act_bytes=act_bytes)


def test_face_grid_and_hires_frames(img):
    grid = bench.face_grid(img)
    assert grid.shape[0] % 2 == 0 and grid.shape[1] % 2 == 0
    h, w = grid.shape[0] // 2, grid.shape[1] // 2
    np.testing.assert_array_equal(grid[:h, :w], grid[h:, w:])
    x0, y0, x1, y1 = bench.GT["bbox"]
    assert w >= x1 - x0 and h >= y1 - y0
    frames, canvas = bench.hires_frames(Image.fromarray(img), 1080, 4,
                                        np.random.default_rng(0))
    assert frames.shape == (4, 3, 1080, 1920) and canvas.shape == (
        1080, 1920, 3)
    np.testing.assert_array_equal(frames[0], canvas.transpose(2, 0, 1))
    # letterboxed 3x (540x360 -> 1620x1080), black bars left and right
    assert not canvas[:, :150].any() and not canvas[:, -150:].any()
    assert canvas[:, 150:1770].any()


def test_main_on_the_cpu(capsys):
    assert bench.main(SMALL) == 0
    out = capsys.readouterr().out.strip().splitlines()
    record = json.loads(out[-1])
    assert record["device"]["platform"] == "cpu"
    assert record["mfu_pct"] is None and record["hbm_gbps"] is None
    assert record["mfu_peak_tflops"] is None
    assert record["metric"] == "cascade_fps_per_chip"
    assert record["gate_dtype"] == "f32" and record["gate_iou"] >= 0.99
    assert record["iou_f32"] == record["gate_iou"]
    for row in ("value", "rtt_ms", "tracking_fps_per_chip",
                "embed_fps_per_chip", "multiface_faces_per_s"):
        assert record[row] > 0, row
    # skipped rows are absent; failures never become keys
    assert "p50_batch1_ms" not in record and "fps_short" not in record
    assert "fps_1080p" not in record
    assert not [k for k in record if k.endswith("_error")]


def test_main_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(SMALL[2:])


def test_a_failing_row_raises(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("embed row broke")

    monkeypatch.setattr(pipeline, "EmbedCascade", broken)
    with pytest.raises(RuntimeError, match="embed row broke"):
        bench.main(SMALL + ["--no-tracking", "--no-multiface"])
    out = capsys.readouterr().out
    assert "cascade_fps_per_chip" not in out and "_error" not in out
