"""Full-cascade throughput benchmark of the PyTorch port.

    python -m tpu_face_torch.bench [--device cpu] [--batch N] ...

The counterpart of the JAX package's root ``bench.py``, with its flags,
defaults, rows and record keys.  It measures the fused detect -> ROI ->
mesh -> 2x iris cascade (``tpu_face_torch.pipeline.FaceCascade``) in
frames/s on one card, steady state, and prints one JSON record as the
last line of its standard output:

    {"metric": "cascade_fps_per_chip", "value": N, "unit": "frames/s",
     "vs_baseline": N / 53.8, ..., "device": {...}}

Baseline: the reference's full-cascade compute on its own models is
~53.8 fps (BASELINE.md: TFLite x86, one thread).

Accuracy is gated before timing: frame 0 of the batch is
``assets/rotated/man_rotp15.png``, whose cascade result must reach bbox
IoU >= 0.99 and the nose and left iris within 1 px on each axis of its
ground truth (``tests/test_rotation_e2e.py``); ``--dtype auto`` falls
back from bf16 to f32 nets when bf16 fails it.

Where it differs from the JAX bench:

* the frames come from ``assets/rotated/`` (no external test data);
* ``mfu_pct`` is against the H100's peak for the nets' type (989 TFLOP/s
  bf16, 67 TFLOP/s f32: TF32 is off), ``hbm_gbps`` from the card's
  traffic model (``compiler/traffic.py``) against 3,350 GB/s; both are
  null on ``--device cpu``;
* the device-only latencies replay a CUDA graph of one call behind a
  ``torch.cuda._sleep`` (``queued_ms``); null on the CPU;
* the serving row attaches a ``kind="executable"`` artifact (``aot``: an
  AOTInductor package, whose compile the row waits for), as the JAX
  bench does;
* a row that fails raises: the run exits non-zero and prints no record.

The entry point runs on the CUDA card unless ``--device cpu`` is given,
and raises without one.  The timing helpers (``median_ms``,
``queued_ms``) are shared with ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ROT = ROOT / "assets" / "rotated"
FRAME = "man_rotp15.png"
# _distinct_batch's other photos, resized into the frame's canvas
EXTRA = ("russ2_rotp20.png", "russ2_rotm20.png")
DEMO_EMBED = ROOT / "tpu_face" / "data" / "demo"

# Ground truth of FRAME (TFLite + OpenCV reference transcription; its row
# of tests/test_rotation_e2e.py), pixels of the 540x360 frame.
GT = {"size": (540, 360), "bbox": (184.8, 80.8, 317.5, 213.6),
      "nose": (255.63, 146.75), "iris_l": (219.20, 120.41),
      "iris_r": (271.60, 105.20)}
GATE_IOU = 0.99
GATE_PX = 1.0
# the SHORT and FULL variants: the nose and both irises within this many
# px of the ground truth (taken with the BACK detector's ROIs)
FULL_GT_PX = 2.0

BASELINE_FPS = 53.8     # BASELINE.md reference cascade compute, x86 CPU
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bf16 tensor cores, f32 accumulation

# the hires rows: (label, height, cascade batch, its iterations, tracked
# batch, its iterations), the configurations of the JAX bench's rows
HIRES = (("1080p", 1080, 64, 25, 32, 50),
         ("4k", 2160, 8, 50, 32, 25))

# the rows a run with every row on writes, each a positive number
ROWS = ("value", "iou_f32", "mfu_pct", "hbm_gbps", "rtt_ms",
        "p50_batch1_ms", "p50_device_ms", "p50_device_ms_b8",
        "p50_aot_b8_ms", "tracking_fps_per_chip",
        "tracking_churn_fps_per_chip", "embed_fps_per_chip",
        "multiface_faces_per_s", "fps_short", "fps_full", "fps_1080p",
        "fps_1080p_tracked", "fps_4k", "fps_4k_tracked")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


# ---- timing ----------------------------------------------------------


def sync():
    """Wait for every card (a call's work may span several); nothing
    without one."""
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def window_ms(fn, reps):
    """Host-clock ms per call over ``reps`` back-to-back calls of ``fn``,
    the card synchronized before and after."""
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def median_ms(fn, reps, windows=3, warmup=2):
    """Median over ``windows`` of the mean time of ``reps`` calls of
    ``fn``, from CUDA events, after ``warmup`` calls, and the windows:
    the call time, the host's launch path included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), times


def sleep_cycles(ms):
    """``torch.cuda._sleep`` cycles that keep the card busy ~``ms``, at
    the rate a short sleep runs now (CUDA events)."""
    probe = 10_000_000
    torch.cuda._sleep(probe)            # the kernel loaded, the card awake
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(ms * probe / start.elapsed_time(end))


def queued_ms(fn, reps=5, windows=3):
    """Device time per call of ``fn`` (the kernels it launches, back to
    back): the median over ``windows`` of CUDA events around ``reps``
    calls queued behind a ``torch.cuda._sleep``, so that they run back
    to back on the device and the host's launch path is hidden.  The
    sleep lasts twice the host's measured time to enqueue the ``reps``
    calls (20 ms at least), and each window checks that the host had
    enqueued them all before the sleep ended; otherwise it raises, since
    the time would be the host's.  ``fn`` must read nothing back to the
    host, and the calls must fit the card's launch queue (about a
    thousand launches); a call with more launches is timed as a CUDA
    graph (``graph_of``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = sleep_cycles(max(20.0, 2.0 * host_ms))
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        if start.query():
            raise RuntimeError(
                f"queued_ms: the sleep ended before the host had enqueued "
                f"{reps} calls (host {host_ms:.2f} ms for them unqueued); "
                f"the device time would be the host's")
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_of(fn):
    """One call of ``fn`` captured as a CUDA graph; returns its replay,
    which the device runs as one queue entry (``fn`` warmed up on a side
    stream first, as CUDA graph capture asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph.replay


# ---- frames and gates ------------------------------------------------


def _distinct_batch(img, n, rng):
    """Mixed-content batch: every frame gets a different ROI geometry.

    Frame 0 stays the untouched FRAME (the accuracy gate's ground truth);
    the rest are circular shifts (moves the face, so every warp's
    geometry differs), horizontal flips (mirrors ROI rotation) and
    brightness jitter of it, and every fifth one of the EXTRA portraits
    resized into the same canvas."""
    from PIL import Image

    h, w = img.shape[:2]
    extra = [np.asarray(Image.open(ROT / p).convert("RGB").resize(
        (w, h), Image.BILINEAR), np.uint8) for p in EXTRA]
    frames = [img]
    while len(frames) < n:
        i = len(frames)
        base = extra[i % len(extra)] if i % 5 == 4 else img
        dy = int(rng.integers(-h // 6, h // 6 + 1))
        dx = int(rng.integers(-w // 6, w // 6 + 1))
        f = np.roll(np.roll(base, dy, axis=0), dx, axis=1)
        if i % 3 == 1:
            f = f[:, ::-1]
        if i % 4 == 2:
            f = np.clip(f.astype(np.int16)
                        + int(rng.integers(-25, 26)), 0, 255
                        ).astype(np.uint8)
        frames.append(np.ascontiguousarray(f))
    return np.stack(frames[:n])


def box_iou(a, b):
    """IoU of two (xmin, ymin, xmax, ymax) boxes."""
    ix = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    iy = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    inter = ix * iy
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def _frame0_points(result, gt=GT):
    """Frame 0 of a max_faces=1 CascadeResult in pixels: (bbox, nose,
    left iris, right iris)."""
    w, h = gt["size"]
    scale = np.array([w, h])
    det = result.detection[0].float().cpu().numpy() * scale
    nose = result.mesh_raw[0, 1, :2].float().cpu().numpy() * scale
    iris = result.iris[0, :, 0, :2].float().cpu().numpy() * scale
    return ((det[0, 0], det[0, 1], det[1, 0], det[1, 1]), tuple(nose),
            tuple(iris[0]), tuple(iris[1]))


def _accuracy_ok(result, gt=GT):
    """Ground-truth gate on frame 0: (ok, bbox IoU, nose px)."""
    bbox, nose, iris_l, _ = _frame0_points(result, gt)
    iou = box_iou(bbox, gt["bbox"])
    ok = (iou >= GATE_IOU
          and all(abs(p - g) <= GATE_PX
                  for got, want in ((nose, gt["nose"]),
                                    (iris_l, gt["iris_l"]))
                  for p, g in zip(got, want)))
    return ok, iou, nose


def _points_px(result, gt=GT):
    """Frame 0's worst nose/iris error in px (either axis) and its bbox
    IoU against the ground-truth box (BACK's)."""
    bbox, *points = _frame0_points(result, gt)
    worst = max(abs(p - g)
                for got, want in zip(points, (gt["nose"], gt["iris_l"],
                                              gt["iris_r"]))
                for p, g in zip(got, want))
    return float(worst), box_iou(bbox, gt["bbox"])


def face_grid(img, gt=GT, margin=25):
    """A 2x2 grid of the frame's face crop (its ground-truth box widened
    by ``margin`` px on each side): four faces on one canvas."""
    x0, y0, x1, y1 = gt["bbox"]
    crop = img[max(int(y0) - margin, 0):int(y1) + margin,
               max(int(x0) - margin, 0):int(x1) + margin]
    return np.tile(crop, (2, 2, 1))


def hires_frames(src, height, batch, rng):
    """[batch, 3, height, width] uint8 planar frames: ``src`` (a PIL
    image) letterboxed onto a black 16:9 canvas (the face keeps its
    aspect), then copies of the canvas rolled along x by up to a tenth of
    the width, every third one mirrored; and the canvas itself
    [height, width, 3]."""
    from PIL import Image

    width = height * 16 // 9
    scale = min(width / src.width, height / src.height)
    fw, fh = int(src.width * scale), int(src.height * scale)
    face = np.asarray(src.resize((fw, fh), Image.BILINEAR), np.uint8)
    canvas = np.zeros((height, width, 3), np.uint8)
    y0, x0 = (height - fh) // 2, (width - fw) // 2
    canvas[y0:y0 + fh, x0:x0 + fw] = face
    frames = [canvas]
    while len(frames) < batch:
        f = np.roll(canvas, int(rng.integers(-width // 10, width // 10)),
                    axis=1)
        if len(frames) % 3 == 1:
            f = f[:, ::-1]
        frames.append(np.ascontiguousarray(f))
    return (np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2)),
            canvas)


# ---- the yardsticks ----------------------------------------------------


def cascade_costs(model, image_size, batch, act_bytes):
    """(CNN FLOPs per frame, modeled bytes per frame) of the cascade with
    ``model``'s detector on ``batch`` frames of ``image_size`` (w, h):
    detect + mesh + 2x iris graphs, and ``compiler.traffic``."""
    from .compiler import Graph, graph_flops
    from .compiler.traffic import cascade_bytes_per_frame
    from .models.face_detection import _DATA_DIR, _MODEL_FILES

    det = Graph(_DATA_DIR / f"{_MODEL_FILES[model]}.npz")
    mesh = Graph(_DATA_DIR / "face_landmark.npz")
    iris = Graph(_DATA_DIR / "iris_landmark.npz")
    flops = graph_flops(det) + graph_flops(mesh) + 2 * graph_flops(iris)
    bpf = cascade_bytes_per_frame(image_size, batch, det, mesh, iris,
                                  act_bytes=act_bytes)
    return flops, bpf


def utilization(fps, flops_frame, bytes_frame, dtype, device):
    """(mfu_pct, peak TFLOP/s, hbm_gbps) of ``fps`` frames/s: CNN FLOPs
    against the H100's peak for the nets' type, modeled bytes in GB/s.
    All None off the card: a CPU run gives no share of an H100 peak."""
    if torch.device(device).type != "cuda":
        return None, None, None
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    return (100.0 * fps * flops_frame / peak, peak / 1e12,
            fps * bytes_frame / 1e9)


def device_record(device):
    """What the run ran on: the card's name, its nvidia-smi name and
    power limit and the card count, or the CPU."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu",
                "kind": platform.processor() or platform.machine(),
                "count": 1}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi[torch.device(device).index or 0],
            "count": torch.cuda.device_count()}


# ---- the rows ----------------------------------------------------------


def _fetch(result):
    """Read one value of the result on the host: the call has finished."""
    return float(result.score.reshape(-1)[0])


def _host_p50_ms(fn, reps=30):
    """Median host-to-host ms of ``fn`` (a call and its host read)."""
    fn()
    lats = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        lats.append(time.perf_counter() - t0)
    return float(np.median(lats) * 1e3)


def _rtt_ms(batch):
    """Median ms of the host read of a fresh device scalar."""
    one = batch[:1].float()
    rtts = []
    for i in range(7):
        scal = one.reshape(-1)[0] + float(i)
        sync()
        t0 = time.perf_counter()
        scal.item()
        rtts.append(time.perf_counter() - t0)
    return float(np.median(rtts) * 1e3)


def _latency_rows(cascade, batch, device):
    """p50_batch1_ms (host to host), p50_device_ms and p50_device_ms_b8
    (CUDA graphs of one call queued behind a sleep; None on the CPU)."""
    one = batch[:1]
    rows = {"p50_batch1_ms": _host_p50_ms(lambda: _fetch(cascade(one)))}
    _log(f"batch-1 p50 latency: {rows['p50_batch1_ms']:.2f} ms "
         f"(host-to-host, incl. the read)")
    rows["p50_device_ms"] = rows["p50_device_ms_b8"] = None
    if device.type != "cuda":
        _log("device-only latency: not measured (CPU run)")
        return rows
    for key, frames, reps in (("p50_device_ms", one, 20),
                              ("p50_device_ms_b8", batch[:8], 10)):
        rows[key] = queued_ms(graph_of(lambda: cascade(frames)), reps=reps,
                              windows=5)
        _log(f"batch-{frames.shape[0]} device-only latency: "
             f"{rows[key]:.3f} ms (a CUDA graph of one call, queued)")
    return rows


def _aot_row(make, batch, size):
    """p50_aot_b8_ms: host-to-host latency of a cascade with an attached
    ``kind="executable"`` artifact saved at batch 8."""
    from . import aot

    w, h = size
    served = make()
    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "cascade_b8.aot"
        aot.save(served, path, batch=8, height=h, width=w,
                 kind="executable")
        aot.attach(served, path)
    eight = batch[:8]
    ms = _host_p50_ms(lambda: _fetch(served(eight)))
    _log(f"batch-8 AOT (executable) p50: {ms:.2f} ms host-to-host")
    return {"p50_aot_b8_ms": ms, "aot_kind": "executable"}


def _tracking_rows(make_tracker, batch, iters, churn_row):
    """tracking_fps_per_chip (every stream locked, the detector skipped)
    and tracking_churn_fps_per_chip (streams going dark each step,
    re-detected by the repair sub-batch), by host clock over whole steps:
    a step reads the device."""
    b = batch.shape[0]
    tracker = make_tracker()
    for what in ("lock", "warmup"):
        _fetch(tracker.step(batch))
        if not tracker.tracking.all():
            raise RuntimeError(f"tracking failed to {what}")
    t0 = time.perf_counter()
    for _ in range(iters):
        r = tracker.step(batch)
    _fetch(r)
    dt = time.perf_counter() - t0
    if not tracker.tracking.all():
        raise RuntimeError("tracking lost mid-loop; tracking_fps would be "
                           "invalid")
    rows = {"tracking_fps_per_chip": b * iters / dt}
    _log(f"tracking mode: {rows['tracking_fps_per_chip']:.1f} frames/s "
         f"({dt / iters * 1e3:.2f} ms/step, detector skipped)")
    if not churn_row or b < 8:
        return rows
    # churn streams go dark each step (rotating), masked on the device
    churn = max(2, b // 64)
    period = 32
    masks = np.zeros((period, b), bool)
    for i in range(period):
        for c in range(churn):
            masks[i, (i * churn + c) % b] = True
    masks = torch.from_numpy(masks).to(batch.device).reshape(
        period, b, 1, 1, 1)
    zero = torch.zeros((), dtype=batch.dtype, device=batch.device)
    tracker = make_tracker(repair_batch=4 * churn)
    tracker.step(batch)                                 # lock
    for i in range(3):
        r = tracker.step(torch.where(masks[i], zero, batch))
    _fetch(r)
    t0 = time.perf_counter()
    for i in range(iters):
        r = tracker.step(torch.where(masks[i % period], zero, batch))
    _fetch(r)
    dt = time.perf_counter() - t0
    n_lost = int((~tracker.tracking).sum())
    if n_lost > 2 * churn:
        raise RuntimeError(f"churn backlog grew to {n_lost} lost streams")
    rows["tracking_churn_fps_per_chip"] = b * iters / dt
    _log(f"tracking w/ churn ({churn}/{b} streams/step): "
         f"{rows['tracking_churn_fps_per_chip']:.1f} frames/s "
         f"({dt / iters * 1e3:.2f} ms/step, {n_lost} lost at end)")
    return rows


def _throughput(fn, frames, iters, windows=2):
    """Best frames/s of ``windows`` host-clock windows of ``iters`` calls
    of ``fn`` (``frames`` per call)."""
    return frames * 1e3 / min(window_ms(fn, iters) for _ in range(windows))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tpu_face_torch.bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3,
                    help="independent timed windows for the headline "
                         "number; value = median, spread recorded")
    ap.add_argument("--dtype", choices=["bf16", "f32", "auto"],
                    default="auto")
    ap.add_argument("--model", choices=["back", "short", "full"],
                    default="back")
    ap.add_argument("--identical", action="store_true",
                    help="bench N copies of one frame; default is a "
                         "mixed-content batch where every frame has "
                         "different ROI geometry")
    ap.add_argument("--skip-p50", action="store_true",
                    help="skip the latency rows (batch-1 p50, device-only, "
                         "AOT)")
    ap.add_argument("--no-tracking", action="store_true",
                    help="skip the video-tracking rows")
    ap.add_argument("--no-churn", action="store_true",
                    help="skip the tracking-under-churn row")
    ap.add_argument("--no-multiface", action="store_true",
                    help="skip the max_faces=4 crowd-scene row")
    ap.add_argument("--no-f32-control", action="store_true",
                    help="skip the f32 accuracy-gate control row (iou_f32)")
    ap.add_argument("--no-variants", action="store_true",
                    help="skip the SHORT/FULL detector-variant rows")
    ap.add_argument("--no-hires", action="store_true",
                    help="skip the 1080p/4K cascade and tracked rows")
    ap.add_argument("--no-embed", action="store_true",
                    help="skip the EmbedCascade row (demo embedding graph)")
    ap.add_argument("--layout", choices=["hwc", "planar"], default="hwc",
                    help="frame layout fed to the cascade: hwc = "
                         "[B,H,W,3], planar = [B,3,H,W]")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; default the "
                         "CUDA card (raises without one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the batch's shifts, flips and jitter")
    args = ap.parse_args(argv)

    from . import __version__, resolve_device
    from .models.face_detection import FaceDetectionModel
    from .pipeline import EmbedCascade, FaceCascade
    from .tracking import FaceTracker
    from .utils.image_io import load_image

    device = resolve_device(args.device)
    model = {"back": FaceDetectionModel.BACK_CAMERA,
             "short": FaceDetectionModel.SHORT,
             "full": FaceDetectionModel.FULL}[args.model]
    dev_rec = device_record(device)
    _log(f"device: {dev_rec}; batch={args.batch} model={args.model}")

    img = load_image(ROT / FRAME)
    rng = np.random.default_rng(args.seed)
    if args.identical:
        frames = np.ascontiguousarray(
            np.broadcast_to(img, (args.batch,) + img.shape))
    else:
        frames = _distinct_batch(img, args.batch, rng)
    if args.layout == "planar":
        frames = np.ascontiguousarray(frames.transpose(0, 3, 1, 2))
    batch = torch.from_numpy(frames).to(device)
    size = (img.shape[1], img.shape[0])

    def cascade_of(m, dtype):
        return FaceCascade(m, compute_dtype=dtype, input_layout=args.layout,
                           device=device)

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cascade = None
    for name in (["bf16", "f32"] if args.dtype == "auto"
                 else [args.dtype]):
        cand = cascade_of(model, dtypes[name])
        ok, iou, nose = _accuracy_ok(cand(batch[:1]))
        _log(f"{name}: accuracy ok={ok} iou={iou:.4f} nose={nose}")
        if ok:
            cascade, chosen, gate_iou = cand, name, float(iou)
            break
    if cascade is None:
        raise RuntimeError("no configuration met the accuracy budget")
    dtype = dtypes[chosen]

    iou_f32 = gate_iou if chosen == "f32" else None
    if chosen == "bf16" and not args.no_f32_control:
        _, iou_f32, _ = _accuracy_ok(
            cascade_of(model, torch.float32)(batch[:1]))
        iou_f32 = float(iou_f32)
        _log(f"f32 control: iou={iou_f32:.4f} (bf16 gate {gate_iou:.4f})")

    rtt = _rtt_ms(batch)
    _log(f"host read RTT: {rtt:.3f} ms (median of 7)")

    # steady state: value = median of the windows, spread recorded; extra
    # windows when the spread exceeds 2% (host contention)
    def call():
        cascade(batch)

    for _ in range(args.warmup + 1):
        call()
    window_fps = [args.batch * 1e3 / window_ms(call, args.iters)
                  for _ in range(args.repeats)]
    spread = lambda ws: (max(ws) - min(ws)) / np.median(ws) * 100.0  # noqa
    while spread(window_fps) > 2.0 and len(window_fps) < args.repeats + 4:
        _log(f"window spread {spread(window_fps):.1f}% > 2%: timing an "
             f"extra window")
        window_fps.append(args.batch * 1e3 / window_ms(call, args.iters))
    fps = float(np.median(window_fps))
    step_ms = args.batch / fps * 1e3
    _log(f"dtype={chosen} {fps:.1f} frames/s (windows: "
         f"{', '.join(f'{w:.0f}' for w in window_fps)}; spread "
         f"{spread(window_fps):.1f}%); {step_ms:.2f} ms/step"
         f"{' [identical frames]' if args.identical else ' [distinct]'}")

    itemsize = torch.empty((), dtype=dtype).element_size()
    flops_frame, bytes_frame = cascade_costs(model, size, args.batch,
                                             itemsize)
    mfu_pct, peak_tflops, hbm_gbps = utilization(fps, flops_frame,
                                                 bytes_frame, dtype, device)
    if mfu_pct is None:
        _log("MFU and HBM bandwidth: not measured (CPU run)")
    else:
        _log(f"MFU: {mfu_pct:.2f}% ({flops_frame / 1e6:.0f} MFLOP/frame at "
             f"{fps:.0f} fps vs {peak_tflops:.0f} TFLOP/s peak)")
        _log(f"modeled traffic {bytes_frame / 1e6:.1f} MB/frame: "
             f"{hbm_gbps:.0f} GB/s = "
             f"{hbm_gbps / (H100_BYTES_PER_S / 1e9) * 100:.1f}% of "
             f"{H100_BYTES_PER_S / 1e9:.0f} GB/s")

    record = {
        "metric": "cascade_fps_per_chip",
        "version": __version__,
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "distinct_content": not args.identical,
        "layout": args.layout,
        "batch": args.batch,
        "seed": args.seed,
        "spread_pct": round(spread(window_fps), 1),
        "n_windows": len(window_fps),
        "best_window_fps": round(float(max(window_fps)), 1),
        "rtt_ms": round(rtt, 3),
        "gate_iou": round(gate_iou, 4),
        "gate_dtype": chosen,
        "mfu_pct": None if mfu_pct is None else round(mfu_pct, 2),
        "mfu_peak_tflops": peak_tflops,
        "hbm_gbps": None if hbm_gbps is None else round(hbm_gbps, 1),
    }
    if iou_f32 is not None:
        record["iou_f32"] = round(iou_f32, 4)

    if not args.skip_p50:
        lat = _latency_rows(cascade, batch, device)
        lat.update(_aot_row(lambda: cascade_of(model, dtype), batch, size))
        for k, v in lat.items():
            record[k] = v if not isinstance(v, float) else round(v, 3)
    del cascade

    if not args.no_tracking:
        rows = _tracking_rows(
            lambda **kw: FaceTracker(model, compute_dtype=dtype,
                                     input_layout=args.layout,
                                     device=device, **kw),
            batch, args.iters, not args.no_churn)
        record.update({k: round(v, 1) for k, v in rows.items()})

    if not args.no_embed:
        ecas = EmbedCascade(model, embed_model_path=str(DEMO_EMBED),
                            compute_dtype=dtype, input_layout=args.layout,
                            device=device)
        r = ecas(batch)
        if not bool(r.face_valid[0]):
            raise RuntimeError("no face embedded in frame 0")
        fps_e = _throughput(lambda: ecas(batch), args.batch, args.iters, 1)
        record["embed_fps_per_chip"] = round(fps_e, 1)
        _log(f"embed cascade: {fps_e:.1f} frames/s")
        del ecas

    if not args.no_multiface:
        # four faces on one canvas, FULL_SPARSE detector, max_faces=4
        mb = min(args.batch, 32)
        grid = torch.from_numpy(np.stack([face_grid(img)] * mb)).to(device)
        mcas = FaceCascade(FaceDetectionModel.FULL_SPARSE, max_faces=4,
                           compute_dtype=dtype, device=device)
        nf = float(mcas(grid).mesh_valid.sum()) / mb
        if nf < 3.9:
            raise RuntimeError(f"crowd scene found {nf:.2f}/4 faces")
        faces = _throughput(lambda: mcas(grid), mb * nf, args.iters, 1)
        record["multiface_faces_per_s"] = round(faces, 1)
        _log(f"multiface (K=4 crowd, batch {mb}): {faces:.1f} faces/s")
        del mcas, grid

    if not args.no_variants:
        for vname, vmodel in (("short", FaceDetectionModel.SHORT),
                              ("full", FaceDetectionModel.FULL)):
            if vmodel == model:
                continue                    # already the headline row
            vcas = cascade_of(vmodel, dtype)
            worst, viou = _points_px(vcas(batch))
            if worst > FULL_GT_PX:
                raise RuntimeError(f"{vname}-variant gate: nose/iris "
                                   f"{worst:.2f} px from the ground truth")
            vfps = _throughput(lambda: vcas(batch), args.batch,
                               min(args.iters, 30))
            record[f"fps_{vname}"] = round(vfps, 1)
            _log(f"{vname}-variant cascade: {vfps:.1f} frames/s (gate "
                 f"{worst:.2f} px, bbox IoU vs BACK's box {viou:.4f})")
            del vcas

    if not args.no_hires:
        from PIL import Image

        src = Image.open(ROT / FRAME).convert("RGB")
        hrng = np.random.default_rng(args.seed)
        for label, height, cb, cit, tb, tit in HIRES:
            hframes, canvas = hires_frames(src, height, cb, hrng)
            hbatch = torch.from_numpy(hframes).to(device)
            hc = FaceCascade(model, compute_dtype=dtype,
                             input_layout="planar", device=device)
            if not bool(hc(hbatch).mesh_valid[0]):
                raise RuntimeError(f"{label}: face lost in cascade")
            record[f"fps_{label}"] = round(
                _throughput(lambda: hc(hbatch), cb, cit), 1)
            record[f"batch_{label}"] = cb
            _log(f"{label} cascade (batch {cb}, planar): "
                 f"{record[f'fps_{label}']:.1f} frames/s")
            del hc, hbatch
            tr = FaceTracker(model, compute_dtype=dtype,
                             input_layout="planar", device=device)
            ident = torch.from_numpy(canvas.transpose(2, 0, 1).copy()).to(
                device).expand(tb, -1, -1, -1).contiguous()
            for _ in range(2):                  # lock, then tracked
                _fetch(tr.step(ident))
            if not tr.tracking.all():
                raise RuntimeError(f"{label}: tracker failed to lock")
            record[f"fps_{label}_tracked"] = round(
                _throughput(lambda: tr.step(ident), tb, tit), 1)
            if not tr.tracking.all():
                raise RuntimeError(f"{label}: lost lock mid-loop")
            record[f"batch_{label}_tracked"] = tb
            _log(f"{label} tracked (batch {tb}, planar): "
                 f"{record[f'fps_{label}_tracked']:.1f} frames/s")
            del tr, ident

    record["device"] = dev_rec
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
