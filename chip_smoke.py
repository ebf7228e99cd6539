#!/usr/bin/env python3
"""Smoke run of tpu_face_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (nonzero exit, no result line):

1. device  -- the card's name and power limit (nvidia-smi), torch's name;
2. build   -- compiles the warp kernel from tpu_face_torch/csrc;
3. kernel  -- the warp kernel against its plain PyTorch version at the
              main path's shapes (32 frames of 540x360, a 192x192 mesh
              grid and two 64x64 iris grids, random ROIs to +-45 deg,
              mirrored grids, taps past the frame edge), plus a 1280x720
              and a 64x64 frame: max abs error <= 1e-3;
4. cascade -- FaceCascade() on the seven rotated frames of
              assets/rotated/, one infer_batch per geometry, held against
              their ground truth (bbox IoU >= 0.99, landmarks <= 1 px) and
              against the port's own CPU result; the warp kernel must
              have launched exactly twice per infer_batch;
5. numbers -- cascade frames/s at batch 64, per-stage times, and the warp
              kernel's time beside its bound, its plain version and
              torch.nn.functional.grid_sample (a yardstick only).

Its last lines are the nvidia-smi line, a JSON line of numbers, the
kernels' JSON line and {"ok": true, "device": {...}}.  Imports nothing
of JAX or of the tpu_face package.

    python3 chip_smoke.py --trace DIR

adds a torch.profiler window over three batch-64 cascade calls to the
numbers (device busy share, kernel launches per call, the kernels that
take the most device time) and writes the full table and a Chrome trace
into DIR.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ROT = ROOT / "assets" / "rotated"

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

KERNEL_TOL = 1e-3               # 0-255 units, before rounding
CPU_PX_TOL = 0.25               # landmarks, GPU vs CPU port, pixels
CPU_SCORE_TOL = 1e-3

# Ground truth of the rotated frames (TFLite + OpenCV reference
# transcription; the same rows as tests/test_rotation_e2e.py).
GT = {
    "man_rotp15.png": {
        "size": (540, 360), "bbox": (184.8, 80.8, 317.5, 213.6),
        "roi_rot": -0.2983, "nose": (255.63, 146.75),
        "iris": {"L": (219.20, 120.41), "R": (271.60, 105.20)},
        "eye_rots": (-0.3492, -0.4751)},
    "man_rotm15.png": {
        "size": (540, 360), "bbox": (208.0, 72.0, 347.0, 211.1),
        "roi_rot": 0.2381, "nose": (272.26, 142.97),
        "iris": {"L": (255.85, 102.66), "R": (308.64, 116.28)},
        "eye_rots": (0.4246, 0.2800)},
    "man_rotp30.png": {
        "size": (540, 360), "bbox": (178.4, 88.7, 301.1, 211.4),
        "roi_rot": -0.5612, "nose": (247.59, 151.92),
        "iris": {"L": (205.44, 135.63), "R": (252.41, 107.08)},
        "eye_rots": (-0.6559, -0.7816)},
    "man_rotm30.png": {
        "size": (540, 360), "bbox": (231.0, 82.4, 353.4, 204.7),
        "roi_rot": 0.5287, "nose": (282.63, 146.37),
        "iris": {"L": (275.97, 101.57), "R": (323.83, 128.60)},
        "eye_rots": (0.7652, 0.6119)},
    "man_closeup_rotp30.png": {
        "size": (704, 704), "bbox": (181.8, 170.1, 415.6, 403.9),
        "roi_rot": -0.5473, "nose": (317.30, 291.96),
        "iris": {"L": (234.49, 260.51), "R": (326.30, 205.84)},
        "eye_rots": (-0.4764, -0.5867)},
    "russ2_rotp20.png": {
        "size": (200, 225), "bbox": (56.3, 70.7, 148.6, 163.0),
        "roi_rot": -0.4737, "nose": (103.69, 125.47),
        "iris": {"L": (77.09, 106.69), "R": (113.66, 89.22)},
        "eye_rots": (-0.3145, -0.4772)},
    "russ2_rotm20.png": {
        "size": (200, 225), "bbox": (57.3, 71.0, 154.3, 168.0),
        "roi_rot": 0.2164, "nose": (95.01, 124.70),
        "iris": {"L": (86.22, 93.21), "R": (125.23, 103.28)},
        "eye_rots": (0.2922, 0.1481)},
}
FRAMES_540 = ["man_rotp15.png", "man_rotm15.png", "man_rotp30.png",
              "man_rotm30.png"]


def phase(name):
    print(f"== {name}", flush=True)


def median_ms(fn, reps, windows=3, warmup=2):
    """Median over ``windows`` of the mean time of ``reps`` calls of
    ``fn``, from CUDA events, after ``warmup`` calls."""
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


def iou(a, b):
    xmin, ymin = max(a[0], b[0]), max(a[1], b[1])
    xmax, ymax = min(a[2], b[2]), min(a[3], b[3])
    if not (xmin < xmax and ymin < ymax):
        return 0.0
    inter = (xmax - xmin) * (ymax - ymin)
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def check_gt(res, i, gt):
    """One frame of a CascadeResult against its ground-truth row; returns
    (bbox IoU, worst landmark error in px)."""
    w, h = gt["size"]
    assert bool(res.face_valid[i]) and bool(res.mesh_valid[i]), gt
    det = res.detection[i].cpu().numpy()
    box = (det[0, 0] * w, det[0, 1] * h, det[1, 0] * w, det[1, 1] * h)
    box_iou = iou(box, gt["bbox"])
    assert box_iou >= 0.99, (box, gt["bbox"], box_iou)
    roi_rot = float(res.face_roi[i, 4])
    assert abs(roi_rot - gt["roi_rot"]) <= 0.01, (roi_rot, gt["roi_rot"])
    eye_rots = res.eye_rois[i, :, 4].cpu().numpy()
    for e, grot in enumerate(gt["eye_rots"]):
        assert abs(eye_rots[e] - grot) <= 0.02, (e, eye_rots[e], grot)
    mesh = res.mesh[i].cpu().numpy()
    iris = res.iris[i].cpu().numpy()
    pts = [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
           ((iris[0, 0, 0] * w, iris[0, 0, 1] * h), gt["iris"]["L"]),
           ((iris[1, 0, 0] * w, iris[1, 0, 1] * h), gt["iris"]["R"])]
    worst = max(max(abs(p[0] - g[0]), abs(p[1] - g[1])) for p, g in pts)
    assert worst <= 1.0, (pts, worst)
    return box_iou, worst


def check_against_cpu(res, ref, size):
    """GPU result vs the port's CPU result on the same frames; returns
    (worst landmark px, worst score difference)."""
    w, h = size
    for f in ("face_valid", "mesh_valid", "envelope_ok"):
        assert torch.equal(getattr(res, f).cpu(), getattr(ref, f)), f
    scale = torch.tensor([w, h, w], dtype=torch.float32)
    px = 0.0
    for f in ("mesh", "mesh_raw", "iris"):
        d = (getattr(res, f).cpu() - getattr(ref, f)) * scale
        px = max(px, float(d.abs().max()))
    det = (res.detection.cpu() - ref.detection) * scale[:2]
    px = max(px, float(det.abs().max()))
    sc = max(float((getattr(res, f).cpu() - getattr(ref, f)).abs().max())
             for f in ("score", "mesh_score"))
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (px, sc)
    return px, sc


def random_coords(rng, b, w, h, image_ops):
    """Mesh (192x192) and iris (two 64x64, right mirrored) grids of
    random ROIs over a w x h frame: rotation to +-45 deg, centres past
    the frame edge, sizes from 5% to 70% of the short side."""
    def rois():
        cx = rng.uniform(-0.1 * w, 1.1 * w, b)
        cy = rng.uniform(-0.1 * h, 1.1 * h, b)
        side = rng.uniform(0.05, 0.7, b) * min(w, h)
        aspect = rng.uniform(0.8, 1.25, b)
        rot = rng.uniform(-math.pi / 4, math.pi / 4, b)
        return torch.from_numpy(np.stack(
            [cx, cy, side, side * aspect, rot], -1).astype(np.float32)
        ).cuda()
    mx, my, _ = image_ops._source_coords(rois(), (192, 192), False, False)
    lx, ly, _ = image_ops._source_coords(rois(), (64, 64), True, False)
    rx, ry, _ = image_ops._source_coords(rois(), (64, 64), True, True)
    return [(mx, my)], [(lx, ly), (rx, ry)]


def flat(coords):
    b = coords[0][0].shape[0]
    return (torch.cat([x.reshape(b, -1) for x, _ in coords], 1).contiguous(),
            torch.cat([y.reshape(b, -1) for _, y in coords], 1).contiguous())


def touched_bytes(planes, xs, ys):
    """Bytes the warp must move for these coordinates: each distinct
    in-frame tap pixel read once (3 f32 channels), the coordinates read
    once, the [P, 3] f32 samples written once."""
    b, _, h, w = planes.shape
    x0, y0 = torch.floor(xs).long(), torch.floor(ys).long()
    seen = torch.zeros(b * h * w, dtype=torch.bool, device=xs.device)
    frame = torch.arange(b, device=xs.device)[:, None] * (h * w)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            seen[(frame + yy * w + xx)[ok]] = True
    pixels = int(seen.sum())
    return pixels * 3 * 4 + xs.numel() * 8 + xs.numel() * 12


def trace_cascade(cascade, batch, out, calls=3, top=12):
    """torch.profiler over ``calls`` cascade calls: wall time, summed
    device kernel time, kernel launches per call and the kernels with
    the most device time.  The table and the trace go into ``out``."""
    from torch.profiler import ProfilerActivity, profile
    cascade(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            cascade(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out.mkdir(parents=True, exist_ok=True)
    (out / "cascade_b64_kernels.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    prof.export_chrome_trace(str(out / "cascade_b64_trace.json"))
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "calls": calls, "wall_ms": wall_ms, "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "launches_per_call": sum(e.count for e in kernels) / calls,
        "top": [[e.key[:80], e.self_device_time_total / 1e3 / calls,
                 e.count // calls] for e in kernels[:top]]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace", type=Path, metavar="DIR",
                        help="profile three batch-64 cascade calls and "
                        "write the kernel table and trace into DIR")
    trace = parser.parse_args(argv).trace
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_face_torch.ops import _build
    from tpu_face_torch.ops import image as image_ops
    from tpu_face_torch.ops import warp
    from tpu_face_torch.pipeline import FaceCascade, exact_f32
    from tpu_face_torch.utils.image_io import load_image

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    phase("build")
    t0 = time.perf_counter()
    _build.load("warp_bilinear")
    log = _build.BUILD_LOG["warp_bilinear"]
    print(log["ptxas"])
    print(f"warp_bilinear built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {log['seconds']:.2f} s)", flush=True)

    phase("kernel vs plain")
    rng = np.random.default_rng(0)
    max_err = 0.0
    for b, (w, h) in ((32, (540, 360)), (1, (1280, 720)), (2, (64, 64))):
        frames = torch.from_numpy(
            rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).cuda()
        planes = warp.make_planes(frames)
        for coords in random_coords(rng, b, w, h, image_ops):
            before = warp.LAUNCHES
            outs = warp.warp_sample_multi(planes, coords)
            torch.cuda.synchronize()
            assert warp.LAUNCHES == before + 1, "kernel did not launch"
            plain = warp.warp_bilinear_plain(planes, *flat(coords))
            got = torch.cat([o.permute(0, 3, 1, 2).reshape(b, 3, -1)
                             for o in outs], 2)
            err = float((got - plain).abs().max())
            print(f"B={b} {w}x{h} grids "
                  f"{[tuple(x.shape[1:]) for x, _ in coords]}: "
                  f"max abs err {err:.3g}")
            assert err <= KERNEL_TOL, err
            max_err = max(max_err, err)

    phase("cascade")
    groups = {}
    for name, gt in GT.items():
        groups.setdefault(gt["size"], []).append(name)
    batches = {size: np.stack([load_image(ROT / n) for n in names])
               for size, names in groups.items()}
    cascade = FaceCascade()
    warp.LAUNCHES = 0
    results = {size: cascade.infer_batch(batch)
               for size, batch in batches.items()}
    torch.cuda.synchronize()
    launches = warp.LAUNCHES
    print(f"warp launches on the main path: {launches} for "
          f"{len(batches)} infer_batch calls")
    assert launches == 2 * len(batches), launches
    cpu_cascade = FaceCascade(device="cpu")
    for size, names in groups.items():
        res = results[size]
        for i, name in enumerate(names):
            box_iou, px = check_gt(res, i, GT[name])
            print(f"{name}: IoU {box_iou:.4f}, worst landmark "
                  f"{px:.3f} px vs ground truth")
        px, sc = check_against_cpu(res, cpu_cascade.infer_batch(
            batches[size]), size)
        print(f"{size[0]}x{size[1]} GPU vs CPU port: {px:.4f} px, "
              f"scores {sc:.2e}", flush=True)

    phase("numbers")
    frames = np.stack([load_image(ROT / n) for n in FRAMES_540])
    size = (540, 360)
    numbers = {"device": smi}

    # warp kernel at the main path's shapes: the coordinates one
    # infer_batch of 32 540x360 frames gives it
    imgs = torch.from_numpy(np.tile(frames, (8, 1, 1, 1))).cuda()
    with torch.inference_mode(), exact_f32():
        planes = cascade._prepare_frame(imgs)
        dets, _, _ = cascade._detect_stage(planes, size)
        roi = cascade._face_roi_from_det(dets[:, 0], size)
        mx, my, _ = image_ops._source_coords(roi, (192, 192), False,
                                             False)
        mesh, _, lroi, rroi = cascade._mesh_half(planes, roi, size)
        lx, ly, _ = image_ops._source_coords(lroi, (64, 64), True, False)
        rx, ry, _ = image_ops._source_coords(rroi, (64, 64), True, True)
    calls = [flat([(mx, my)]), flat([(lx, ly), (rx, ry)])]
    for xs, ys in calls:
        err = float((warp.warp_bilinear(planes, xs, ys)
                     - warp.warp_bilinear_plain(planes, xs, ys)
                     ).abs().max())
        assert err <= KERNEL_TOL, err
        max_err = max(max_err, err)
    h, w = planes.shape[2:]
    grids = []
    for xs, ys in calls:
        g = torch.stack([xs * (2.0 / (w - 1)) - 1.0,
                         ys * (2.0 / (h - 1)) - 1.0], -1)
        grids.append(g[:, None])                      # [B, 1, P, 2]

    def run(fn):
        return lambda: [fn(planes, xs, ys) for xs, ys in calls]

    def library():
        return [torch.nn.functional.grid_sample(
            planes, g, mode="bilinear", padding_mode="zeros",
            align_corners=True) for g in grids]

    kernel_ms, _ = median_ms(run(warp.warp_bilinear), reps=50)
    plain_ms, _ = median_ms(run(warp.warp_bilinear_plain), reps=10)
    library_ms, _ = median_ms(library, reps=50)
    nbytes = sum(touched_bytes(planes, xs, ys) for xs, ys in calls)
    flops = sum(xs.numel() * 3 * 9 for xs, _ in calls)
    bound_ms = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    numbers["warp_b32"] = {
        "calls": ["mesh 192x192", "iris 2x64x64"], "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "grid_sample_ms": library_ms,
        "bound_ms": bound_ms, "bytes": nbytes, "flops": flops}

    # cascade throughput at batch 64 (the four 540p frames, x16), the
    # uint8 batch already on the card
    batch = torch.from_numpy(np.tile(frames, (16, 1, 1, 1))).cuda()
    reps = 10
    ms, windows = median_ms(lambda: cascade(batch), reps=reps)
    numbers["cascade_b64"] = {"frames_per_s": 64 * 1e3 / ms,
                              "ms_per_batch": ms, "windows_ms": windows}
    if trace is not None:
        numbers["trace_b64"] = trace_cascade(cascade, batch, trace)

    # per-stage times at batch 64 on the stage inputs of one run
    with torch.inference_mode(), exact_f32():
        planes = cascade._prepare_frame(batch)
        dets, _, _ = cascade._detect_stage(planes, size)
        roi = cascade._face_roi_from_det(dets[:, 0], size)
        mesh, _, lroi, rroi = cascade._mesh_half(planes, roi, size)
        mesh_in = torch.rand(64, 192, 192, 3, device=planes.device)
        iris_in = torch.rand(128, 64, 64, 3, device=planes.device)

        def detect():
            cascade._detect_stage(cascade._prepare_frame(batch), size)

        def mesh_warp():
            x, y, _ = image_ops._source_coords(roi, (192, 192), False,
                                               False)
            image_ops._normalize_pixels(
                warp.warp_sample_multi(planes, [(x, y)])[0], (0.0, 1.0),
                True)

        def iris_warp():
            a = image_ops._source_coords(lroi, (64, 64), True, False)
            c = image_ops._source_coords(rroi, (64, 64), True, True)
            image_ops._normalize_pixels(torch.stack(
                warp.warp_sample_multi(planes, [a[:2], c[:2]]), 1),
                (0.0, 1.0), True)

        stages = {"detect": detect, "mesh_warp": mesh_warp,
                  "mesh_cnn": lambda: cascade._mesh_net(mesh_in),
                  "iris_warp": iris_warp,
                  "iris_cnn": lambda: cascade._iris_net(iris_in)}
        numbers["stages_b64_ms"] = {k: median_ms(f, reps=10)[0]
                                    for k, f in stages.items()}

    kernels = [{
        "name": "warp_bilinear", "route": "cuda",
        "source": "tpu_face_torch/csrc/warp_bilinear.cu",
        "replaces": "tpu_face/ops/pallas_warp.py:203",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes"
        if nbytes / H100_BYTES_PER_S >= flops / H100_F32_FLOPS
        else "operations", "library_ms": library_ms}]

    print(smi)
    print(json.dumps(numbers))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
