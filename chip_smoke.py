#!/usr/bin/env python3
"""Smoke run of tpu_face_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails loudly (nonzero exit, no result line):

1. device  -- the card's name and power limit (nvidia-smi), torch's name;
2. build   -- compiles the five kernel sources from tpu_face_torch/csrc
              (the gather warps warp_bilinear.cu and
              warp_bilinear_strips.cu, the fused residual block in f32,
              fused_dw_pw_block.cu, and in bf16,
              fused_dw_pw_block_bf16.cu, the staged strip warp
              warp_strips_staged.cu), one nvcc per source, started
              together, and prints their ptxas lines;
3. kernel  -- each kernel against its plain PyTorch version.  The warps
              (max abs error <= 1e-3) on random ROIs to +-45 deg,
              mirrored grids and taps past the frame edge, with the
              cascade's grids (a 192x192 mesh grid, 64x64 left and
              mirrored right iris grids): warp_bilinear_segments on f32
              planes of 32 frames of 540x360, a 1280x720 and two 64x64
              frames (two faces each), bit-exact, with the mesh grid,
              both iris grids and all three as one, two and three
              segments, a 37x37 grid cut from the mesh grid (not
              contiguous, rows not a multiple of 4) and the one-segment
              warp_bilinear on the concatenated coordinates; f32
              warp_sample_multi takes it in one launch;
              warp_bilinear_strips and both staged variants (one fused
              copy per block, three per-channel copies) on the same calls
              over bf16 and f32 planes of 8 frames of 1920x1080, 2 of
              3840x2160 and 2 of 1281x723 (rows of bf16 planes start
              off the 16-byte grid), with 1 and 4 faces per frame and ROIs
              of one to three times the short side, whose blocks overflow
              the staged kernel's window budget (the kernel counts those
              blocks and the bytes its windows copied, the same for both
              variants; the staged outputs' bit-exactness with the
              gather's is printed).
              The fused block (TF32 off): f32 and bf16 at each residual
              run of the BACK detector (128x128x24, 64x64x24, 32x32x48,
              16x16x96, seven blocks each, batch 64, the f32 and the bf16
              detector's weights), f32 within 1e-4 * max(1, max|plain|),
              bf16 within one bf16 ulp of max|plain| (the kernel rounds
              where the plain version rounds), and f32 and bf16 at the
              Pallas prototypes' shape (batch 256, 128x128x24, 7 blocks,
              their seeded weights); the tiling
              the wrapper chose for each run is printed, and for bf16 the
              error of the f32-staged kernel it replaced on the same
              inputs;
4. cascade -- the main paths, with every launch count set to 0 before
              each and read after it.  f32: FaceCascade() on the seven
              rotated frames of assets/rotated/ (one infer_batch per
              geometry; 2 warp_bilinear, 0 warp_bilinear_strips and the
              detector's planned f32 fused-block launches each), held
              against their ground truth (bbox IoU >= 0.99, landmarks <= 1
              px) and the port's own CPU result; then canvas (a) at
              1920x1080 (K=1) and (b) at 1280x824 (K=2), 2
              warp_bilinear_strips launches each, and (c) at 1080x720
              (K=4), 2 warp_bilinear launches (the mesh grid as one
              segment, both iris grids as two, no coordinate
              concatenation); every face valid and within
              0.25 px / 1e-3 of the CPU port.  bf16:
              FaceCascade(compute_dtype=torch.bfloat16) on the same frames
              and canvases (a) and (c), the detector's residual runs on
              fused_dw_pw_block_bf16 only (its planned launches per call,
              none of the f32 kernel's), against the ground truth and the
              CPU port's bf16 result (the BF16_* tolerances; with K=4 the
              faces matched by position, since the score sort may swap
              faces whose bf16 scores nearly tie: a swap passes only
              where the CPU's two scores differ by at most
              BF16_SCORE_TOL, and each side's slot scores are printed);
              with K > 1 the card's valid faces must come in
              non-increasing score, and f32 faces match slot by slot.
              gather: FaceCascade(warp_method="gather") with f32 nets on the
              rotated frames, no warp kernel launched (only the detector's
              fused launches), against the ground truth and the kernel
              path's result within 0.25 px / 1e-3;
5. models  -- the standalone models, counts set to 0 before and read
              after: FaceDetection(BACK) -> face_detection_to_roi ->
              FaceLandmark -> iris_roi_from_face_landmarks -> IrisLandmark
              (left, and right mirrored) on the seven rotated frames,
              against their ground truth and the CPU port (0.25 px /
              1e-3), each warp on warp_bilinear; then the same chain on
              canvas (a), where the mesh and iris warps take
              warp_bilinear_strips over f32 planes; then the chain with
              bf16 nets on the rotated frames (ground truth, and the CPU
              port within the BF16_* tolerances);
6. full_detectors -- the counts set to 0 before and read after:
              FaceDetection(FULL) and FaceDetection(FULL_SPARSE) on the
              seven rotated frames and canvas (c) (one warp_bilinear
              launch per call but on the portraits, which take the
              two-stage letterbox; no fused launch: the full-range nets'
              bottleneck blocks are no run), FaceCascade(FULL) on the four
              540p frames and FaceCascade(FULL_SPARSE, max_faces=4) on
              canvas (c) (2 warp_bilinear launches each), every face valid,
              against the CPU port (0.25 px / 1e-3) and, for FULL's
              cascade, the nose and irises within 2 px of the ground
              truth;
7. mxu     -- warp_method="mxu" (the banded hat-weight matmuls, plain
              torch): the standalone chain on the rotated frames but the
              close-up (its mesh ROI overflows the band, in JAX too) and
              the cascade on the 540p frames, against the CPU port; no
              warp kernel launched, only the BACK detector's fused ones;
8. tracker -- FaceTracker() with the published nets: 8 streams of a
              five-step rotated 540p sequence (stream 2 blanked at step
              2), then 2 streams of canvas (a) at 1920x1080 over three
              steps, every step's launches checked (the first step the
              full cascade; a locked step 2 warp launches, warp_bilinear
              or at 1080p warp_bilinear_strips, and no fused launch: the
              detector does not run; a repair step 4 warp launches and
              the fused launches of the one-stream repair cascade), each
              step against the port's CPU tracker entered with the card's
              state (0.25 px / 1e-3, equal lock states); then locked
              steps/s of 64 streams beside the cascade's frames/s on the
              same frames and the step's stages timed without its two
              host reads (printed, no limit);
9. embed   -- the identification path, the counts set to 0 before and
              read after: EmbedCascade(BACK, the demo embedding graph
              tpu_face/data/demo) with f32 and with bf16 nets on the
              rotated frames (the 540p four x16 = batch 64, the close-up,
              the portraits) and on canvas (c) with max_faces=4, each call
              13 fused launches (f32) or 8 (bf16) and no warp kernel (the
              crop is the separable hat matmuls); FaceEmbeddings
              .infer_batch (f32, bf16) and .embed_boxes of a FaceCascade
              result's meshes (no kernel).  f32 against the port's CPU
              result (crop_bbox equal, 0.25 px / 1e-3, embeddings within
              1e-4), bf16 against the card's f32 result (crops within 1 px,
              cosine >= 0.99 against the f32 net on the same crop, 0.98
              for crops under 112 px; the cosine against the f32 path
              printed); then EmbedCascade's
              frames/s at 540p b64 in f32 and bf16 beside FaceCascade's
              (printed, no limit), ``python -m tpu_face_torch identify``
              and ``cascade`` in subprocesses on the card against the
              same commands with ``--device cpu``, and
              native_loader.available() (where the loader builds: a JPEG
              of a rotated frame decoded against Pillow);
10. aot     -- the serving programs (tpu_face_torch.aot), the counts set
              to 0 before and read after: FaceCascade with f32 and with
              bf16 nets at 540x360 batch 8, f32 at 1920x1080 planar batch
              4 (the strip kernel) and EmbedCascade f32 (demo graph) at
              540x360 batch 8, each saved, loaded and attached to a fresh
              object: the attached call within 1e-6 of the live one with
              the flags equal (printed: bit-identical or not), the same
              counted launches per call, and the loaded graph's kernel
              operators giving those launches (2 warp nodes, 4 fused run
              nodes whose chunks add up to 13 f32 or 8 bf16 launches);
              then FaceTracker's artifact (the full cascade at 8 streams
              and at the repair batch 1, the tracked stages) over a full,
              a locked and a repair step against a live tracker, step by
              step; each artifact's save, load and attach seconds and
              size, and the cold start of a FaceCascade (construction and
              first call against construction, attach and first call,
              and aot.load and first call);
11. aot_executable -- the same three FaceCascade programs (f32 and bf16
              at 540x360 batch 8, f32 at 1920x1080 planar batch 4) saved
              with kind="executable" (AOTInductor packages compiled on the
              card; the counts set to 0 before and read after), each
              attached to a fresh object and held against the live one:
              the same counted launches per call (the package calls the
              kernels' operators), f32 within 0.25 px / 1e-3 and bf16 nets
              within the BF16_* criteria, the ground truth of the rotated
              frames, one call on a side stream equal to the default
              stream's; the largest difference against live and against
              the export, each compile's seconds and bytes, one call's
              host-to-host ms through the live object, the export and the
              executable, and the cold start of the f32 540x360 b8
              executable beside the export's.  The EmbedCascade and
              FaceTracker executables are left out (a compile costs about
              a minute on the card; tests/test_torch_aot_executable.py
              runs both on the CPU, under ``slow``);
12. sharded -- tpu_face_torch.parallel, the counts set to 0 before and
              read after: infer_sharded of FaceCascade() at 540x360 batch
              64 over data_parallel_mesh() (every visible card; its size
              printed) and over [cuda:0, cuda:0] against the unsharded
              call (within 2e-3, flags equal; each shard's launches), and
              track_sharded of FaceTracker() over both meshes, 8 streams
              over a full, a locked and a repair step, against the
              unsharded tracker; then each sharded call's frames/s beside
              the unsharded call's (host clock, every card synchronized;
              printed, no limit);
13. strip_dma -- K5's A/B on tools/tpu_strip_dma_probe.py's
              configuration (batch 64 of 1920x1080 bf16 planes, 192x192
              mesh grids of 350-640 px ROIs to +-0.3 rad): the gather
              strip kernel and both staged variants once each (this
              path's launches), bit-exact with each other, then timed in
              turns against one bound, the bytes the staged windows copied
              (counted by the kernel) printed beside those the gather's
              bound counts;
14. numbers -- cascade frames/s at 540x360 batch 64 (with the detector's
              residual runs on the fused kernel and op by op), at 1080p
              batch 64 and at 4K batch 8 (planar input), each with f32
              and with bf16 nets; faces/s of canvas (c) at batch 32 with
              K=4, per-stage times at 540x360, the BACK net at 540x360
              batch 64 with and without the fused kernel in f32 and in
              bf16, the cascade's two strip warp calls at 1080p and 4K on
              the gather kernel and both staged variants in turns, and
              each kernel's time at its path's shapes beside its bound,
              its plain version and, for the warps,
              torch.nn.functional.grid_sample (a yardstick only), and the
              f32 fused kernel's two designs of the 1x1 (split TF32 on the
              tensor cores, the path's; register-blocked FMAs, the
              library's probe-only entry point) at the BACK runs R1 and
              R4, each one's error and device time (k3_probe): the call
              time (CUDA events over back-to-back calls, the host's
              launch path included, ``median_ms``) and the device time
              (the same calls queued behind a ``torch.cuda._sleep``,
              ``queued_ms``); K1's
              call time is through its registered operator, and its
              ``direct_ms`` the same launches by the operator's CUDA
              implementation called directly.  The f32 and the bf16 fused
              kernel are timed on the same runs; and the card's launch
              queue: the small launches the host enqueues behind a
              sleeping card before one blocks (launch_queue_depth);
15. bench  -- ``tpu_face_torch.bench.main`` (the port's bench, ``python -m
              tpu_face_torch.bench``) in this process at batch 64 with
              short windows (BENCH_ARGS), every row on, with f32 and then
              bf16 nets, the counts set to 0 before and read after: each
              run's accuracy gate passed in the type asked for, every row
              of ``bench.ROWS`` present and positive, the record naming
              this card (its name and nvidia-smi line); each record is
              printed.

The timing helpers ``median_ms``, ``window_ms`` and ``queued_ms``, the
H100's memory rate and its f32 and bf16 peaks come from
``tpu_face_torch.bench``.  Its last lines are the nvidia-smi
line, a JSON line of numbers, the kernels' JSON line and {"ok": true,
"device": {...}}.  Imports nothing of JAX or of the tpu_face package.

    python3 chip_smoke.py --trace DIR

adds torch.profiler windows over three cascade calls each at 540x360
batch 64 (FaceCascade and EmbedCascade), 1080p batch 64 (f32 and bf16
nets) and 4K batch 8 to the numbers (device busy share, kernel launches
per call, the kernels that take the most device time) and writes each
full table and Chrome trace into DIR.

    python3 chip_smoke.py --sweep

adds each fused kernel's device time (``queued_ms``) at each residual
run of the BACK detector (batch 64) for every tiling that fits shared
memory (tiles a multiple of 4, and the plan's), beside the plan's pick,
and the staged kernel's device time and counts on strip_dma's grids at
each block geometry and window budget of ``STAGED_GEOMETRIES``.
"""

import argparse
import contextlib
import io
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

H100_TF32_FLOPS = 495e12        # TF32 tensor cores, f32 accumulation

KERNEL_TOL = 1e-3               # 0-255 units, before rounding
BLOCK_TOL_F32 = 1e-4            # fused block, x max(1, max|plain|)
BLOCK_TOL_BF16 = 2e-2           # bf16 BACK net, fused vs op by op, x max(1, max)
CPU_PX_TOL = 0.25               # landmarks, GPU vs CPU port, pixels
CPU_SCORE_TOL = 1e-3
# FULL's cascade: nose and irises against the ground truth rows (taken
# with the BACK detector's ROIs), the budget tests/test_rotation_e2e.py
# gives the tracked mesh and iris
FULL_GT_PX = 2.0
# bf16 nets, GPU vs CPU port: cuDNN and the CPU's convolutions round their
# bf16 outputs at other places (the detector's residual runs, on K4 on
# the card, round where the CPU's per-op sequence rounds).  The
# detection, the iris points and the nose within 1 px and the scores
# within 1e-2; the mesh in steps of the mesh net's bf16 output (1.0 in
# its 192-px input above 128, i.e. ROI / 192 px in the frame) everywhere
# within two steps and on average within one: the face ROI comes from
# the detector, which differs by a fraction of a pixel, and the whole
# mesh moves with it (tests/test_torch_bf16.py holds the CPU port to
# JAX's bf16 cascade, whose detector rounds like the CPU's, within half a
# step on average).
BF16_PX_TOL = 1.0
BF16_MESH_MEAN_STEPS = 1.0
BF16_MESH_STEPS = 2.0
BF16_SCORE_TOL = 1e-2
# ground-truth rotation tolerances (face ROI, eye ROIs), rad: f32 as
# tests/test_rotation_e2e.py; bf16 eye ROIs looser, as one bf16 step of
# the mesh output (~1 px) turns an eye corner pair ~35 px apart by ~0.03
ROT_TOL = (0.01, 0.02)
BF16_ROT_TOL = (0.01, 0.03)

# Ground truth of the rotated frames (TFLite + OpenCV reference
# transcription; the same rows as tests/test_rotation_e2e.py).
GT = {
    "man_rotp15.png": {
        "size": (540, 360), "score": 0.9412,
        "keypoints": [(219.6, 124.5), (272.5, 108.2), (254.8, 148.1),
                      (263.2, 175.5), (195.0, 147.5), (307.8, 113.7)],
        "bbox": (184.8, 80.8, 317.5, 213.6),
        "roi_rot": -0.2983, "nose": (255.63, 146.75),
        "iris": {"L": (219.20, 120.41), "R": (271.60, 105.20)},
        "eye_rots": (-0.3492, -0.4751)},
    "man_rotm15.png": {
        "size": (540, 360), "score": 0.9611,
        "keypoints": [(254.4, 105.5), (307.8, 118.5), (273.3, 147.1),
                      (267.0, 173.2), (221.4, 110.6), (335.8, 138.1)],
        "bbox": (208.0, 72.0, 347.0, 211.1),
        "roi_rot": 0.2381, "nose": (272.26, 142.97),
        "iris": {"L": (255.85, 102.66), "R": (308.64, 116.28)},
        "eye_rots": (0.4246, 0.2800)},
    "man_rotp30.png": {
        "size": (540, 360), "score": 0.9475,
        "keypoints": [(209.1, 139.0), (255.8, 109.7), (250.0, 153.4),
                      (264.2, 177.8), (188.8, 165.3), (288.7, 103.9)],
        "bbox": (178.4, 88.7, 301.1, 211.4),
        "roi_rot": -0.5612, "nose": (247.59, 151.92),
        "iris": {"L": (205.44, 135.63), "R": (252.41, 107.08)},
        "eye_rots": (-0.6559, -0.7816)},
    "man_rotm30.png": {
        "size": (540, 360), "score": 0.9284,
        "keypoints": [(274.3, 104.3), (322.7, 132.6), (280.9, 148.6),
                      (266.8, 172.2), (242.7, 99.2), (344.9, 159.5)],
        "bbox": (231.0, 82.4, 353.4, 204.7),
        "roi_rot": 0.5287, "nose": (282.63, 146.37),
        "iris": {"L": (275.97, 101.57), "R": (323.83, 128.60)},
        "eye_rots": (0.7652, 0.6119)},
    "man_closeup_rotp30.png": {
        "size": (704, 704), "score": 0.785,
        "keypoints": [(237.9, 266.0), (332.7, 208.2), (321.5, 294.5),
                      (348.8, 342.1), (198.2, 316.8), (392.5, 199.3)],
        "bbox": (181.8, 170.1, 415.6, 403.9),
        "roi_rot": -0.5473, "nose": (317.30, 291.96),
        "iris": {"L": (234.49, 260.51), "R": (326.30, 205.84)},
        "eye_rots": (-0.4764, -0.5867)},
    "russ2_rotp20.png": {
        "size": (200, 225), "score": 0.9123,
        "bbox": (56.3, 70.7, 148.6, 163.0),
        "roi_rot": -0.4737, "nose": (103.69, 125.47),
        "iris": {"L": (77.09, 106.69), "R": (113.66, 89.22)},
        "eye_rots": (-0.3145, -0.4772)},
    "russ2_rotm20.png": {
        "size": (200, 225), "score": 0.9226,
        "bbox": (57.3, 71.0, 154.3, 168.0),
        "roi_rot": 0.2164, "nose": (95.01, 124.70),
        "iris": {"L": (86.22, 93.21), "R": (125.23, 103.28)},
        "eye_rots": (0.2922, 0.1481)},
}
FRAMES_540 = ["man_rotp15.png", "man_rotm15.png", "man_rotp30.png",
              "man_rotm30.png"]


def canvas_1080p(load_image, scale=2, size=(1920, 1080)):
    """Canvas (a): man_rotp15.png upscaled ``scale`` times by repetition
    and pasted at (x 420, y 180) on a black 1920x1080 canvas; with
    ``scale=4`` and ``size=(3840, 2160)`` its 4K counterpart, pasted at
    (x 840, y 360)."""
    img = load_image(ROT / "man_rotp15.png")
    big = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    w, h = size
    canvas = np.zeros((h, w, 3), np.uint8)
    x, y = 210 * scale, 90 * scale
    canvas[y:y + big.shape[0], x:x + big.shape[1]] = big
    return canvas


def canvas_two_faces(load_image):
    """Canvas (b): man_rotp15.png at (x 50, y 232) and man_rotm30.png at
    (x 690, y 232) on a black 1280x824 canvas, just past the f32
    residency budget (the strip kernel's tier)."""
    canvas = np.zeros((824, 1280, 3), np.uint8)
    canvas[232:592, 50:590] = load_image(ROT / "man_rotp15.png")
    canvas[232:592, 690:1230] = load_image(ROT / "man_rotm30.png")
    return canvas


def canvas_grid(load_image):
    """Canvas (c): the four 540x360 rotated frames as a 2x2 grid on
    1080x720 (the resident kernel's tier)."""
    canvas = np.zeros((720, 1080, 3), np.uint8)
    for i, name in enumerate(FRAMES_540):
        r, c = divmod(i, 2)
        canvas[r * 360:(r + 1) * 360, c * 540:(c + 1) * 540] = \
            load_image(ROT / name)
    return canvas


def phase(name):
    print(f"== {name}", flush=True)


def iou(a, b):
    xmin, ymin = max(a[0], b[0]), max(a[1], b[1])
    xmax, ymax = min(a[2], b[2]), min(a[3], b[3])
    if not (xmin < xmax and ymin < ymax):
        return 0.0
    inter = (xmax - xmin) * (ymax - ymin)
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def check_gt(res, i, gt, rot_tol=ROT_TOL):
    """One frame of a CascadeResult against its ground-truth row; returns
    (bbox IoU, worst landmark error in px)."""
    w, h = gt["size"]
    assert bool(res.face_valid[i]) and bool(res.mesh_valid[i]), gt
    det = res.detection[i].cpu().numpy()
    box = (det[0, 0] * w, det[0, 1] * h, det[1, 0] * w, det[1, 1] * h)
    box_iou = iou(box, gt["bbox"])
    assert box_iou >= 0.99, (box, gt["bbox"], box_iou)
    roi_rot = float(res.face_roi[i, 4])
    assert abs(roi_rot - gt["roi_rot"]) <= rot_tol[0], (roi_rot,
                                                          gt["roi_rot"])
    eye_rots = res.eye_rois[i, :, 4].cpu().numpy()
    for e, grot in enumerate(gt["eye_rots"]):
        assert abs(eye_rots[e] - grot) <= rot_tol[1], (e, eye_rots[e], grot)
    mesh = res.mesh[i].cpu().numpy()
    iris = res.iris[i].cpu().numpy()
    pts = [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
           ((iris[0, 0, 0] * w, iris[0, 0, 1] * h), gt["iris"]["L"]),
           ((iris[1, 0, 0] * w, iris[1, 0, 1] * h), gt["iris"]["R"])]
    worst = max(max(abs(p[0] - g[0]), abs(p[1] - g[1])) for p, g in pts)
    assert worst <= 1.0, (pts, worst)
    return box_iou, worst


def check_bf16_points(det, mesh, iris, nose, roi_px):
    """bf16 card-vs-CPU differences in px ([faces, points] each; ``nose``
    [faces]; ``roi_px`` the faces' ROI sides) against the BF16 tolerances;
    returns the worst point difference."""
    px = max(float(det.max()), float(iris.max()), float(nose.max()))
    assert px <= BF16_PX_TOL, ("detection/iris/nose", px)
    steps = mesh / (roi_px[:, None] / 192.0)
    assert float(steps.mean(-1).max()) <= BF16_MESH_MEAN_STEPS, (
        "mesh mean steps", steps.mean(-1))
    assert float(steps.max()) <= BF16_MESH_STEPS, ("mesh steps",
                                                   steps.amax(-1))
    return max(px, float(mesh.max()))


def align_faces(res, ref):
    """(``res`` (a result with a face axis, on the card) with each
    frame's face slots in ``ref``'s order, the swaps): each valid slot of
    ``ref`` takes the unused slot of ``res`` whose detection box centre
    is nearest, the other slots follow in their order.  The swaps are
    the (frame, j, k) of each two valid slots j < k of ``ref`` whose
    faces ``res`` holds in the other order.  The cascade sorts faces by
    score, and two faces whose scores differ by less than the bf16 nets'
    rounding may come out in either order."""
    centre = (lambda d: d[..., :2, :].mean(-2))       # noqa: E731
    det, rdet = centre(res.detection.cpu()), centre(ref.detection)
    orders = []
    for i in range(det.shape[0]):
        free = list(range(det.shape[1]))
        order = []
        for j in range(det.shape[1]):
            if bool(ref.face_valid[i, j]):
                k = min(free, key=lambda k: float((det[i, k]
                                                   - rdet[i, j]).norm()))
            else:
                k = free[0]
            free.remove(k)
            order.append(k)
        orders.append(order)
    swaps = [(i, j, k) for i, order in enumerate(orders)
             for j in range(len(order)) for k in range(j + 1, len(order))
             if bool(ref.face_valid[i, k]) and order[j] > order[k]]
    rows = torch.arange(det.shape[0])[:, None]
    index = torch.tensor(orders)
    return type(res)(*(f.cpu()[rows, index] for f in res)), swaps


def check_against_cpu(res, ref, size, bf16=False):
    """GPU result vs the port's CPU result on the same frames: equal
    bools, and the numbers of every valid face slot, within the f32
    tolerances or, for bf16 nets, the bf16 ones; returns (worst landmark
    px, worst score difference).  Where there is a face axis the card's
    valid faces must come in non-increasing score, and f32 results are
    compared slot by slot; bf16 results are first matched to the CPU's
    by ``align_faces``, and two faces may only have swapped where their
    CPU scores differ by at most ``BF16_SCORE_TOL``."""
    if res.face_valid.dim() == 2:
        score, valid = res.score.cpu(), res.face_valid.cpu()
        assert bool(((score[:, :-1] >= score[:, 1:])
                     | ~valid[:, 1:]).all()), ("face order", score, valid)
    if bf16 and res.face_valid.dim() == 2:
        res, swaps = align_faces(res, ref)
        for i, j, k in swaps:
            gap = abs(float(ref.score[i, j] - ref.score[i, k]))
            print(f"frame {i}: the card holds CPU faces {j} and {k} "
                  f"(CPU scores {float(ref.score[i, j]):.5f}, "
                  f"{float(ref.score[i, k]):.5f}; card "
                  f"{float(res.score[i, j]):.5f}, "
                  f"{float(res.score[i, k]):.5f}) in the other order")
            assert gap <= BF16_SCORE_TOL, ("swap", i, j, k, gap)
    w, h = size
    for f in ("face_valid", "mesh_valid", "envelope_ok"):
        assert torch.equal(getattr(res, f).cpu(), getattr(ref, f)), f
    ok = ref.face_valid

    def diff(f):
        return (getattr(res, f).cpu()[ok] - getattr(ref, f)[ok]).abs()

    scale = torch.tensor([w, h, w], dtype=torch.float32)
    sc = max(float(diff(f).max()) for f in ("score", "mesh_score"))
    if bf16:
        assert sc <= BF16_SCORE_TOL, sc

        def px2(f):             # [faces, points] x/y distance in px
            d = diff(f)[..., :2] * scale[:2]
            return d.amax(-1).flatten(1)

        roi_px = (ref.face_roi[ok][..., 2:4] * scale[:2]).amax(-1)
        mesh = torch.maximum(px2("mesh"), px2("mesh_raw"))
        return check_bf16_points(px2("detection"), mesh, px2("iris"),
                                 mesh[:, 1], roi_px), sc
    px = max(float((diff(f) * scale).max())
             for f in ("mesh", "mesh_raw", "iris"))
    px = max(px, float((diff("detection") * scale[:2]).max()))
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (px, sc)
    return px, sc


def random_coords(rng, b, w, h, image_ops, faces=1, sides=(0.05, 0.7)):
    """Mesh (192x192) and iris (two 64x64, right mirrored) grids of
    random ROIs over a w x h frame, ``faces`` per frame ([b, faces, Ho,
    Wo] grids): rotation to +-45 deg, centres past the frame edge, sizes
    from ``sides[0]`` to ``sides[1]`` of the short side."""
    def rois():
        n = (b, faces)
        cx = rng.uniform(-0.1 * w, 1.1 * w, n)
        cy = rng.uniform(-0.1 * h, 1.1 * h, n)
        side = rng.uniform(*sides, n) * min(w, h)
        aspect = rng.uniform(0.8, 1.25, n)
        rot = rng.uniform(-math.pi / 4, math.pi / 4, n)
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


def stacked(coords):
    """One call's same-size grids as the staged kernel takes them, [B, n,
    ..., Ho, Wo] (the pixels in ``flat``'s order)."""
    return (torch.stack([x for x, _ in coords], 1),
            torch.stack([y for _, y in coords], 1))


def staged_stats(planes, gx, gy, copies):
    """One launch of the staged kernel on grids [B, ..., Ho, Wo] with its
    counters on: (its output, its launches, the bytes its windows' bulk
    copies moved, its blocks whose window did not hold all their taps),
    as the kernel counted them on the card."""
    stats = torch.zeros(2, dtype=torch.int64, device=planes.device)
    got, n = counted(lambda: warp.warp_bilinear_strips_staged(
        planes, gx, gy, copies, stats=stats))
    copied, over = stats.tolist()
    return got, n, copied, over


def staged_blocks(gx):
    """Blocks of the staged kernel (``warp.STAGED_BLOCK``) over grids
    [B, ..., Ho, Wo]."""
    rt, cw = warp.STAGED_BLOCK
    gh, gw = gx.shape[-2:]
    return gx[..., 0, 0].numel() * -(-gh // rt) * -(-gw // cw)


def touched_bytes(planes, xs, ys):
    """Bytes the warp must move for these coordinates: each distinct
    in-frame tap pixel read once (3 channels of the planes' type), the
    coordinates read once, the [P, 3] f32 samples written once."""
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
    return (pixels * 3 * planes.element_size() + xs.numel() * 8
            + xs.numel() * 12)


def stage_coords(cascade, frames, size):
    """The planes and the two warp calls' grids (the mesh grid, then both
    iris grids; ``flat`` makes the kernels' [B, K*P] rows of them) that
    one cascade call over ``frames`` gives its warp kernel."""
    with torch.inference_mode(), exact_f32():
        planes = cascade._prepare_frame(frames, size)
        dets, _, _ = cascade._detect_stage(planes, size)
        roi = cascade._face_roi_from_det(dets, size)
        mx, my, _ = image_ops._source_coords(roi, (192, 192), False,
                                             False)
        _, _, lroi, rroi = cascade._mesh_half(planes, roi, size)
        lx, ly, _ = image_ops._source_coords(lroi, (64, 64), True, False)
        rx, ry, _ = image_ops._source_coords(rroi, (64, 64), True, True)
    return planes, [[(mx, my)], [(lx, ly), (rx, ry)]]


def time_kernel(kernel, plain, planes, calls, coords=None):
    """A warp kernel at the main path's shapes, ``kernel(planes, *args)``
    for each ``args`` of ``calls`` (``coords``: each call's flat
    coordinates (xs, ys) [B, P], by default the calls themselves): its
    max abs error against its plain version, its time (call time from
    CUDA events over back-to-back calls, ``median_ms``, and device time,
    ``queued_ms``), the plain version's time,
    torch.nn.functional.grid_sample's call and device times on an f32
    copy of the planes (the copy is not timed), and its bound."""
    coords = calls if coords is None else coords
    err = 0.0
    for args in calls:
        err = max(err, float((kernel(planes, *args)
                              - plain(planes, *args)).abs().max()))
    assert err <= KERNEL_TOL, err
    h, w = planes.shape[2:]
    f32 = planes.float()
    grids = [torch.stack([xs * (2.0 / (w - 1)) - 1.0,
                          ys * (2.0 / (h - 1)) - 1.0], -1)[:, None]
             for xs, ys in coords]                       # [B, 1, P, 2]

    def run(fn):
        return lambda: [fn(planes, *args) for args in calls]

    def library():
        return [torch.nn.functional.grid_sample(
            f32, g, mode="bilinear", padding_mode="zeros",
            align_corners=True) for g in grids]

    kernel_ms, _ = median_ms(run(kernel), reps=50)
    plain_ms, _ = median_ms(run(plain), reps=5)
    library_ms, _ = median_ms(library, reps=20)
    kernel_dev = queued_ms(run(kernel))
    library_dev = queued_ms(library)
    del f32
    nbytes = sum(touched_bytes(planes, xs, ys) for xs, ys in coords)
    flops = sum(xs.numel() * 3 * 9 for xs, _ in coords)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": kernel_dev,
            "library_device_ms": library_dev,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_flops": flops}


def hires_batch(canvas, batch, rng):
    """A planar uint8 batch on the card built like bench.py's 1080p/4K
    rows: the canvas, then copies rolled along x by up to a tenth of the
    width, every third one mirrored."""
    width = canvas.shape[1]
    frames = [canvas]
    while len(frames) < batch:
        f = np.roll(canvas, int(rng.integers(-width // 10, width // 10)),
                    axis=1)
        if len(frames) % 3 == 1:
            f = f[:, ::-1]
        frames.append(np.ascontiguousarray(f))
    return torch.from_numpy(np.ascontiguousarray(
        np.stack(frames).transpose(0, 3, 1, 2))).cuda()


def trace_cascade(cascade, batch, out, label, calls=3, top=12):
    """torch.profiler over ``calls`` cascade calls: wall time, summed
    device kernel time, kernel launches per call and the kernels with
    the most device time.  The table and the trace go into ``out`` as
    ``<label>_kernels.txt`` and ``<label>_trace.json``."""
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
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{label}_kernels.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    prof.export_chrome_trace(str(out / f"{label}_trace.json"))
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "calls": calls, "wall_ms": wall_ms, "device_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "launches_per_call": sum(e.count for e in kernels) / calls,
        "top": [[e.key[:80], e.self_device_time_total / 1e3 / calls,
                 e.count // calls] for e in kernels[:top]]}


def launch_counts():
    """{kernels line entry: its wrapper's launch count}."""
    return {"warp_bilinear": warp.LAUNCHES,
            "warp_bilinear_strips": warp.STRIP_LAUNCHES,
            "fused_dw_pw_block_f32": fused_block.LAUNCHES,
            "fused_dw_pw_block_bf16": fused_block.BF16_LAUNCHES,
            "warp_strips_staged_fused": warp.STAGED_LAUNCHES["fused"],
            "warp_strips_staged_split": warp.STAGED_LAUNCHES["split"]}


def reset_counts():
    warp.LAUNCHES = warp.STRIP_LAUNCHES = 0
    fused_block.LAUNCHES = fused_block.BF16_LAUNCHES = 0
    warp.STAGED_LAUNCHES.update(fused=0, split=0)


def only(**launches):
    """The launch counts of a call that launched ``launches`` and no other
    kernel."""
    assert set(launches) <= set(SOURCES), launches
    return {name: launches.get(name, 0) for name in SOURCES}


def counted(fn):
    """``fn()`` and the launches of each kernel it made."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def phase_build():
    phase("build")
    t0 = time.perf_counter()
    _build.build_all(KERNELS)          # one nvcc per source, in parallel
    for name in KERNELS:
        _build.load(name)
        log = _build.BUILD_LOG[name]
        print(log["ptxas"])
        print(f"{name}: nvcc {log['seconds']:.2f} s")
    print(f"{len(KERNELS)} kernels built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(rng):
    """Each kernel against its plain version; returns the max abs errors
    {kernel: err}."""
    phase("kernel vs plain")
    errs = {name: 0.0 for name in SOURCES}

    def check(name, kernel, plain, planes, coords):
        xs, ys = flat(coords)
        got, n = counted(lambda: kernel(planes, xs, ys))
        assert n == only(**{name: 1}), (name, n)
        err = float((got - plain(planes, xs, ys)).abs().max())
        b, _, h, w = planes.shape
        print(f"{name} {str(planes.dtype)[6:]} B={b} {w}x{h} grids "
              f"{[tuple(x.shape[1:]) for x, _ in coords]}: "
              f"max abs err {err:.3g}")
        assert err <= KERNEL_TOL, (name, err)
        errs[name] = max(errs[name], err)
        return got

    def check_staged(planes, coords, gather):
        """Both staged variants against the plain version and the gather
        kernel's output ``gather`` on the same call; both must count the
        same windows.  Returns the blocks whose window was cut."""
        xs, ys = flat(coords)
        plain = warp.warp_bilinear_strips_plain(planes, xs, ys)
        gx, gy = stacked(coords)
        counts = []
        for copies in ("fused", "split"):
            name = f"warp_strips_staged_{copies}"
            got, n, copied, over = staged_stats(planes, gx, gy, copies)
            assert n == only(**{name: 1}), (name, n)
            err = float((got - plain).abs().max())
            print(f"{name} {str(planes.dtype)[6:]} grids "
                  f"{tuple(gx.shape[1:])}: max abs err {err:.3g}, "
                  f"bit-exact with the gather "
                  f"{bool(torch.equal(got, gather))}; {over} of "
                  f"{staged_blocks(gx)} blocks over the window budget, "
                  f"{copied} bytes copied (counted by the kernel)")
            assert err <= KERNEL_TOL, (name, err)
            errs[name] = max(errs[name], err)
            counts.append((copied, over))
        assert counts[0] == counts[1], counts
        return counts[0][1]

    def check_segments(planes, coords):
        """warp_bilinear_segments with each grid a segment, and
        warp_bilinear on the concatenated coordinates: both bit-exact
        with the plain version."""
        segs = [(x, y, x.shape[-1]) for x, y in coords]
        got, n = counted(lambda: warp.warp_bilinear_segments(planes, segs))
        assert n == only(warp_bilinear=1), n
        ref = warp.warp_bilinear_plain(planes, *flat(coords))
        err = float((got - ref).abs().max())
        b, _, h, w = planes.shape
        print(f"warp_bilinear_segments B={b} {w}x{h} segments "
              f"{[tuple(x.shape[1:]) for x, _ in coords]}: max abs err "
              f"{err:.3g}, bit-exact {bool(torch.equal(got, ref))}")
        assert torch.equal(got, ref), err
        flat_got = check("warp_bilinear", warp.warp_bilinear,
                         warp.warp_bilinear_plain, planes, coords)
        assert torch.equal(flat_got, ref)
        errs["warp_bilinear"] = max(errs["warp_bilinear"], err)

    for b, (w, h), faces in ((32, (540, 360), 1), (1, (1280, 720), 1),
                             (2, (64, 64), 2)):
        frames = torch.from_numpy(
            rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).cuda()
        planes = warp.make_planes(frames)
        mesh, iris = random_coords(rng, b, w, h, image_ops, faces)
        for coords in (mesh, iris, mesh + iris):
            check_segments(planes, coords)
        # a grid whose rows are not a multiple of 4, not contiguous
        check_segments(planes, [(x[..., :37, :37], y[..., :37, :37])
                                for x, y in mesh])
        # the cascade's f32 planes: one launch, each grid a segment
        _, n = counted(lambda: warp.warp_sample_multi(planes, iris))
        assert n == only(warp_bilinear=1), n
    # the strip kernel and both staged variants on the same calls; ROIs
    # of one to three times the short side overflow the staged kernel's
    # window budget, so its global-memory taps run too
    over = 0
    for b, (w, h) in ((8, (1920, 1080)), (2, (3840, 2160)), (2, (1281, 723))):
        frames = torch.from_numpy(
            rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            planes = warp.make_planes(frames, dtype=dtype)
            for faces, sides in ((1, (0.05, 0.7)), (4, (0.05, 0.7)),
                                 (1, (1.0, 3.0))):
                for coords in random_coords(rng, b, w, h, image_ops, faces,
                                            sides):
                    got = check("warp_bilinear_strips",
                                warp.warp_bilinear_strips,
                                warp.warp_bilinear_strips_plain, planes,
                                coords)
                    over += check_staged(planes, coords, got)
            del planes
    assert over > 0, "no block overflowed the staged window budget"
    # warp_sample_multi takes the strip kernel for bf16 planes
    planes = warp.make_planes(frames, dtype=torch.bfloat16)
    _, n = counted(lambda: warp.warp_sample_multi(
        planes, random_coords(rng, b, w, h, image_ops, 2)[1]))
    assert n == only(warp_bilinear_strips=1), n
    del planes, frames
    errs.update(phase_fused_blocks())
    return errs


def fused_entry(dtype):
    """The fused block's kernels line entry for activations of ``dtype``."""
    return ("fused_dw_pw_block_bf16" if dtype == torch.bfloat16
            else "fused_dw_pw_block_f32")


def back_net(fuse_blocks=True, dtype=torch.float32):
    """The BACK detector lowered on the card in ``dtype`` (its residual
    runs on the fused kernel, or op by op)."""
    return build_torch_fn(Graph(DATA_DIR / "face_detection_back.npz"),
                          resolve_device(), fuse_blocks=fuse_blocks,
                          compute_dtype=dtype)


def detector_runs(net, rng, batch):
    """The BACK detector's residual runs as ``fused_blocks`` arguments at
    ``batch``: [(label, x, weights)], x relu'd normal noise of the run's
    shape on the card, the weights the net's own."""
    cases = []
    for k, (c, h, w, layers) in enumerate(net.run_shapes):
        x = torch.from_numpy(rng.standard_normal(
            (batch, c, h, w), dtype=np.float32)).cuda().relu_()
        cases.append((f"R{k + 1} {h}x{w}x{c} L={layers}", x,
                      [getattr(net, f"run{k}_{n}")
                       for n in ("wd", "bd", "wp", "bp")]))
    return cases


def prototype_inputs(batch):
    """K3/K4's inputs, seeded as docs/experiments/fused_block_prototype.py
    :25-29 (generator 0: x [B, 128, 128, 24] normal, wd [7, 3, 3, 24] *
    0.2, wp [7, 24, 24] * 0.2, one bias [7, 24]), in the port's layout:
    x NCHW on the card, the depthwise bias zero."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, 128, 128, 24)).astype(np.float32)
    wd = (rng.normal(size=(7, 3, 3, 24)) * 0.2).astype(np.float32)
    wp = (rng.normal(size=(7, 24, 24)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(7, 24)).astype(np.float32)
    x = torch.from_numpy(x).cuda().permute(0, 3, 1, 2).contiguous()
    return x, [torch.from_numpy(wd).permute(0, 3, 1, 2).contiguous().cuda(),
               torch.zeros(7, 24).cuda(), torch.from_numpy(wp).cuda(),
               torch.from_numpy(bias).cuda()]


def bf16_ulp(v):
    """One bf16 unit in the last place at magnitude ``v`` > 0 (8 bits of
    significand)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


# max abs errors of the bf16 fused kernel that fused_dw_pw_block_bf16.cu
# replaced (the f32 template with bf16 loads and stores) on
# phase_fused_blocks' bf16 inputs, on an H100
BF16_ERR_REPLACED = {"R1": 0.5, "R2": 0.156, "R3": 0.219, "R4": 0.281,
                     "K4": 0.203}


def check_fused(label, x, weights):
    """The fused kernel against its plain version on one run (TF32 off),
    with the weights in the kernel's form made once as the lowered nets
    make them; returns the max abs error."""
    b, c, h, w = x.shape
    tile, chunks = fused_block.plan(c, h, w, weights[0].shape[0],
                                    x.element_size())
    packed = fused_block.kernel_weights(*weights, x.dtype)
    with torch.inference_mode(), exact_f32():
        got, n = counted(lambda: fused_block.fused_blocks(
            x, *weights, tiling=(tile, chunks), weights=packed))
        ref = fused_block.fused_blocks_plain(x, *weights)
    assert n == only(**{fused_entry(x.dtype): len(chunks)}), (label, n,
                                                              chunks)
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = (BLOCK_TOL_F32 * max(1.0, scale) if x.dtype == torch.float32
           else bf16_ulp(scale))
    before = ("" if x.dtype == torch.float32 else
              f"; the replaced kernel's {BF16_ERR_REPLACED[label[:2]]:.3g}")
    print(f"fused_dw_pw_block {str(x.dtype)[6:]} {label} B={b}: tile "
          f"{tile}x{tile}, layers per launch {list(chunks)}; max abs err "
          f"{err:.3g} (max |plain| {scale:.3g}, tolerance {tol:.3g}"
          f"{before})", flush=True)
    assert err <= tol, (label, err, tol)
    return err


def phase_fused_blocks():
    """The fused block against its plain version: at the BACK detector's
    four runs (batch ``BATCH["fused"]``), f32 with the f32 net's weights
    and bf16 with the bf16 net's, and f32 and bf16 at K3/K4's shape;
    returns the max abs errors of the two entry points."""
    rng = np.random.default_rng(1)
    err32 = max(check_fused(label, x, w) for label, x, w in
                detector_runs(back_net(), rng, BATCH["fused"]))
    err16 = max(check_fused(label, x.to(torch.bfloat16), w)
                for label, x, w in detector_runs(
                    back_net(dtype=torch.bfloat16), rng, BATCH["fused"]))
    x, w = prototype_inputs(BATCH["k3"])
    err32 = max(err32, check_fused("K3 128x128x24 L=7", x, w))
    err16 = max(err16, check_fused("K4 128x128x24 L=7", x.to(torch.bfloat16),
                                   w))
    return {"fused_dw_pw_block_f32": err32, "fused_dw_pw_block_bf16": err16}


def fused_bound(runs, dtype):
    """The fused kernel's bound on ``runs`` [(x, weights, packed, _)]: each
    input and packed weight read once, each output written once, against
    its operations at the card's peak for their type (bf16: all at the
    bf16 tensor-core rate; f32: the 1x1's three split-TF32 products at the
    TF32 tensor-core rate beside the rest at the f32 FMA rate, running
    together).  Returns (bound ms, "bytes" or "operations", bound ms of
    every operation at the f32 FMA rate, flops, bytes)."""
    flops = pw = 0
    for x, w, _, _ in runs:
        n = x.shape[0] * x.shape[2] * x.shape[3] * w[0].shape[0]
        flops += n * fused_block.block_flops(x.shape[1])
        pw += n * 2 * x.shape[1] ** 2
    nbytes = sum(2 * x.numel() * x.element_size()
                 + sum(t.numel() * t.element_size() for t in packed)
                 for x, _, packed, _ in runs)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    f32_ms = flops / H100_F32_FLOPS * 1e3
    if dtype == torch.bfloat16:
        ops_ms = flops / H100_BF16_FLOPS * 1e3
    else:
        ops_ms = max(3 * pw / H100_TF32_FLOPS,
                     (flops - pw) / H100_F32_FLOPS) * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", f32_ms, flops,
            nbytes)


def time_fused(cases, dtype):
    """The fused kernel over ``cases`` [(label, x, weights)], all in one
    timed call, in ``dtype``: its time, the plain version's and its bound
    (``fused_bound``)."""
    runs = [(x.to(dtype), w, fused_block.kernel_weights(*w, dtype),
             fused_block.plan(x.shape[1], x.shape[2], x.shape[3],
                              w[0].shape[0], torch.finfo(dtype).bits // 8))
            for _, x, w in cases]

    def kernel():
        for x, w, packed, tiling in runs:
            fused_block.fused_blocks(x, *w, tiling=tiling, weights=packed)

    def plain():
        for x, w, _, _ in runs:
            fused_block.fused_blocks_plain(x, *w)

    with torch.inference_mode(), exact_f32():
        kernel_ms, _ = median_ms(kernel, reps=10)
        plain_ms, _ = median_ms(plain, reps=3)
        kernel_dev = queued_ms(kernel)
    bound_ms, bound_by, f32_ms, flops, nbytes = fused_bound(runs, dtype)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "device_ms": kernel_dev, "library_device_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            **({} if dtype == torch.bfloat16 else
               {"bound_f32_fma_ms": f32_ms}),
            "bound_flops": flops, "bound_bytes": nbytes,
            "tilings": [tiling for _, _, _, tiling in runs]}


def fma_probe(x, packed, tiling):
    """The f32 run on x at ``tiling`` with the 1x1 on the FMA units: the
    library's probe-only entry point fused_dw_pw_block_f32_fma_probe (C
    = 24 or 96), chunk by chunk as ``fused_block.fused_blocks`` launches
    the path's entry point.  Counts no launch."""
    fn = _build.entry("fused_dw_pw_block", "fused_dw_pw_block_f32_fma_probe")
    b, c, h, w = x.shape
    tile, chunks = tiling
    first = 0
    for k in chunks:
        out = torch.empty_like(x)
        _build.launch(fn, x.get_device(), x.data_ptr(), out.data_ptr(),
                      packed[first].data_ptr(), b, c, h, w, k, tile)
        x = out
        first += k
    return x


def probe_f32_designs(cases):
    """K3's two designs of the 1x1 on the same runs, each at the plan's
    tiling: split TF32 on the tensor cores (the path's kernel,
    ``fused_blocks``) and register-blocked FMAs (``fma_probe``); max abs
    error against the plain version (and whether it meets BLOCK_TOL_F32)
    and device time (``queued_ms``)."""
    out = {}
    with torch.inference_mode(), exact_f32():
        for label, x, w in cases:
            b, c, h, width = x.shape
            (packed,) = fused_block.kernel_weights(*w, torch.float32)
            tiling = fused_block.plan(c, h, width, w[0].shape[0])
            ref = fused_block.fused_blocks_plain(x, *w)
            tol = BLOCK_TOL_F32 * max(1.0, float(ref.abs().max()))
            designs = {
                "tf32x3": lambda: fused_block.fused_blocks(
                    x, *w, tiling=tiling, weights=(packed,)),
                "fma": lambda: fma_probe(x, packed, tiling)}
            row = {}
            for design, run in designs.items():
                err = float((run() - ref).abs().max())
                row[design] = {"max_abs_err": err, "meets_tol": err <= tol,
                               "device_ms": queued_ms(run)}
            print(f"probe f32 1x1 {label} B={b} tiling {tiling}: "
                  + "; ".join(f"{k} {v['device_ms']:.4f} ms, err "
                              f"{v['max_abs_err']:.3g}" for k, v in
                              row.items()) + f" (tolerance {tol:.3g})",
                  flush=True)
            out[label] = dict(row, tolerance=tol)
    return out


def sweep_tilings(cases, dtype):
    """The fused kernel for ``dtype``: its device time (``queued_ms``) at
    each run for every tiling that fits shared memory (a tile that is a
    multiple of 4, up to the run's side plus 4, any layers per launch;
    and the plan's), beside the plan's pick and its modelled time."""
    out = {}
    itemsize = torch.finfo(dtype).bits // 8
    with torch.inference_mode(), exact_f32():
        for label, x, w in cases:
            x = x.to(dtype)
            _, c, h, width = x.shape
            layers = w[0].shape[0]
            packed = fused_block.kernel_weights(*w, dtype)
            pick = fused_block.plan(c, h, width, layers, itemsize)

            def fits(tile, per):
                smem = (fused_block.smem_bytes_bf16 if itemsize == 2
                        else fused_block.smem_bytes)
                return smem(c, tile, per, h, width) <= fused_block.SMEM_LIMIT

            times = {}
            for per in range(1, layers + 1):
                chunks = fused_block.split_layers(layers, per)
                tiles = set(range(4, max(h, width) + 5, 4))
                if chunks == pick[1]:
                    tiles.add(pick[0])
                for tile in sorted(t for t in tiles if fits(t, per)):
                    times[f"L{per}_t{tile}"] = queued_ms(
                        lambda: fused_block.fused_blocks(
                            x, *w, tiling=(tile, chunks), weights=packed))
            best = min(times, key=times.get)
            mine = f"L{max(pick[1])}_t{pick[0]}"
            print(f"sweep {str(dtype)[6:]} {label}: best {best} "
                  f"{times[best]:.4f} ms; plan {mine} {times[mine]:.4f} ms",
                  flush=True)
            out[label] = {"best": best, "plan": mine, "ms": times}
    return out


def segment_calls(fn):
    """``fn()`` with warp.warp_bilinear_segments watched: returns (its
    result, [(segments, whether every segment is a grid as it lies
    ([B, ..., Ho, Wo], not flattened)) for each call])."""
    real = warp.warp_bilinear_segments
    seen = []

    def spy(planes, segments):
        seen.append((len(segments), all(x.dim() >= 3 for x, _, _ in segments)))
        return real(planes, segments)

    warp.warp_bilinear_segments = spy
    try:
        return fn(), seen
    finally:
        warp.warp_bilinear_segments = real


def run_cascade(cascade, frames, launches):
    """One infer_batch on the card, checked for its kernel launches; where
    it warps f32 planes, for the mesh grid as one segment and the iris
    grids as two, read where they lie (no coordinate concatenation)."""
    (res, n), seen = segment_calls(
        lambda: counted(lambda: cascade.infer_batch(frames)))
    assert n == launches, (n, launches)
    assert seen == ([(1, True), (2, True)] if launches["warp_bilinear"]
                    else []), seen
    return res


def rotated_batches():
    """The rotated frames by size: ({size: [names]}, {size: uint8 batch
    [B, H, W, 3]})."""
    groups = {}
    for name, gt in GT.items():
        groups.setdefault(gt["size"], []).append(name)
    return groups, {size: np.stack([load_image(ROT / n) for n in names])
                    for size, names in groups.items()}


def phase_cascade(dtype=torch.float32):
    """A main path, FaceCascade(compute_dtype=dtype): returns the launches
    of each kernel in it."""
    bf16 = dtype == torch.bfloat16
    phase(f"cascade {str(dtype)[6:]}")
    groups, batches = rotated_batches()
    cascade = FaceCascade(compute_dtype=dtype)
    # the detector's residual runs: one fused launch per layer chunk of
    # the wrapper's tiling plan (for the nets' type), per infer_batch, on
    # the entry point of that type
    fused = {fused_entry(dtype): cascade._det_net.fused_launches()}
    canvases = {"a": (canvas_1080p(load_image), 1,
                      only(warp_bilinear_strips=2, **fused)),
                "b": (canvas_two_faces(load_image), 2,
                      only(warp_bilinear_strips=2, **fused)),
                "c": (canvas_grid(load_image), 4,
                      only(warp_bilinear=2, **fused))}
    if bf16:
        del canvases["b"]
    cascades = {k: FaceCascade(max_faces=k, compute_dtype=dtype)
                for _, k, _ in canvases.values() if k > 1}
    cascades[1] = cascade
    reset_counts()
    results = {size: run_cascade(cascade, batch,
                                 only(warp_bilinear=2, **fused))
               for size, batch in batches.items()}
    canvas_results = {key: run_cascade(cascades[k], img[None], n)
                      for key, (img, k, n) in canvases.items()}
    launches = launch_counts()
    print(f"launches on the main path: {launches} for {len(batches)} "
          f"rotated-frame and {len(canvases)} canvas infer_batch calls "
          f"({fused} fused-block launches planned per infer_batch)")

    cpu = {k: FaceCascade(device="cpu", max_faces=k, compute_dtype=dtype)
           for k in cascades}
    for size, names in groups.items():
        res = results[size]
        for i, name in enumerate(names):
            box_iou, px = check_gt(res, i, GT[name],
                                   BF16_ROT_TOL if bf16 else ROT_TOL)
            print(f"{name}: IoU {box_iou:.4f}, worst landmark "
                  f"{px:.3f} px vs ground truth")
        px, sc = check_against_cpu(res, cpu[1].infer_batch(batches[size]),
                                   size, bf16)
        print(f"{size[0]}x{size[1]} GPU vs CPU port: {px:.4f} px, "
              f"scores {sc:.2e}", flush=True)
    for key, (img, k, _) in canvases.items():
        res = canvas_results[key]
        assert bool(res.mesh_valid.all()), (key, res.mesh_valid)
        size = (img.shape[1], img.shape[0])
        ref = cpu[k].infer_batch(img[None])
        px, sc = check_against_cpu(res, ref, size, bf16)
        print(f"canvas ({key}) {size[0]}x{size[1]} K={k}: "
              f"{int(res.mesh_valid.sum())} valid faces; GPU vs CPU port "
              f"{px:.4f} px, scores {sc:.2e}; slot scores card "
              f"{[round(float(v), 5) for v in res.score.flatten()]}, CPU "
              f"{[round(float(v), 5) for v in ref.score.flatten()]}",
              flush=True)
    return launches


def phase_cascade_gather():
    """The f32 cascade with warp_method="gather" on the rotated frames
    (one infer_batch per geometry, the counts set to 0 before): no warp
    kernel launched (the detector's fused launches only), its results
    against the ground truth and against the kernel path's
    (FaceCascade() on the same frames) within the CPU tolerances; returns
    its launches."""
    phase("cascade gather")
    groups, batches = rotated_batches()
    gather = FaceCascade(warp_method="gather")
    kernels = FaceCascade()
    assert (gather.warp_method, kernels.warp_method) == ("gather", "pallas")
    fused = only(fused_dw_pw_block_f32=gather._det_net.fused_launches())
    reset_counts()
    results = {size: run_cascade(gather, batch, fused)
               for size, batch in batches.items()}
    launches = launch_counts()
    print(f"launches of the gather cascade: {launches} for {len(batches)} "
          f"infer_batch calls", flush=True)
    for size, names in groups.items():
        res = results[size]
        for i, name in enumerate(names):
            box_iou, px = check_gt(res, i, GT[name])
            print(f"{name} (gather): IoU {box_iou:.4f}, worst landmark "
                  f"{px:.3f} px vs ground truth")
        ref = kernels.infer_batch(batches[size])
        px, sc = check_against_cpu(res, type(ref)(*(f.cpu() for f in ref)),
                                   size)
        print(f"{size[0]}x{size[1]} gather vs kernel path: {px:.4f} px, "
              f"scores {sc:.2e}", flush=True)
    return launches


def chain(models, img, size):
    """The verify skill's chain: detection -> face ROI -> mesh -> eye
    ROIs -> left and mirrored right iris.  Returns [detection data
    (8, 2) normalized, mesh (468, 3), left contour + iris (76, 3), right
    contour + iris (76, 3)] as arrays, the detection score and the face
    ROI's long side in px."""
    det, mesh_model, iris_model = models
    faces = det.infer(img)
    assert len(faces) == 1, len(faces)
    roi = tmodels.face_detection_to_roi(faces[0], size)
    mesh = mesh_model.infer(img, roi)
    assert len(mesh) == 468
    left, right = tmodels.iris_roi_from_face_landmarks(mesh, size)
    eyes = [iris_model.infer(img, left),
            iris_model.infer(img, right, is_right_eye=True)]

    def rows(points):
        return np.array([(p.x, p.y, p.z) for p in points], np.float32)

    return ([faces[0].data, rows(mesh)]
            + [rows(e.contour + e.iris) for e in eyes], faces[0].score,
            max(roi.width * size[0], roi.height * size[1]))


def check_chain_gt(res, gt):
    """A chain's result against a ground-truth row: score within 0.01,
    bbox IoU >= 0.99, keypoints (where the row has them), nose and iris
    centres <= 1 px; returns (IoU, worst px)."""
    (det, mesh, left, right), score, _ = res
    w, h = gt["size"]
    assert abs(score - gt["score"]) < 0.01, (score, gt["score"])
    box_iou = iou((det[0, 0] * w, det[0, 1] * h, det[1, 0] * w,
                   det[1, 1] * h), gt["bbox"])
    assert box_iou >= 0.99, box_iou
    pts = [((det[2 + k, 0] * w, det[2 + k, 1] * h), g)
           for k, g in enumerate(gt.get("keypoints", []))]
    pts += [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
            ((left[71, 0] * w, left[71, 1] * h), gt["iris"]["L"]),
            ((right[71, 0] * w, right[71, 1] * h), gt["iris"]["R"])]
    worst = max(max(abs(p[0] - g[0]), abs(p[1] - g[1])) for p, g in pts)
    assert worst <= 1.0, (pts, worst)
    return box_iou, worst


def compare_chains(res, ref, size, bf16=False):
    """Card chain vs CPU chain: worst point difference in px and score
    difference, within 0.25 px (x, y, and z in x's units) / 1e-3, or for
    bf16 nets the BF16 tolerances (x and y)."""
    w, h = size
    scale = np.array([w, h, w], np.float32)
    sc = abs(res[1] - ref[1])
    if bf16:
        assert sc <= BF16_SCORE_TOL, sc
        det, mesh, left, right = (
            torch.from_numpy(np.abs(a - b)[:, :2] * scale[:2]).amax(-1)[None]
            for a, b in zip(res[0], ref[0]))
        px = check_bf16_points(det, mesh, torch.cat([left, right], 1),
                               mesh[:, 1], torch.tensor([ref[2]]))
        return px, sc
    px = max(float((np.abs(a - b) * scale[:a.shape[1]]).max())
             for a, b in zip(res[0], ref[0]))
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (px, sc)
    return px, sc


def phase_models(dtype=torch.float32):
    """The standalone models on the card with nets in ``dtype``; returns
    the launches of each kernel in this path."""
    bf16 = dtype == torch.bfloat16
    phase(f"models {str(dtype)[6:]}")
    back = tmodels.FaceDetectionModel.BACK_CAMERA
    card = (tmodels.FaceDetection(back, compute_dtype=dtype),
            tmodels.FaceLandmark(compute_dtype=dtype),
            tmodels.IrisLandmark(compute_dtype=dtype))
    cpu = (tmodels.FaceDetection(back, device="cpu", compute_dtype=dtype),
           tmodels.FaceLandmark(device="cpu", compute_dtype=dtype),
           tmodels.IrisLandmark(device="cpu", compute_dtype=dtype))
    fused = {fused_entry(dtype): card[0]._net.fused_launches()}
    frames = {name: load_image(ROT / name) for name in GT}
    canvas = canvas_1080p(load_image)
    strip_types = []
    strips = warp.warp_bilinear_strips

    def spy(planes, xs, ys):
        strip_types.append(planes.dtype)
        return strips(planes, xs, ys)

    reset_counts()
    results = {}
    for name, img in frames.items():
        size = GT[name]["size"]
        # the whole-frame detection warp is K1 too, unless the geometry
        # takes the exact two-stage letterbox (the 200x225 portraits)
        warps = 3 + (image_ops.letterbox_two_stage_params(
            size, (card[0].in_w, card[0].in_h)) is None)
        results[name], n = counted(lambda: chain(card, img, size))
        assert n == only(warp_bilinear=warps, **fused), (name, n, warps)
    if not bf16:
        warp.warp_bilinear_strips = spy
        try:
            canvas_res, n = counted(lambda: chain(card, canvas,
                                                  (1920, 1080)))
        finally:
            warp.warp_bilinear_strips = strips
        # at 1080p the detection, mesh and both iris warps take the strip
        # kernel, over f32 planes
        assert n == only(warp_bilinear_strips=4, **fused), n
        assert strip_types == [torch.float32] * 4, strip_types
    launches = launch_counts()
    print(f"launches of the standalone models: {launches} for "
          f"{len(frames)} rotated frames" + ("" if bf16 else
                                            " and canvas (a)")
          + ", 5 calls each (detection, mesh, two irises)")
    for name, img in frames.items():
        size = GT[name]["size"]
        box_iou, worst = check_chain_gt(results[name], GT[name])
        px, sc = compare_chains(results[name], chain(cpu, img, size), size,
                                bf16)
        print(f"{name}: IoU {box_iou:.4f}, worst {worst:.3f} px vs ground "
              f"truth; GPU vs CPU port {px:.4f} px, score {sc:.2e}",
              flush=True)
    if not bf16:
        px, sc = compare_chains(canvas_res,
                                chain(cpu, canvas, (1920, 1080)),
                                (1920, 1080))
        print(f"canvas (a) 1920x1080 (warps on the strip kernel, f32 "
              f"planes): GPU vs CPU port {px:.4f} px, score {sc:.2e}",
              flush=True)
    return launches


def compare_detections(res, ref, size):
    """Card detections vs the CPU port's (lists of ``Detection``): the
    same count, points within CPU_PX_TOL, scores within CPU_SCORE_TOL;
    returns (worst px, worst score difference)."""
    w, h = size
    assert len(res) == len(ref) >= 1, (len(res), len(ref))
    px = sc = 0.0
    for a, b in zip(res, ref):
        px = max(px, float((np.abs(a.data - b.data)
                            * np.array([w, h], np.float32)).max()))
        sc = max(sc, abs(a.score - b.score))
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (px, sc)
    return px, sc


def check_gt_points(res, i, gt, budget=FULL_GT_PX):
    """The nose and both iris centres of frame ``i`` of a cascade result
    against a ground-truth row, within ``budget`` px; returns the worst."""
    w, h = gt["size"]
    mesh = res.mesh[i].cpu().numpy()
    iris = res.iris[i].cpu().numpy()
    pts = [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
           ((iris[0, 0, 0] * w, iris[0, 0, 1] * h), gt["iris"]["L"]),
           ((iris[1, 0, 0] * w, iris[1, 0, 1] * h), gt["iris"]["R"])]
    worst = max(max(abs(p[0] - g[0]), abs(p[1] - g[1])) for p, g in pts)
    assert worst <= budget, (pts, worst)
    return worst


def phase_full_detectors():
    """The full-range detectors on the card: FaceDetection(FULL) and
    FaceDetection(FULL_SPARSE) on the rotated frames and canvas (c), then
    FaceCascade(FULL) on the 540p rotated batch and
    FaceCascade(FULL_SPARSE, max_faces=4) on canvas (c), the counts set to
    0 before and read after: the detectors run op by op (no fused launch),
    each whole-frame detection warp and each cascade warp stage is one
    warp_bilinear launch.  Each against the port's CPU result (f32
    tolerances), the FULL cascade's nose and irises against the ground
    truth within FULL_GT_PX; returns the launches."""
    phase("full_detectors")
    full = tmodels.FaceDetectionModel.FULL
    sparse = tmodels.FaceDetectionModel.FULL_SPARSE
    frames = {name: load_image(ROT / name) for name in GT}
    frames["canvas (c)"] = canvas_grid(load_image)
    batch = np.stack([frames[n] for n in FRAMES_540])
    card = {m: tmodels.FaceDetection(m) for m in (full, sparse)}
    cascades = {"FULL": (full, 1, batch),
                "FULL_SPARSE K=4": (sparse, 4, frames["canvas (c)"][None])}
    for m, det in card.items():
        assert det._net.runs == [], m
    reset_counts()
    found = {}
    for m, det in card.items():
        for name, img in frames.items():
            size = (img.shape[1], img.shape[0])
            # the whole-frame warp is K1 unless the geometry takes the
            # exact two-stage letterbox (the 200x225 portraits)
            warps = int(image_ops.letterbox_two_stage_params(
                size, (det.in_w, det.in_h)) is None)
            found[m, name], n = counted(lambda: det.infer(img))
            assert n == only(warp_bilinear=warps), (m, name, n)
    cards = {label: FaceCascade(m, max_faces=k)
             for label, (m, k, _) in cascades.items()}
    results = {}
    for label, (_, _, images) in cascades.items():
        results[label] = run_cascade(cards[label], images,
                                     only(warp_bilinear=2))
    launches = launch_counts()
    print(f"launches of the full-range detectors: {launches} for "
          f"{len(card) * len(frames)} FaceDetection.infer calls and "
          f"{len(cascades)} cascade calls (2 warp_bilinear each, no fused "
          f"block: the nets' bottleneck blocks are no run)", flush=True)
    for m in card:
        cpu = tmodels.FaceDetection(m, device="cpu")
        worst = [0.0, 0.0]
        for name, img in frames.items():
            px, sc = compare_detections(found[m, name], cpu.infer(img),
                                        (img.shape[1], img.shape[0]))
            worst = [max(worst[0], px), max(worst[1], sc)]
        assert len(found[m, "canvas (c)"]) == 4
        print(f"FaceDetection({m.name}) on {len(frames)} frames: GPU vs "
              f"CPU port {worst[0]:.4f} px, scores {worst[1]:.2e}")
    for label, (m, k, images) in cascades.items():
        res = results[label]
        assert bool(res.mesh_valid.all()), (label, res.mesh_valid)
        size = (images.shape[2], images.shape[1])
        ref = FaceCascade(m, device="cpu", max_faces=k).infer_batch(images)
        px, sc = check_against_cpu(res, ref, size)
        print(f"FaceCascade({label}) {size[0]}x{size[1]} "
              f"B={images.shape[0]}: GPU vs CPU port {px:.4f} px, scores "
              f"{sc:.2e}", flush=True)
    worst = max(check_gt_points(results["FULL"], i, GT[name])
                for i, name in enumerate(FRAMES_540))
    print(f"FaceCascade(FULL) 540p: nose and irises within {worst:.3f} px "
          f"of the ground truth (budget {FULL_GT_PX})", flush=True)
    return launches


def phase_mxu():
    """warp_method="mxu" on the card: the standalone chain (BACK) on the
    rotated frames but the close-up (whose 350-px mesh ROI at 0.55 rad
    overflows auto_band's 56 rows: mxu_sample clamps to the band, in JAX
    too, and the mesh's presence drops to ~2e-4) and FaceCascade on the
    540p rotated batch, each against
    the port's CPU result (f32 tolerances), the counts set to 0 before and
    read after: no warp kernel (mxu_sample is plain torch), the BACK
    detector's fused launches only; returns the launches."""
    phase("mxu")
    back = tmodels.FaceDetectionModel.BACK_CAMERA
    card = (tmodels.FaceDetection(back, warp_method="mxu"),
            tmodels.FaceLandmark(warp_method="mxu"),
            tmodels.IrisLandmark(warp_method="mxu"))
    cascade = FaceCascade(warp_method="mxu")
    fused = card[0]._net.fused_launches()
    frames = {name: load_image(ROT / name) for name in GT
              if name != "man_closeup_rotp30.png"}
    batch = np.stack([frames[n] for n in FRAMES_540])
    reset_counts()
    chains = {}
    for name, img in frames.items():
        chains[name], n = counted(lambda: chain(card, img, GT[name]["size"]))
        assert n == only(fused_dw_pw_block_f32=fused), (name, n)
    res = run_cascade(cascade, batch, only(fused_dw_pw_block_f32=fused))
    launches = launch_counts()
    print(f"launches of the mxu paths: {launches} for {len(frames)} "
          f"standalone chains and one cascade call", flush=True)
    cpu = (tmodels.FaceDetection(back, warp_method="mxu", device="cpu"),
           tmodels.FaceLandmark(warp_method="mxu", device="cpu"),
           tmodels.IrisLandmark(warp_method="mxu", device="cpu"))
    worst = [0.0, 0.0]
    for name, img in frames.items():
        size = GT[name]["size"]
        px, sc = compare_chains(chains[name], chain(cpu, img, size), size)
        worst = [max(worst[0], px), max(worst[1], sc)]
    print(f"mxu standalone chain on {len(frames)} frames: GPU vs CPU port "
          f"{worst[0]:.4f} px, scores {worst[1]:.2e}")
    px, sc = check_against_cpu(res, FaceCascade(
        warp_method="mxu", device="cpu").infer_batch(batch), (540, 360))
    print(f"mxu cascade 540x360 B=4: GPU vs CPU port {px:.4f} px, scores "
          f"{sc:.2e}", flush=True)
    return launches



# identification (EmbedCascade, FaceEmbeddings): f32 embeddings on the
# card against the port's CPU result, max abs on the unit vectors (see
# TIE).  bf16 against the card's f32 result on the same frames: every
# crop edge within one pixel (the int-truncated crop moves where the bf16
# detections differ), and the cosine against the f32 net's embedding of
# the bf16 path's own crop (the bf16 nets' rounding alone) >= 0.99, or
# >= 0.98 for a crop smaller than the net's 112-px input (the 200x225
# portraits' ~93-px faces): there the port's op-by-op bf16 net, which
# rounds after every op as un-jitted JAX does, reaches 0.99002 on the
# CPU on russ2_rotp20's crop, where un-jitted JAX's own bf16 net reaches
# 0.98982 (jitted JAX, which keeps fused elementwise chains in f32,
# 0.99725), and 0.98820 on the portraits on an H100 80GB HBM3 (700 W).
# The cosine against the f32 path's embedding, whose crop may sit a
# pixel away, is printed: a 1-px move of a portrait crop turns the demo
# graph's (synthetic) embedding to cosine 0.984.
EMBED_TOL = 1e-4
BF16_CROP_PX = 1.0
BF16_COSINE = 0.99
BF16_COSINE_UPSCALED = 0.98


# Card against CPU in f32, the crops' uint8 levels differ by one where
# the value before the rint is a tie: an axis-aligned crop of an integer
# box samples at fractions k/112 of integer pixels, so many values sit
# exactly on a half level, and each device's f32 sums (cuBLAS and the
# CPU's BLAS add a hat matmul's two taps in other orders) land a few ulps
# to either side (on an H100 80GB HBM3 at 700 W: 2,048 of 2.4 million
# values at 540p b64; the JAX package's jitted crop differs from its own
# eager one in the same way).  The sampling coordinates differ by an
# ulp here and there too (ATen's CUDA division by a scalar multiplies by
# its reciprocal), which at coordinates of hundreds of pixels moves a value
# by up to a few hundredths of a level.  One level moves the demo graph's
# embedding by about 1e-4.  So the f32 embeddings are held in parts: each
# side's crop against the same crop computed in f64 from that side's own
# sampling coordinates (equal levels away from a tie, within one at a
# tie: within TIE of a half level), the nets on the card's own crops
# (EMBED_TOL), and the recomputed crops reproduce the path's embeddings.
TIE = 1e-3                      # 0-255 units


def exact_crops(frames, boxes, device, size=112):
    """The crops' values before the rint (0-255 units), flat
    [N, size, size, 3], of host frames [B, H, W, 3] at crop boxes
    [B(, K), 4]: the f32 sampling coordinates the port computes on
    ``device``, then the hat weights and both products in f64 on the
    CPU."""
    box = torch.as_tensor(np.asarray(boxes), dtype=torch.float32,
                          device=device)
    roi = torch.stack([(box[..., 0] + box[..., 2]) / 2.0,
                       (box[..., 1] + box[..., 3]) / 2.0,
                       box[..., 2] - box[..., 0], box[..., 3] - box[..., 1],
                       torch.zeros_like(box[..., 0])], dim=-1)
    sx, sy, _ = (t.cpu() for t in image_ops._source_coords(
        roi, (size, size), False, False))
    img = torch.from_numpy(np.ascontiguousarray(frames)).double()
    if box.dim() == 3:
        img = img[:, None]
    h, w = img.shape[-3:-1]

    def hat(src, n):
        taps = torch.arange(n, dtype=torch.float64)
        return (1.0 - (taps - src.double()[..., None]).abs()).clamp(min=0)

    t1 = hat(sy[..., :, 0], h) @ img.reshape(*img.shape[:-3], h, w * 3)
    out = hat(sx[..., 0, :], w).unsqueeze(-3) @ t1.reshape(
        *t1.shape[:-1], w, 3)
    return out.reshape(-1, size, size, 3)


def face_crops(model, frames, boxes):
    """The 112x112 crops (range (0, 1)), flat [N, 112, 112, 3] on the CPU,
    that ``model`` takes of host frames [B, H, W, 3] at absolute crop boxes
    (x0, y0, x1, y1) [B, 4] or [B, K, 4], recomputed on its device with
    its path's own shapes and sampler: an EmbedCascade over its frame
    planes (``_crop``), a FaceEmbeddings as its ``_pipeline`` crops."""
    dev = model.device
    box = torch.as_tensor(np.asarray(boxes), dtype=torch.float32).to(dev)
    roi = torch.stack([(box[..., 0] + box[..., 2]) / 2.0,
                       (box[..., 1] + box[..., 3]) / 2.0,
                       box[..., 2] - box[..., 0], box[..., 3] - box[..., 1],
                       torch.zeros_like(box[..., 0])], dim=-1)
    images = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    with torch.inference_mode(), exact_f32():
        if isinstance(model, EmbedCascade):
            size = (images.shape[2], images.shape[1])
            crops = model._crop(model._prepare_frame(images, size),
                                roi if roi.dim() == 3 else roi[:, None])
        else:
            crops, _ = image_ops.warp_image_to_tensor(
                images, roi, (model.in_w, model.in_h), False, (0.0, 1.0),
                method=("separable" if model._warp == "pallas"
                        else model._warp))
    return crops.reshape(-1, *crops.shape[-3:]).cpu()


def crop_embeddings(model, crops):
    """``model``'s embedding net and L2 norm on crops [N, 112, 112, 3], on
    its device; [N, D] on the CPU."""
    net = model._embed_net if isinstance(model, EmbedCascade) else model._net
    with torch.inference_mode(), exact_f32():
        (raw,) = net(crops.to(model.device))
        return l2_normalize(raw.reshape(raw.shape[0], -1)).cpu()


def hold_f32_embeddings(card, cpu, card_emb, cpu_emb, frames, boxes,
                        valid, label):
    """The f32 embeddings [N, D] one path gave on the card (``card``, a
    model on the card) and on the CPU (``cpu``), for the N faces of host
    frames [B, H, W, 3] cropped at ``boxes`` [B(, K), 4] (the same on
    both: ``check_embed`` holds the crop boxes equal), of which ``valid``
    [N] count: the crops recomputed on the card give ``card_emb``; each
    side's crop levels equal the rint of its ``exact_crops`` away from a
    tie and lie within one of it at a tie; the CPU's net on the card's crops
    gives ``card_emb`` within EMBED_TOL.  Returns (worst embedding
    difference, levels one apart between the two sides, worst net
    difference)."""
    card_emb, cpu_emb = card_emb.cpu(), torch.as_tensor(cpu_emb).cpu()
    valid = torch.as_tensor(valid).cpu()
    crops = face_crops(card, frames, boxes)
    again = float((crop_embeddings(card, crops) - card_emb).abs().max())
    assert again <= 1e-6, (label, "the recomputed crops", again)
    sides = []
    for model, side in ((card, crops), (cpu, face_crops(cpu, frames,
                                                         boxes))):
        exact = exact_crops(frames, boxes, model.device)[valid]
        tie = ((exact - torch.floor(exact)) - 0.5).abs() <= TIE
        want = torch.round(exact)
        levels = torch.round(side[valid] * 255)
        off = (levels - want).abs()
        assert float(off.max()) <= 1 and not bool((off > 0)[~tie].any()), (
            label, float(off.max()), int((off > 0)[~tie].sum()))
        sides.append(levels)
    flips = int((sides[0] != sides[1]).sum())
    net = float((crop_embeddings(cpu, crops) - card_emb)[valid].abs().max())
    assert net <= EMBED_TOL, (label, net)
    return float((card_emb - cpu_emb)[valid].abs().max()), flips, net


def check_embed(res, ref, size, label):
    """An f32 EmbedResult on the card against the CPU port's: equal
    ``face_valid`` and, for valid faces, equal ``crop_bbox``, detection
    within CPU_PX_TOL px and scores within CPU_SCORE_TOL (the embeddings:
    ``hold_f32_embeddings``); returns (px, score) differences."""
    res = type(res)(*(f.cpu() for f in res))
    assert torch.equal(res.face_valid, ref.face_valid), label
    ok = ref.face_valid
    assert bool(ok.any()), label
    assert torch.equal(res.crop_bbox[ok], ref.crop_bbox[ok]), (
        label, res.crop_bbox[ok], ref.crop_bbox[ok])
    w, h = size
    px = float(((res.detection[ok] - ref.detection[ok]).abs()
                * torch.tensor([w, h])).max())
    sc = float((res.score[ok] - ref.score[ok]).abs().max())
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (label, px, sc)
    return px, sc


def hold_cascade_embeddings(card, cpu, res, ref, frames, label):
    """``hold_f32_embeddings`` for an EmbedCascade's results on the card
    (``res``) and the CPU (``ref``) over host frames [B, H, W, 3]."""
    d = res.embedding.shape[-1]
    return hold_f32_embeddings(
        card, cpu, res.embedding.reshape(-1, d),
        ref.embedding.reshape(-1, d), frames, res.crop_bbox.cpu(),
        ref.face_valid.reshape(-1), label)


def check_embed_bf16(res, f32, model, frames, label):
    """A bf16 EmbedResult against the card's f32 one on the same frames
    (host [B, H, W, 3]): as many valid faces per frame; each valid f32
    face matched to the valid bf16 face of its frame whose crop centre is
    nearest (bf16 scores may order near-tied faces the other way), its
    crop edges within BF16_CROP_PX; and each bf16 embedding within cosine
    BF16_COSINE (BF16_COSINE_UPSCALED for a crop smaller than 112 px) of
    ``model``'s (f32 FaceEmbeddings) embedding of the same crop.  Returns
    (worst crop px, lowest cosine against the f32 path's embedding,
    lowest cosine against the f32 net on the same crop)."""
    res, f32 = (type(r)(*(f.cpu() for f in r)) for r in (res, f32))
    if f32.face_valid.dim() == 1:           # no face axis at max_faces=1
        res, f32 = (type(r)(*(f[:, None] for f in r)) for r in (res, f32))
    assert torch.equal(res.face_valid.sum(1), f32.face_valid.sum(1)), label
    centre = (lambda c: (c[:2] + c[2:]) / 2)           # noqa: E731
    worst, lowest = 0.0, 1.0
    for i, j in torch.nonzero(f32.face_valid).tolist():
        want = f32.crop_bbox[i, j]
        k = min(torch.nonzero(res.face_valid[i]).flatten().tolist(),
                key=lambda k: float((centre(res.crop_bbox[i, k])
                                     - centre(want)).norm()))
        worst = max(worst, float((res.crop_bbox[i, k] - want).abs().max()))
        lowest = min(lowest, float((res.embedding[i, k]
                                    * f32.embedding[i, j]).sum()))
    faces = torch.nonzero(res.face_valid).tolist()
    same = torch.from_numpy(model.infer_batch(
        frames[[i for i, _ in faces]],
        [tuple(res.crop_bbox[i, k].tolist()) for i, k in faces]))
    net = 1.0
    for n, (i, k) in enumerate(faces):
        box = res.crop_bbox[i, k]
        cos = float((res.embedding[i, k] * same[n]).sum())
        side = float(min(box[2] - box[0], box[3] - box[1]))
        assert cos >= (BF16_COSINE if side >= 112 else
                       BF16_COSINE_UPSCALED), (label, i, k, side, cos)
        net = min(net, cos)
    assert worst <= BF16_CROP_PX, (label, worst)
    return worst, lowest, net


def cli_json(argv, device=None):
    """``python -m tpu_face_torch <argv>`` in a subprocess from the
    repository root (``--device`` only if given: the card by default),
    started and returned as a Popen."""
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_face_torch", *argv]
        + (["--device", device] if device else []), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_lines(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, (proc.args, err[-3000:])
    return [json.loads(line) for line in out.strip().splitlines()]


def cli_close(got, want, key=""):
    """The card CLI's JSON against the CPU run's: the same keys, equal
    flags, strings and crop boxes, scores within CPU_SCORE_TOL,
    coordinates within CPU_PX_TOL px and cosines within 1e-3 (four
    decimals of embeddings within EMBED_TOL)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (key, got, want)
        for k in want:
            cli_close(got[k], want[k], k)
    elif isinstance(want, list):
        assert len(got) == len(want), (key, got, want)
        for g, w in zip(got, want):
            cli_close(g, w, key)
    elif isinstance(want, (bool, str)) or key in ("crop_bbox", "dim"):
        assert got == want, (key, got, want)
    else:
        tol = {"score": CPU_SCORE_TOL,
               "cosine_similarity": 1e-3}.get(key, CPU_PX_TOL)
        assert abs(got - want) <= tol, (key, got, want)


def phase_embed(trace):
    """The identification path on the card, the counts set to 0 before
    and read after: EmbedCascade(BACK, the demo embedding graph) with f32
    and with bf16 nets on the rotated frames (the 540p four x16 = batch
    64, the close-up, the portraits) and on canvas (c) with max_faces=4,
    then FaceEmbeddings.infer_batch (f32, bf16) and embed_boxes of a
    FaceCascade result's meshes (f32).  Each call's launches: the BACK
    detector's fused launches (13 on the f32 kernel, 8 on the bf16 one)
    and no warp kernel (the crop is the separable hat matmuls); the
    standalone model none.  f32 against the port's CPU result
    (``check_embed``), bf16 against the card's f32 result
    (``check_embed_bf16``).  Then EmbedCascade's frames/s at 540p b64
    beside FaceCascade's, the CLI's ``identify`` and ``cascade`` on the
    card against the CPU (subprocesses), and the native JPEG loader
    against Pillow where it builds.  Returns (launches, numbers)."""
    phase("embed")
    f32, bf16 = torch.float32, torch.bfloat16
    demo = str(DATA_DIR / "demo")
    groups, batches = rotated_batches()
    b = BATCH["540p"]
    four = batches[(540, 360)]
    batches[(540, 360)] = np.tile(four, (b // 4, 1, 1, 1))
    canvas = canvas_grid(load_image)[None]
    cas = {dt: EmbedCascade(embed_model_path=demo, compute_dtype=dt)
           for dt in (f32, bf16)}
    cas4 = {dt: EmbedCascade(embed_model_path=demo, compute_dtype=dt,
                             max_faces=4) for dt in (f32, bf16)}
    fused = {dt: cas[dt]._det_net.fused_launches() for dt in (f32, bf16)}
    assert fused == {f32: 13, bf16: 8}, fused
    assert cas[f32]._embed_net.runs == [], "the embedding net has a run"
    emb = {dt: tmodels.FaceEmbeddings(demo, compute_dtype=dt)
           for dt in (f32, bf16)}
    boxes = [(207.3, 72.5, 346.9, 211.2), (184.2, 80.3, 317.9, 213.7),
             (178.4, 88.7, 301.1, 211.4), (231.6, 82.1, 353.8, 204.9)]
    # set-up, not this path: the meshes embed_boxes takes
    meshes = FaceCascade().infer_batch(four).mesh

    reset_counts()
    res = {}
    for dt in (f32, bf16):
        want = only(**{fused_entry(dt): fused[dt]})
        for size, batch in batches.items():
            res[dt, size], n = counted(
                lambda: cas[dt].infer_batch(batch))
            assert n == want, (str(dt), size, n, want)
        res[dt, "c"], n = counted(lambda: cas4[dt].infer_batch(canvas))
        assert n == want, (str(dt), "canvas (c)", n, want)
        res[dt, "infer_batch"], n = counted(
            lambda: emb[dt].infer_batch(four, boxes))
        assert n == only(), (str(dt), "infer_batch", n)
    res["embed_boxes"], n = counted(
        lambda: emb[f32].embed_boxes(four, meshes, as_numpy=False))
    assert n == only(), ("embed_boxes", n)
    launches = launch_counts()
    print(f"launches of the identification path: {launches} for "
          f"{len(batches) + 1} EmbedCascade calls per dtype ({fused[f32]} "
          f"f32 and {fused[bf16]} bf16 fused launches per call, no warp "
          f"kernel) and 3 FaceEmbeddings calls (none)", flush=True)

    cpu = EmbedCascade(embed_model_path=demo, device="cpu")
    cpu4 = EmbedCascade(embed_model_path=demo, device="cpu", max_faces=4)
    for size, names in groups.items():
        frames = four if size == (540, 360) else batches[size]
        ref = cpu.infer_batch(frames)
        rows = torch.arange(batches[size].shape[0]) % len(names)
        ref = type(ref)(*(f[rows] for f in ref))
        px, sc = check_embed(res[f32, size], ref, size, size)
        e, flips, net = hold_cascade_embeddings(
            cas[f32], cpu, res[f32, size], ref, batches[size], size)
        crop, cos, same = check_embed_bf16(res[bf16, size], res[f32, size],
                                           emb[f32], batches[size], size)
        print(f"EmbedCascade {size[0]}x{size[1]} B={len(rows)}: f32 GPU vs "
              f"CPU port {px:.4f} px, scores {sc:.2e}, embeddings {e:.2e} "
              f"({flips} crop levels one apart; the nets on the card's "
              f"crops {net:.2e}); bf16 vs f32 crops within {crop:.0f} px, "
              f"cosine >= {cos:.5f} (the f32 net on the bf16 crops: >= "
              f"{same:.5f})", flush=True)
    ref = cpu4.infer_batch(canvas)
    px, sc = check_embed(res[f32, "c"], ref, (1080, 720), "canvas (c)")
    assert int(res[f32, "c"].face_valid.sum()) == 4
    e, flips, net = hold_cascade_embeddings(cas4[f32], cpu4, res[f32, "c"],
                                            ref, canvas, "canvas (c)")
    crop, cos, same = check_embed_bf16(res[bf16, "c"], res[f32, "c"],
                                       emb[f32], canvas, "canvas (c)")
    print(f"EmbedCascade canvas (c) 1080x720 K=4: f32 GPU vs CPU port "
          f"{px:.4f} px, scores {sc:.2e}, embeddings {e:.2e} ({flips} crop "
          f"levels one apart; the nets on the card's crops {net:.2e}); "
          f"bf16 vs f32 crops within {crop:.0f} px, cosine >= {cos:.5f} "
          f"(the f32 net on the bf16 crops: >= {same:.5f})", flush=True)
    cpu_emb = tmodels.FaceEmbeddings(demo, device="cpu")
    cut = [(int(x0), int(y0), int(x0) + int(x1 - x0), int(y0) + int(y1 - y0))
           for x0, y0, x1, y1 in boxes]
    e1, f1, n1 = hold_f32_embeddings(
        emb[f32], cpu_emb, torch.from_numpy(res[f32, "infer_batch"]),
        cpu_emb.infer_batch(four, boxes), four, cut,
        torch.ones(4, dtype=torch.bool), "infer_batch")
    xy = meshes[..., :2].cpu()
    _, mesh_boxes = geometry.crop_roi_from_detection(
        torch.stack([xy.amin(-2), xy.amax(-2)], dim=-2), (540, 360),
        xp=torch)
    e2, f2, n2 = hold_f32_embeddings(
        emb[f32], cpu_emb, res["embed_boxes"],
        cpu_emb.embed_boxes(four, meshes.cpu()), four, mesh_boxes,
        torch.ones(4, dtype=torch.bool), "embed_boxes")
    cos = float((res[bf16, "infer_batch"] * res[f32, "infer_batch"])
                .sum(-1).min())
    assert cos >= BF16_COSINE, cos
    print(f"FaceEmbeddings: infer_batch GPU vs CPU port {e1:.2e} ({f1} "
          f"crop levels one apart; nets {n1:.2e}), embed_boxes of the "
          f"cascade's meshes {e2:.2e} ({f2}; {n2:.2e}); bf16 vs f32 cosine "
          f">= {cos:.5f}", flush=True)

    # the CLI on the card against the CPU, in subprocesses started
    # together
    two = [str(ROT / n) for n in FRAMES_540[:2]]
    commands = {"identify": ["identify", *two],
                "cascade": ["cascade", *two, "--pixels"]}
    procs = {(name, dev): cli_json(argv, dev)
             for name, argv in commands.items() for dev in (None, "cpu")}
    for name in commands:
        card_lines = cli_lines(procs[name, None])
        cli_close(card_lines, cli_lines(procs[name, "cpu"]))
        print(f"python -m tpu_face_torch {name} on the card: "
              f"{json.dumps(card_lines[-1])[:160]} (matches the CPU run)",
              flush=True)

    # the native JPEG loader against Pillow
    import io

    from PIL import Image
    available = native_loader.available()
    print(f"native_loader.available(): {available}", flush=True)
    if available:
        buf = io.BytesIO()
        Image.fromarray(four[0]).save(buf, format="JPEG", quality=90)
        ours = native_loader.decode_jpeg(buf.getvalue())
        pil = np.asarray(Image.open(io.BytesIO(buf.getvalue()))
                         .convert("RGB"))
        diff = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
        assert diff.mean() < 1.0 and diff.max() <= 16, (diff.mean(),
                                                        diff.max())
        print(f"native decode vs Pillow: mean {diff.mean():.4f}, max "
              f"{diff.max()} levels", flush=True)

    # frames/s at 540p b64 beside FaceCascade's, the batch on the card
    batch = torch.from_numpy(batches[(540, 360)]).cuda()
    numbers = {}
    for key, dt in (("", f32), ("_bf16", bf16)):
        want = {fused_entry(dt): fused[dt]}
        numbers[f"embed_cascade{key}_b{b}"] = {
            **throughput(cas[dt], batch, only(**want), reps=10),
            "face_cascade": throughput(FaceCascade(compute_dtype=dt), batch,
                                       only(warp_bilinear=2, **want),
                                       reps=10)}
    for key in ("", "_bf16"):
        row = numbers[f"embed_cascade{key}_b{b}"]
        print(f"EmbedCascade{key} 540x360 b{b}: "
              f"{row['frames_per_s']:.1f} frames/s beside FaceCascade's "
              f"{row['face_cascade']['frames_per_s']:.1f}", flush=True)
    if trace is not None:
        numbers[f"trace_embed_b{b}"] = trace_cascade(
            cas[f32], batch, trace, f"embed_cascade_b{b}")
    return launches, numbers


TRACK_SEQ = ["man_rotm30.png", "man_rotm15.png", "man_rotp15.png",
             "man_rotp30.png", "man_rotp15.png"]


def tracker_frames(frames, step, streams, blank=()):
    """Step ``step`` of the tracker's 540p sequence for ``streams``
    streams, stream s shifted 4*s px right, the streams in ``blank``
    black."""
    out = []
    for s in range(streams):
        f = np.roll(frames[TRACK_SEQ[step]], 4 * s, axis=1)
        out.append(np.zeros_like(f) if s in blank else f)
    return np.stack(out)


def run_tracker(card, cpu, steps, size):
    """Each ``(frames, launches)`` of ``steps`` through the card's tracker,
    checked for its launches, and through the CPU port's tracker entered
    with the card's state: the results within the f32 tolerances, the
    lock states equal.  Returns the worst (px, score) differences."""
    worst = [0.0, 0.0]
    for i, (frames, want) in enumerate(steps):
        if card._state is not None:
            cpu._state = type(card._state)(*(t.cpu() for t in card._state))
        res, n = counted(lambda: card.step(frames))
        assert n == want, (i, n, want)
        ref = cpu.step(frames)
        assert (card.tracking == cpu.tracking).all(), i
        px, sc = check_against_cpu(res, ref, size)
        worst = [max(worst[0], px), max(worst[1], sc)]
    return worst


def phase_tracker():
    """FaceTracker() (BACK, f32) on the card, the counts set to 0 before
    and read after: 8 streams of the rotated 540p sequence (TRACK_SEQ),
    stream 2 blanked at step 2; then 2 streams of canvas (a) at 1920x1080
    over three steps.  Every step's launches are checked: the full path
    (the first step) 2 warp launches and the detector's fused launches, a
    locked step 2 warp launches and no fused launch (the detector does
    not run), a repair step 4 warp launches (the tracked stages and the
    one-stream repair cascade) and the fused launches of the sub-batch's
    detector; at 1080p the warps are warp_bilinear_strips.  Each step
    against the port's CPU tracker entered with the card's state.  Then
    locked steps/s of 64 streams against FaceCascade's frames/s on the
    same frames.  Returns (launches, numbers)."""
    phase("tracker")
    frames = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    card = tracking.FaceTracker()
    fused = card.cascade._det_net.fused_launches()
    full = only(warp_bilinear=2, fused_dw_pw_block_f32=fused)
    locked = only(warp_bilinear=2)
    repair = only(warp_bilinear=4, fused_dw_pw_block_f32=fused)
    steps = [(tracker_frames(frames, i, 8, (2,) if i == 2 else ()), want)
             for i, want in enumerate((full, locked, repair, repair,
                                       locked))]
    canvas = canvas_1080p(load_image)
    hires = [(np.stack([np.roll(canvas, 8 * i + 4 * s, axis=1)
                        for s in range(2)]), want)
             for i, want in enumerate((
                 only(warp_bilinear_strips=2, fused_dw_pw_block_f32=fused),
                 only(warp_bilinear_strips=2),
                 only(warp_bilinear_strips=2)))]
    cards = (card, tracking.FaceTracker())
    reset_counts()
    cpu = tracking.FaceTracker(device="cpu")
    worst = run_tracker(card, cpu, steps, (540, 360))
    print(f"tracker 540x360 8 streams, 5 steps (full, locked, repair, "
          f"repair, locked): GPU vs CPU port {worst[0]:.4f} px, scores "
          f"{worst[1]:.2e}", flush=True)
    worst = run_tracker(cards[1], tracking.FaceTracker(device="cpu"), hires,
                        (1920, 1080))
    print(f"tracker 1920x1080 2 streams, 3 steps (full, locked, locked; "
          f"warp_bilinear_strips): GPU vs CPU port {worst[0]:.4f} px, "
          f"scores {worst[1]:.2e}", flush=True)
    launches = launch_counts()
    print(f"launches of the tracker: {launches}", flush=True)

    # locked steps of 64 streams against the cascade on the same frames
    b = BATCH["track"]
    batch = torch.from_numpy(np.tile(np.stack([frames[n] for n in
                                               FRAMES_540]),
                                     (b // 4, 1, 1, 1))).cuda()
    timed = tracking.FaceTracker()
    timed.step(batch)
    _, n = counted(lambda: timed.step(batch))
    assert n == locked and timed.tracking.all(), n
    step_ms, windows = median_ms(lambda: timed.step(batch), reps=10)
    assert timed.tracking.all()
    cascade_ms, _ = median_ms(lambda: timed.cascade(batch), reps=10)
    # the same step's stages and next ROIs without its two host reads
    roi, valid = timed._state
    with torch.inference_mode(), exact_f32():
        stages_ms, _ = median_ms(lambda: tracking.roi_from_mesh(
            timed._tracked(batch, roi, valid, (540, 360)).mesh,
            (540, 360)), reps=10)
    numbers = {f"tracker_locked_b{b}": {
        "steps_per_s": 1e3 / step_ms, "frames_per_s": b * 1e3 / step_ms,
        "ms_per_step": step_ms, "windows_ms": windows,
        "stages_ms_without_host_reads": stages_ms,
        "cascade_frames_per_s": b * 1e3 / cascade_ms,
        "cascade_ms_per_batch": cascade_ms}}
    print(f"tracker locked steps at 540x360, {b} streams: "
          f"{1e3 / step_ms:.1f} steps/s ({b * 1e3 / step_ms:.1f} frames/s; "
          f"the stages without the step's two host reads "
          f"{stages_ms:.3f} ms) against the cascade's "
          f"{b * 1e3 / cascade_ms:.1f} frames/s", flush=True)
    return launches, numbers


# ---- serving: AOT programs and batch data parallelism ------------------

AOT_DIR = ROOT / "build" / "tpu_face_torch" / "aot"
SHARD_TOL = 2e-3    # sharded vs unsharded, as tests/test_sharding.py


def close(got, want, tol, label):
    """Every field of ``got`` within ``tol`` of ``want``'s, bools equal;
    returns the largest difference."""
    worst = 0.0
    for f, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (label, f)
        if a.dtype == torch.bool:
            assert torch.equal(a, b), (label, f)
        else:
            worst = max(worst, float((a.float() - b.float()).abs().max()))
    assert worst <= tol, (label, worst)
    return worst


# the kernels line's entry of each warp operator
GRAPH_OPS = {"warp_bilinear_segments": "warp_bilinear",
             "warp_bilinear_strips": "warp_bilinear_strips"}


def graph_launches(prog):
    """The kernel launches one call of a loaded program makes, read from
    its graph: one per warp operator node, one per chunk of each fused
    run operator node (by its activations' type); and the fused nodes."""
    counts = dict.fromkeys(SOURCES, 0)
    runs = 0
    for program in prog.programs.values():
        for node in program.module.graph.nodes:
            name = str(node.target)
            if node.op != "call_function" or not name.startswith(
                    "tpu_face_torch."):
                continue
            op = name.split(".")[1]
            if op == "fused_blocks":
                runs += 1
                counts[fused_entry(node.args[0].meta["val"].dtype)] += len(
                    node.args[3])
            else:
                counts[GRAPH_OPS[op]] += 1
    return counts, runs


def aot_cascade(label, make, frames, want, runs):
    """Save ``make()``'s program at ``frames``' geometry, load it, attach
    it to a fresh ``make()`` and hold one call against the live one: within
    1e-6 with the flags equal, the same counted launches (``want``) per
    call, and its graph's operators: ``want`` launches in ``runs`` fused
    run nodes.  Returns the numbers (seconds, bytes, difference)."""
    live_obj = make()
    live, n = counted(lambda: live_obj(frames))
    assert n == want, (label, "live", n, want)
    b = frames.shape[0]
    planar = live_obj._layout == "planar"
    h, w = frames.shape[2:] if planar else frames.shape[1:3]
    t0 = time.perf_counter()
    path = aot.save(live_obj, AOT_DIR / f"{label}.aot", batch=b, height=h,
                    width=w)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = aot.load(path)
    load_s = time.perf_counter() - t0
    assert graph_launches(prog) == (want, runs), (label, graph_launches(prog))
    fresh = make()
    t0 = time.perf_counter()
    aot.attach(fresh, path)
    attach_s = time.perf_counter() - t0
    out, n = counted(lambda: fresh(frames))
    assert n == want, (label, "attached", n, want)
    diff = close(out, live, 1e-6, label)
    row = {"save_s": save_s, "load_s": load_s, "attach_s": attach_s,
           "bytes": path.stat().st_size, "max_abs_diff": diff,
           "bit_identical": diff == 0.0, "launches_per_call": {
               k: v for k, v in want.items() if v}}
    print(f"aot {label}: save {save_s:.2f} s, load {load_s:.2f} s, attach "
          f"{attach_s:.2f} s, {row['bytes'] / 1e6:.2f} MB; attached vs live "
          f"max |diff| {diff:.3g}, launches per call "
          f"{row['launches_per_call']} (graph: {runs} fused run nodes)",
          flush=True)
    return row, path


def aot_cases(frames, hires, fused):
    """{label: (constructor, frames, launches per call)} of the aot
    phases: FaceCascade f32 and bf16 at 540x360 batch 8 (``frames``), f32
    at 1920x1080 planar batch 4 (``hires``: the strip kernel) and
    EmbedCascade f32 (demo graph) at 540x360 batch 8; ``fused`` the BACK
    detector's fused launches per forward by the nets' type."""
    f32, bf16 = torch.float32, torch.bfloat16
    demo = str(DATA_DIR / "demo")
    return {
        "cascade_f32_540p_b8": (FaceCascade, frames, only(
            warp_bilinear=2, fused_dw_pw_block_f32=fused[f32])),
        "cascade_bf16_540p_b8": (
            lambda: FaceCascade(compute_dtype=bf16), frames,
            only(warp_bilinear=2, fused_dw_pw_block_bf16=fused[bf16])),
        "cascade_f32_1080p_planar_b4": (
            lambda: FaceCascade(input_layout="planar"), hires,
            only(warp_bilinear_strips=2, fused_dw_pw_block_f32=fused[f32])),
        "embed_cascade_f32_540p_b8": (
            lambda: EmbedCascade(embed_model_path=demo), frames,
            only(fused_dw_pw_block_f32=fused[f32]))}


def phase_aot():
    """The serving programs on the card, the counts set to 0 before and
    read after: FaceCascade f32 and bf16 at 540x360 batch 8, f32 at
    1920x1080 planar batch 4 (the strip kernel), EmbedCascade f32 (demo
    graph) at 540x360 batch 8, each saved (``aot.save``), loaded and
    attached to a fresh object and held against the live one
    (``aot_cascade``); then FaceTracker at 8 streams of 540x360 over three
    steps (full, locked, repair: stream 2 blanked) through an attached
    artifact against a live tracker, step by step (within 1e-6, flags,
    lock states and launches equal).  Then cold start: a fresh cascade's
    construction and first call against its construction, ``attach`` and
    first call, and ``aot.load`` alone and a first call.  Returns
    (launches, numbers, the three FaceCascade cases of ``aot_cases``,
    whose export artifacts stay in AOT_DIR for ``phase_aot_executable``)."""
    phase("aot")
    AOT_DIR.mkdir(parents=True, exist_ok=True)
    f32, bf16 = torch.float32, torch.bfloat16
    four = np.stack([load_image(ROT / n) for n in FRAMES_540])
    frames = torch.from_numpy(np.tile(four, (2, 1, 1, 1))).cuda()
    hires = hires_batch(canvas_1080p(load_image), 4, np.random.default_rng(1))
    fused = {dt: FaceCascade(compute_dtype=dt)._det_net.fused_launches()
             for dt in (f32, bf16)}
    runs = 4                    # the BACK detector's residual runs
    cases = aot_cases(frames, hires, fused)
    reset_counts()
    numbers = {}
    for label, (make, x, want) in cases.items():
        numbers[f"aot_{label}"], path = aot_cascade(label, make, x, want,
                                                    runs)
    cases.pop("embed_cascade_f32_540p_b8")
    assert (fused[f32], fused[bf16]) == (13, 8), fused

    # the tracker: full, locked and repair steps through the artifact
    track = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    steps = [(tracker_frames(track, i, 8, (2,) if i == 2 else ()), want)
             for i, want in enumerate((
                 only(warp_bilinear=2, fused_dw_pw_block_f32=fused[f32]),
                 only(warp_bilinear=2),
                 only(warp_bilinear=4, fused_dw_pw_block_f32=fused[f32])))]
    live_tracker = tracking.FaceTracker()
    t0 = time.perf_counter()
    path = aot.save(tracking.FaceTracker(), AOT_DIR / "tracker.aot",
                    batch=8, height=360, width=540)
    save_s = time.perf_counter() - t0
    attached = tracking.FaceTracker()
    t0 = time.perf_counter()
    prog = aot.attach(attached, path)
    attach_s = time.perf_counter() - t0
    # the full cascade at 8 and at the repair batch 1, the tracked stages
    assert graph_launches(prog) == (only(
        warp_bilinear=6, fused_dw_pw_block_f32=2 * fused[f32]), 2 * runs), \
        graph_launches(prog)
    worst = 0.0
    for i, (x, want) in enumerate(steps):
        live, n = counted(lambda: live_tracker.step(x))
        assert n == want, (i, "live", n, want)
        out, n = counted(lambda: attached.step(x))
        assert n == want, (i, "attached", n, want)
        worst = max(worst, close(out, live, 1e-6, f"tracker step {i}"))
        assert (attached.tracking == live_tracker.tracking).all(), i
    assert list(attached.tracking) == [True, True, False] + [True] * 5
    numbers["aot_tracker_540p_b8"] = {
        "save_s": save_s, "attach_s": attach_s,
        "bytes": path.stat().st_size, "max_abs_diff": worst,
        "programs": [q["name"] for q in prog.meta["programs"]]}
    print(f"aot tracker 540x360 8 streams: save {save_s:.2f} s, attach "
          f"{attach_s:.2f} s, {path.stat().st_size / 1e6:.2f} MB, programs "
          f"{numbers['aot_tracker_540p_b8']['programs']}; full, locked, "
          f"repair steps vs live max |diff| {worst:.3g}", flush=True)
    launches = launch_counts()
    print(f"launches of the aot path: {launches}", flush=True)

    # cold start of the f32 cascade at 540p b8 (in a warm process: the
    # kernels built, cuDNN initialised)
    path = AOT_DIR / "cascade_f32_540p_b8.aot"

    def attached():
        cascade = FaceCascade()
        aot.attach(cascade, path)
        return cascade

    cold = {}
    for key, start in (("construct_and_call", FaceCascade),
                       ("construct_attach_and_call", attached),
                       ("load_and_call", lambda: aot.load(path))):
        t0 = time.perf_counter()
        fn = start()
        with torch.inference_mode():
            fn(frames)
        torch.cuda.synchronize()
        cold[key + "_s"] = time.perf_counter() - t0
    numbers["aot_cold_start_540p_b8"] = cold
    print(f"cold start, FaceCascade f32 540x360 b8 (warm process): "
          f"{ {k: round(v, 3) for k, v in cold.items()} }", flush=True)
    return launches, numbers, cases


def host_call_ms(fn, calls=20):
    """Median host-clock ms of one call of ``fn``, the card synchronized
    before and after each (``window_ms`` over one call)."""
    fn()
    return statistics.median(window_ms(fn, 1) for _ in range(calls))


def aot_executable(label, make, frames, want, export_path):
    """Save ``make()``'s program at ``frames``' geometry as an executable
    (``kind="executable"``: an AOTInductor package compiled on the card),
    attach it to a fresh ``make()`` and hold one call against the live
    object: the same counted launches (``want``) per call, so the
    package launches the hand-written kernels; within the cascade
    contract (f32 0.25 px / 1e-3, bf16 nets the BF16_* criteria) and, on
    the rotated 540p frames, their ground truth; a call on a side stream
    equal to the default stream's.  Prints and returns the compile
    (save) and attach seconds, the bytes, the largest differences against
    live and against the export artifact at ``export_path``, and one
    call's host-to-host ms through the live object, the export and the
    executable."""
    live_obj = make()
    bf16 = live_obj.compute_dtype == torch.bfloat16
    live, n = counted(lambda: live_obj(frames))
    assert n == want, (label, "live", n, want)
    b = frames.shape[0]
    planar = live_obj._layout == "planar"
    h, w = frames.shape[2:] if planar else frames.shape[1:3]
    t0 = time.perf_counter()
    path = aot.save(live_obj, AOT_DIR / f"{label}.exe.aot", batch=b,
                    height=h, width=w, kind="executable")
    save_s = time.perf_counter() - t0
    served = make()
    t0 = time.perf_counter()
    prog = aot.attach(served, path)
    attach_s = time.perf_counter() - t0
    assert prog.meta["kind"] == "executable", prog.meta
    out, n = counted(lambda: served(frames))
    assert n == want, (label, "executable", n, want)
    px, sc = check_against_cpu(out, type(live)(*(f.cpu() for f in live)),
                               (w, h), bf16)
    if not planar:              # the rotated 540p frames, tiled
        for i in range(b):
            check_gt(out, i, GT[FRAMES_540[i % len(FRAMES_540)]],
                     BF16_ROT_TOL if bf16 else ROT_TOL)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = served(frames)
    torch.cuda.current_stream().wait_stream(side)
    close(again, out, 0.0, f"{label} side stream")
    exported = make()
    aot.attach(exported, export_path)
    vs_export = close(out, exported(frames), math.inf, f"{label} export")
    ms = {key: host_call_ms(lambda: obj(frames)) for key, obj in (
        ("live", live_obj), ("export", exported), ("executable", served))}
    row = {"save_s": save_s, "attach_s": attach_s,
           "bytes": path.stat().st_size, "vs_live_px": px,
           "vs_live_score": sc,
           "max_abs_diff_live": close(out, live, math.inf, label),
           "max_abs_diff_export": vs_export,
           "launches_per_call": {k: v for k, v in want.items() if v},
           "host_ms": ms}
    print(f"aot executable {label}: compile (save) {save_s:.2f} s, attach "
          f"{attach_s:.2f} s, {row['bytes'] / 1e6:.2f} MB; vs live "
          f"{px:.4f} px, scores {sc:.2e}, max |diff| "
          f"{row['max_abs_diff_live']:.3g} (vs export {vs_export:.3g}); "
          f"launches per call {row['launches_per_call']}; one call host to "
          f"host: live {ms['live']:.3f} ms, export {ms['export']:.3f}, "
          f"executable {ms['executable']:.3f}", flush=True)
    return row, path


def phase_aot_executable(cases, export_cold):
    """The serving programs as executables on the card, the counts set to
    0 before and read after: the three FaceCascade cases of ``aot_cases``
    (f32 and bf16 at 540x360 batch 8, f32 at 1920x1080 planar batch 4),
    each compiled, attached and held against the live object by
    ``aot_executable``; then the cold start of the f32 540x360 b8
    executable (construction, ``attach`` and a first call; ``aot.load``
    and a first call) beside the export's (``export_cold``).  Left out,
    to keep the script within half its time limit (each program compiles
    in about a minute on the card, a tracker's three in three): the
    EmbedCascade and FaceTracker executables, which
    tests/test_torch_aot_executable.py compiles and checks on the CPU
    (its ``slow`` tests).  Returns (launches, numbers)."""
    phase("aot_executable")
    numbers = {}
    reset_counts()
    paths = {}
    for label, (make, x, want) in cases.items():
        numbers[f"aot_executable_{label}"], paths[label] = aot_executable(
            label, make, x, want, AOT_DIR / f"{label}.aot")
    launches = launch_counts()
    print(f"launches of the executables' path: {launches}", flush=True)

    path = paths["cascade_f32_540p_b8"]
    frames = cases["cascade_f32_540p_b8"][1]

    def attached():
        cascade = FaceCascade()
        aot.attach(cascade, path)
        return cascade

    cold = {}
    for key, start in (("construct_attach_and_call", attached),
                       ("load_and_call", lambda: aot.load(path))):
        t0 = time.perf_counter()
        fn = start()
        with torch.inference_mode():
            fn(frames)
        torch.cuda.synchronize()
        cold[key + "_s"] = time.perf_counter() - t0
    numbers["aot_executable_cold_start_540p_b8"] = cold
    print(f"cold start, FaceCascade f32 540x360 b8 (warm process): "
          f"executable { {k: round(v, 3) for k, v in cold.items()} }, "
          f"export { {k: round(v, 3) for k, v in export_cold.items()} }",
          flush=True)
    for p in AOT_DIR.glob("*.aot"):
        p.unlink()
    return launches, numbers


def phase_sharded():
    """Batch data parallelism on the card, the counts set to 0 before and
    read after: infer_sharded of FaceCascade() over data_parallel_mesh()
    (every visible card) and over [cuda:0, cuda:0] (two shards on one
    card) on the 540x360 batch of 64, against the unsharded call (within
    2e-3, flags equal; 2 warp and the detector's fused launches per
    shard); then track_sharded of FaceTracker() over both meshes, 8
    streams over three steps (full, locked, repair: stream 2 blanked, on
    the second shard of two), against the unsharded tracker step by step.
    Then frames/s of each sharded call beside the unsharded one (host
    clock, every card synchronized).  Returns (launches, numbers)."""
    phase("sharded")
    meshes = {"visible": data_parallel_mesh(),
              "cuda0_x2": data_parallel_mesh(["cuda:0", "cuda:0"])}
    print(f"data_parallel_mesh(): {len(meshes['visible'])} device(s) "
          f"{[str(d) for d in meshes['visible']]}", flush=True)
    four = np.stack([load_image(ROT / n) for n in FRAMES_540])
    b = BATCH["540p"]
    batch = torch.from_numpy(np.tile(four, (b // 4, 1, 1, 1))).cuda()
    cascade = FaceCascade()
    fused = cascade._det_net.fused_launches()
    track = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    steps = [tracker_frames(track, i, 8, (2,) if i == 2 else ())
             for i in range(3)]
    reset_counts()
    ref = cascade(batch)
    numbers = {}
    for label, mesh in meshes.items():
        out, n = counted(lambda: infer_sharded(cascade, batch, mesh))
        assert n == only(warp_bilinear=2 * len(mesh),
                         fused_dw_pw_block_f32=fused * len(mesh)), (label, n)
        diff = close(out, ref, SHARD_TOL, f"infer_sharded {label}")
        single, sharded = tracking.FaceTracker(), tracking.FaceTracker()
        worst = 0.0
        for i, x in enumerate(steps):
            ru = single.step(x)
            rs = track_sharded(sharded, x, mesh)
            worst = max(worst, close(rs, ru, SHARD_TOL,
                                     f"track_sharded {label} step {i}"))
            assert (sharded.tracking == single.tracking).all(), (label, i)
        assert list(sharded.tracking) == [True, True, False] + [True] * 5
        numbers[f"sharded_{label}"] = {
            "devices": [str(d) for d in mesh], "max_abs_diff": diff,
            "tracker_max_abs_diff": worst}
        print(f"infer_sharded over {[str(d) for d in mesh]}: vs unsharded "
              f"max |diff| {diff:.3g}; track_sharded 3 steps (full, "
              f"locked, repair) max |diff| {worst:.3g}", flush=True)
    launches = launch_counts()
    print(f"launches of the sharded path: {launches}", flush=True)

    def host_ms(fn):
        # host clock: a call's work may span cards
        for _ in range(2):
            fn()
        return window_ms(fn, 10)

    unsharded_ms = host_ms(lambda: cascade(batch))
    for label, mesh in meshes.items():
        ms = host_ms(lambda: infer_sharded(cascade, batch, mesh))
        numbers[f"sharded_{label}"].update(
            frames_per_s=b * 1e3 / ms, ms_per_batch=ms,
            unsharded_frames_per_s=b * 1e3 / unsharded_ms)
        print(f"infer_sharded {label} 540x360 b{b}: {b * 1e3 / ms:.1f} "
              f"frames/s beside the unsharded call's "
              f"{b * 1e3 / unsharded_ms:.1f}", flush=True)
    return launches, numbers


def strip_warp_calls(planes, calls):
    """The gather strip kernel and both staged variants over ``calls``
    (a list of one warp call's grids each), as {label: a function that
    makes every call once}."""
    flats = [flat(g) for g in calls]
    stacks = [stacked(g) for g in calls]

    def staged(copies):
        return lambda: [warp.warp_bilinear_strips_staged(planes, x, y, copies)
                        for x, y in stacks]

    return {"gather": lambda: [warp.warp_bilinear_strips(planes, x, y)
                               for x, y in flats],
            "staged_fused": staged("fused"), "staged_split": staged("split")}


# A/B order: each variant twice, the first and the last turn the gather
TURNS = ("gather", "staged_fused", "staged_split", "staged_split",
         "staged_fused", "gather")


def time_in_turns(runs, reps=20):
    """{label: [median ms of each of its turns]} over ``TURNS``."""
    times = {k: [] for k in runs}
    for k in TURNS:
        times[k].append(median_ms(runs[k], reps=reps)[0])
    return times


# The staged kernel's geometries --sweep times on strip_dma's grids: (rt,
# cw) block, bytes of one window buffer; the first is the package's
STAGED_GEOMETRIES = (((8, 16), 12 * 1024), ((8, 16), 20 * 1024),
                     ((8, 32), 32 * 1024), ((16, 32), 48 * 1024))


def sweep_staged_geometry(planes, gx, gy, want):
    """Both staged variants on grids [B, ..., Ho, Wo] at each of
    ``STAGED_GEOMETRIES`` (``warp.STAGED_BLOCK`` and ``warp.STAGE_BYTES``
    set for the call, then restored): bit-exact with ``want``, their
    device time (``queued_ms``) and the kernel's counts (blocks, blocks
    over the window budget, bytes copied)."""
    out = {}
    saved = warp.STAGED_BLOCK, warp.STAGE_BYTES
    try:
        for block, budget in STAGED_GEOMETRIES:
            warp.STAGED_BLOCK, warp.STAGE_BYTES = block, budget
            row = {"blocks": staged_blocks(gx)}
            for copies in ("fused", "split"):
                got, _, copied, over = staged_stats(planes, gx, gy, copies)
                assert torch.equal(got, want), (block, budget, copies)
                row[copies] = {"device_ms": queued_ms(
                    lambda: warp.warp_bilinear_strips_staged(
                        planes, gx, gy, copies)),
                    "blocks_over_budget": over, "copied_bytes": copied}
            label = f"{block[0]}x{block[1]}_{budget // 1024}KiB"
            print(f"staged geometry {label}: " + "; ".join(
                f"{k} {row[k]['device_ms']:.4f} ms, "
                f"{row[k]['blocks_over_budget']} of {row['blocks']} blocks "
                f"over budget, {row[k]['copied_bytes']} bytes copied"
                for k in ("fused", "split")), flush=True)
            out[label] = row
    finally:
        warp.STAGED_BLOCK, warp.STAGE_BYTES = saved
    return out


def phase_strip_dma(rng, sweep=False):
    """K5's A/B, as tools/tpu_strip_dma_probe.py runs it on the TPU:
    batch 64 of 1920x1080 bf16 planes (canvas (a), each frame rolled
    along x by up to 99 px), one 192x192 mesh grid per frame from a
    seeded ROI (centre 960+-200, 540+-100, sides 350-640 px, rotation
    +-0.3 rad).  The gather strip kernel and the staged kernel with one
    fused copy and with three per-channel copies, once each with the
    counts set to 0 before (this path's launches), bit-exact with each
    other, then timed in turns; with ``sweep``, the staged kernel at
    each of ``STAGED_GEOMETRIES`` too.  Returns (launches, {entry:
    kernels line numbers}, numbers)."""
    phase("strip_dma")
    b = BATCH["strip_dma"]
    canvas = canvas_1080p(load_image)
    frames = np.stack([np.roll(canvas, int(rng.integers(-99, 99)), axis=1)
                       for _ in range(b)])
    planes = warp.make_planes(torch.from_numpy(frames).cuda(),
                              dtype=torch.bfloat16)
    rois = np.stack([np.array(
        [960 + rng.integers(-200, 200), 540 + rng.integers(-100, 100),
         rng.integers(350, 640), rng.integers(350, 640),
         rng.uniform(-0.3, 0.3)], np.float32) for _ in range(b)])
    with torch.inference_mode():
        gx, gy, _ = image_ops._source_coords(
            torch.from_numpy(rois).cuda(), (192, 192), False, False)
    grids = [(gx, gy)]
    runs = strip_warp_calls(planes, [grids])
    reset_counts()
    outs = {k: fn()[0] for k, fn in runs.items()}
    torch.cuda.synchronize()
    launches = launch_counts()
    assert launches == only(warp_bilinear_strips=1,
                            warp_strips_staged_fused=1,
                            warp_strips_staged_split=1), launches
    for k in ("staged_fused", "staged_split"):
        assert torch.equal(outs[k], outs["gather"]), k
    sx, sy = stacked(grids)
    counts = {copies: staged_stats(planes, sx, sy, copies)[2:]
              for copies in ("fused", "split")}
    assert counts["fused"] == counts["split"], counts
    copied, over = counts["fused"]
    blocks = staged_blocks(sx)
    times = time_in_turns(runs)
    xs, ys = flat(grids)

    def staged(copies):
        return lambda p, x, y: warp.warp_bilinear_strips_staged(
            p, x.view(gx.shape), y.view(gy.shape), copies)

    # the plain version's and grid_sample's times and the bound, shared
    # by both variants (the same function on the same inputs)
    base = time_kernel(staged("fused"), warp.warp_bilinear_strips_plain,
                       planes, [(xs, ys)])
    dev = {k: queued_ms(fn) for k, fn in runs.items()}
    timed = {f"warp_strips_{k}": dict(base, ms=statistics.mean(times[k]),
                                      device_ms=dev[k])
             for k in ("staged_fused", "staged_split")}
    numbers = {f"strip_dma_b{b}": {
        "grids": f"{b} x 192x192 mesh grids, 1920x1080 bf16 planes",
        "bit_exact": True, "blocks": blocks, "blocks_over_budget": over,
        "copied_bytes": copied,
        **{f"{k}_ms": v for k, v in times.items()},
        **{f"{k}_device_ms": v for k, v in dev.items()},
        "bound_ms": base["bound_ms"], "bound_bytes": base["bound_bytes"],
        "plain_ms": base["plain_ms"], "library_ms": base["library_ms"],
        "library_device_ms": base["library_device_ms"]}}
    if sweep:
        numbers[f"staged_geometry_b{b}"] = sweep_staged_geometry(
            planes, sx, sy, outs["gather"])
    g, f, sp = (statistics.mean(times[k]) for k in
                ("gather", "staged_fused", "staged_split"))
    print(f"strip_dma b{b}: gather {g:.4f} ms, staged fused copy {f:.4f} "
          f"ms, staged split copies {sp:.4f} ms (turns {times}; device "
          f"{dev}); bound "
          f"{base['bound_ms']:.4f} ms; bit-exact; {over} of {blocks} "
          f"blocks over the window budget; the windows copied {copied} "
          f"bytes (counted by the kernel), the gather's bound touches "
          f"{base['bound_bytes']}", flush=True)
    return launches, timed, numbers


def net_turns(cascade, batch, size, per_op, tol):
    """The cascade's detector net on this batch's detection input, and
    the cascade, with the residual runs op by op (``per_op``) and on the
    fused kernel, in turns (op by op, fused, fused, op by op); the two
    nets' outputs agree within ``tol`` relative to the raw outputs
    (which reach ~1e4: the score logits)."""
    fused_net = cascade._det_net
    with torch.inference_mode(), exact_f32():
        planes = cascade._prepare_frame(batch, size)
        dx, dy, _ = cascade._whole_frame_coords(size)
        det_in = image_ops._normalize_pixels(
            image_ops.separable_sample_planar(planes, dx, dy), (-1.0, 1.0),
            True)
        err = max(float((a - b_).abs().max()) / max(1.0, float(
            b_.abs().max())) for a, b_ in zip(fused_net(det_in),
                                               per_op(det_in)))
        assert err <= tol, err
        ab = {"net_ms": {"op_by_op": [], "fused": []},
              "cascade_ms": {"op_by_op": [], "fused": []},
              "fused_vs_op_by_op_max_rel_err": err}
        for label, net in (("op_by_op", per_op), ("fused", fused_net),
                           ("fused", fused_net), ("op_by_op", per_op)):
            ab["net_ms"][label].append(median_ms(lambda: net(det_in),
                                                 reps=10)[0])
            cascade._det_net = net
            ab["cascade_ms"][label].append(median_ms(lambda: cascade(batch),
                                                     reps=10)[0])
        cascade._det_net = fused_net
    return ab


def throughput(cascade, batch, launches, reps):
    """Frames/s of ``cascade`` (a FaceCascade or an EmbedCascade) on
    ``batch`` (first checked for its launches and for a valid face, with
    a valid mesh where there is one, in every frame)."""
    res, n = counted(lambda: cascade(batch))
    assert n == launches, (n, launches)
    valid = int(getattr(res, "mesh_valid", res.face_valid).sum())
    assert valid == batch.shape[0], f"{valid} of {batch.shape[0]} faces"
    ms, windows = median_ms(lambda: cascade(batch), reps=reps)
    return {"frames_per_s": batch.shape[0] * 1e3 / ms, "ms_per_batch": ms,
            "windows_ms": windows}


def launch_queue_depth():
    """How many small launches the host enqueues behind a card sleeping
    200 ms before a launch blocks (None: 4,096 did not block).  A call
    with more launches than this cannot be hidden behind a sleep, which
    is why the bench's device-only latencies replay a CUDA graph."""
    x = torch.zeros(1, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    torch.cuda._sleep(bench.sleep_cycles(200.0))
    t0 = time.perf_counter()
    depth = None
    for i in range(4096):
        x.add_(1)
        if time.perf_counter() - t0 > 0.1:      # blocked behind the sleep
            depth = i
            break
    torch.cuda.synchronize()
    return depth


def phase_numbers(rng, trace, sweep=False):
    """Throughput, stage times and the kernels' times; returns (numbers,
    {kernel: time_kernel dict})."""
    phase("numbers")
    numbers = {}
    timed = {}
    frames = np.stack([load_image(ROT / n) for n in FRAMES_540])
    size = (540, 360)
    cascade = FaceCascade()
    fused = cascade._det_net.fused_launches()
    bf16 = torch.bfloat16
    cascade16 = FaceCascade(compute_dtype=bf16)
    fused16 = cascade16._det_net.fused_launches()

    # the fused block at the main path's shapes (the BACK detector's four
    # runs at batch 64, together and one by one; the bf16 detector's in
    # bf16) and at K3/K4's shape
    # f32 (K3) and bf16 (K4) on the same runs: the same inputs and the
    # f32 detector's weights (rounded to bf16 by the bf16 kernel's form)
    cases = detector_runs(cascade._det_net, rng, BATCH["fused"])
    for dtype, key, entry in ((torch.float32, "", "fused_dw_pw_block_f32"),
                              (bf16, "_bf16", "fused_dw_pw_block_bf16")):
        timed[entry] = time_fused(cases, dtype)
        numbers[f"fused_runs{key}_b{BATCH['fused']}"] = {
            "all": timed[entry],
            **{label: time_fused([(label, x, w)], dtype)
               for label, x, w in cases}}
        if sweep:
            numbers[f"fused_sweep{key}_b{BATCH['fused']}"] = sweep_tilings(
                cases, dtype)
    # K3's two designs of the 1x1 at R1 and R4
    numbers[f"k3_probe_b{BATCH['fused']}"] = probe_f32_designs(
        [cases[0], cases[3]])
    del cases
    x, w = prototype_inputs(BATCH["k3"])
    numbers[f"fused_k3_f32_b{BATCH['k3']}"] = time_fused(
        [("K3", x, w)], torch.float32)
    numbers[f"fused_k4_bf16_b{BATCH['k3']}"] = time_fused([("K4", x, w)],
                                                          bf16)
    del x, w

    # K1 at the shapes one infer_batch of 32 540x360 frames gives it
    b = BATCH["warp_540p"]
    planes, grids = stage_coords(
        cascade,
        torch.from_numpy(np.tile(frames, (b // 4, 1, 1, 1))).cuda(), size)
    calls = [([(x, y, x.shape[-1]) for x, y in g],) for g in grids]
    timed["warp_bilinear"] = time_kernel(
        warp.warp_bilinear_segments, warp.warp_bilinear_segments_plain,
        planes, calls, [flat(g) for g in grids])
    # the same launches without the operator's dispatch: the CUDA
    # implementation called directly (the wrapper's checks skipped too)
    direct = [([x for x, _, _ in segs], [y for _, y, _ in segs],
               [w for _, _, w in segs]) for (segs,) in calls]
    timed["warp_bilinear"]["direct_ms"], _ = median_ms(
        lambda: [warp._segments_cuda(planes, *args) for args in direct],
        reps=50)
    numbers[f"warp_b{b}"] = {
        "calls": ["mesh 192x192 (1 segment)", "iris 2x64x64 (2 segments)"],
        **timed["warp_bilinear"]}

    # cascade throughput at batch 64 (the four 540p frames, x16), the
    # uint8 batch already on the card, f32 and bf16 nets
    b = BATCH["540p"]
    batch = torch.from_numpy(np.tile(frames, (b // 4, 1, 1, 1))).cuda()
    ms, windows = median_ms(lambda: cascade(batch), reps=10)
    numbers[f"cascade_b{b}"] = {"frames_per_s": b * 1e3 / ms,
                                "ms_per_batch": ms, "windows_ms": windows}
    numbers[f"cascade_bf16_b{b}"] = throughput(
        cascade16, batch,
        only(warp_bilinear=2, fused_dw_pw_block_bf16=fused16), reps=10)
    if trace is not None:
        numbers[f"trace_b{b}"] = trace_cascade(cascade, batch, trace,
                                               f"cascade_b{b}")
    numbers["launch_queue_depth"] = launch_queue_depth()

    # the BACK net and the cascade with the residual runs op by op and on
    # the fused kernel, in turns, with f32 and with bf16 nets
    numbers[f"back_net_b{b}"] = net_turns(cascade, batch, size,
                                          back_net(fuse_blocks=False),
                                          BLOCK_TOL_F32)
    numbers[f"back_net_bf16_b{b}"] = net_turns(
        cascade16, batch, size, back_net(fuse_blocks=False, dtype=bf16),
        BLOCK_TOL_BF16)

    # per-stage times at batch 64 on the stage inputs of one run
    with torch.inference_mode(), exact_f32():
        planes = cascade._prepare_frame(batch, size)
        dets, _, _ = cascade._detect_stage(planes, size)
        roi = cascade._face_roi_from_det(dets, size)
        _, _, lroi, rroi = cascade._mesh_half(planes, roi, size)
        mesh_in = torch.rand(b, 192, 192, 3, device=planes.device)
        iris_in = torch.rand(2 * b, 64, 64, 3, device=planes.device)

        def detect():
            cascade._detect_stage(cascade._prepare_frame(batch, size), size)

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
        numbers[f"stages_b{b}_ms"] = {k: median_ms(f, reps=10)[0]
                                      for k, f in stages.items()}
    del batch, planes, mesh_in, iris_in

    # the strip kernel's tiers: 1080p at batch 64 and 4K at batch 8,
    # planar input, frames built like bench.py's rows from canvas (a),
    # f32 and bf16 nets; the cascade's two strip warp calls on the gather
    # kernel and on both staged variants, in turns
    planar = FaceCascade(input_layout="planar")
    planar16 = FaceCascade(input_layout="planar", compute_dtype=bf16)
    staged_faster = []
    for label, canvas, b in (
            ("1080p", canvas_1080p(load_image), BATCH["1080p"]),
            ("4k", canvas_1080p(load_image, 4, (3840, 2160)),
             BATCH["4k"])):
        hbatch = hires_batch(canvas, b, rng)
        numbers[f"cascade_{label}_b{b}"] = throughput(
            planar, hbatch,
            only(warp_bilinear_strips=2, fused_dw_pw_block_f32=fused),
            reps=5)
        numbers[f"cascade_bf16_{label}_b{b}"] = throughput(
            planar16, hbatch,
            only(warp_bilinear_strips=2, fused_dw_pw_block_bf16=fused16),
            reps=5)
        if trace is not None:
            numbers[f"trace_{label}_b{b}"] = trace_cascade(
                planar, hbatch, trace, f"cascade_{label}_b{b}")
            if label == "1080p":
                numbers[f"trace_bf16_{label}_b{b}"] = trace_cascade(
                    planar16, hbatch, trace, f"cascade_bf16_{label}_b{b}")
        size = (canvas.shape[1], canvas.shape[0])
        planes, grids = stage_coords(planar, hbatch, size)
        if label == "1080p":
            timed["warp_bilinear_strips"] = time_kernel(
                warp.warp_bilinear_strips, warp.warp_bilinear_strips_plain,
                planes, [flat(g) for g in grids])
            numbers[f"warp_strips_1080p_b{b}"] = {
                "calls": ["mesh 192x192", "iris 2x64x64"],
                **timed["warp_bilinear_strips"]}
        turns = time_in_turns(strip_warp_calls(planes, grids))
        numbers[f"strip_warps_{label}_b{b}"] = {
            "calls": ["mesh 192x192", "iris 2x64x64"],
            **{f"{k}_ms": v for k, v in turns.items()}}
        staged_faster.append(statistics.mean(turns["staged_fused"])
                             < statistics.mean(turns["gather"]))
        print(f"cascade strip warps {label} b{b} (ms, in turns): {turns}",
              flush=True)
        del planes, grids, hbatch
    # the cascade keeps the gather kernel unless the staged one wins both
    numbers["staged_fused_faster_at_1080p_and_4k"] = all(staged_faster)

    # K=4 faces per frame: canvas (c) at batch 32
    b = BATCH["k4"]
    multi = FaceCascade(max_faces=4)
    grid = torch.from_numpy(np.stack([canvas_grid(load_image)] * b)).cuda()
    res, n = counted(lambda: multi(grid))
    assert n == only(warp_bilinear=2, fused_dw_pw_block_f32=fused), n
    faces = int(res.mesh_valid.sum())
    assert faces == 4 * b, faces
    ms, windows = median_ms(lambda: multi(grid), reps=5)
    numbers[f"multiface_k4_b{b}"] = {"faces_per_s": faces * 1e3 / ms,
                                   "ms_per_batch": ms,
                                   "windows_ms": windows}
    return numbers, timed


# python -m tpu_face_torch.bench's arguments in the bench phase: its
# rows at batch 64, short windows (every row on, hires included)
BENCH_ARGS = ["--batch", "64", "--iters", "3", "--warmup", "1",
              "--repeats", "2"]


def phase_bench(smi):
    """``tpu_face_torch.bench.main`` in this process with f32 and then
    bf16 nets (BENCH_ARGS), the counts set to 0 before and read after:
    each run's gate passed in its type, every row of ``bench.ROWS``
    present and positive (``p50_aot_b8_ms`` through an executable), the
    record naming this card.  Returns (launches, {dtype: record})."""
    phase("bench")
    records = {}
    reset_counts()
    for dtype in ("f32", "bf16"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(BENCH_ARGS + ["--dtype", dtype])
        record = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rc == 0 and record["gate_dtype"] == dtype, (rc, record)
        assert record["gate_iou"] >= bench.GATE_IOU, record
        bad = [row for row in bench.ROWS
               if not isinstance(record.get(row), (int, float))
               or not record[row] > 0]
        assert not bad, (dtype, bad, record)
        assert record["aot_kind"] == "executable", record
        assert record["device"]["kind"] == torch.cuda.get_device_name(0)
        assert record["device"]["nvidia_smi"] in smi, (record, smi)
        print(f"bench {dtype}: {json.dumps(record)}", flush=True)
        records[dtype] = record
    launches = launch_counts()
    print(f"launches of the bench: {launches}", flush=True)
    return launches, records


# batch sizes of the kernel, strip_dma and numbers phases
BATCH = {"warp_540p": 32, "540p": 64, "1080p": 64, "4k": 8, "k4": 32,
         "fused": 64, "k3": 256, "strip_dma": 64, "track": 64}
# the kernel libraries, built from tpu_face_torch/csrc/<name>.cu
KERNELS = ("warp_bilinear", "warp_bilinear_strips", "fused_dw_pw_block",
           "fused_dw_pw_block_bf16", "warp_strips_staged")
# the kernels line's entries: (source, the Pallas kernel it replaces)
SOURCES = {
    "warp_bilinear": ("tpu_face_torch/csrc/warp_bilinear.cu",
                      "tpu_face/ops/pallas_warp.py:203"),
    "warp_bilinear_strips": ("tpu_face_torch/csrc/warp_bilinear_strips.cu",
                             "tpu_face/ops/pallas_warp.py:249"),
    "fused_dw_pw_block_f32": ("tpu_face_torch/csrc/fused_dw_pw_block.cu",
                              "docs/experiments/fused_block_prototype.py:46"),
    "fused_dw_pw_block_bf16": ("tpu_face_torch/csrc/fused_dw_pw_block_bf16.cu",
                               "docs/experiments/fused_block_v2.py:74"),
    "warp_strips_staged_fused": ("tpu_face_torch/csrc/warp_strips_staged.cu",
                                 "tpu_face/ops/pallas_warp.py:249"),
    "warp_strips_staged_split": ("tpu_face_torch/csrc/warp_strips_staged.cu",
                                 "tools/tpu_strip_dma_probe.py:59"),
}


def main(argv=None):
    # the port's modules become this module's globals here, once the
    # repository is on sys.path (the helpers above use them)
    global _build, image_ops, warp, fused_block, FaceCascade, exact_f32
    global load_image, tmodels, Graph, build_torch_fn, DATA_DIR
    global resolve_device, tracking, EmbedCascade, native_loader
    global geometry, l2_normalize, aot, data_parallel_mesh, infer_sharded
    global track_sharded, bench, median_ms, queued_ms, window_ms
    global H100_BYTES_PER_S, H100_F32_FLOPS, H100_BF16_FLOPS
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace", type=Path, metavar="DIR",
                        help="profile three cascade calls per frame size "
                        "and write the kernel tables and traces into DIR")
    parser.add_argument("--sweep", action="store_true",
                        help="time the fused kernel at every tiling of "
                        "each residual run of the BACK detector")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_face_torch import models as tmodels
    from tpu_face_torch import aot, bench, resolve_device, tracking
    from tpu_face_torch.bench import (H100_BF16_FLOPS, H100_BYTES_PER_S,
                                      H100_F32_FLOPS, median_ms, queued_ms,
                                      window_ms)
    from tpu_face_torch.compiler import Graph, build_torch_fn
    from tpu_face_torch.models.face_detection import _DATA_DIR as DATA_DIR
    from tpu_face_torch.models.face_embeddings import l2_normalize
    from tpu_face_torch.ops import _build, fused_block, geometry
    from tpu_face_torch.ops import image as image_ops
    from tpu_face_torch.ops import warp
    from tpu_face_torch.parallel import (data_parallel_mesh, infer_sharded,
                                         track_sharded)
    from tpu_face_torch.pipeline import (EmbedCascade, FaceCascade,
                                         exact_f32)
    from tpu_face_torch.utils import native_loader
    from tpu_face_torch.utils.image_io import load_image

    t_start = time.perf_counter()
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    rng = np.random.default_rng(0)
    phase_build()
    errs = phase_kernels(rng)
    # the paths, each with the counts set to 0 before it and read after
    paths = {"cascade_f32": phase_cascade(),
             "cascade_bf16": phase_cascade(torch.bfloat16),
             "cascade_gather": phase_cascade_gather()}
    models = {"f32": phase_models(), "bf16": phase_models(torch.bfloat16)}
    paths["full_detectors"] = phase_full_detectors()
    paths["mxu"] = phase_mxu()
    paths["tracker"], tracker_numbers = phase_tracker()
    paths["embed"], embed_numbers = phase_embed(args.trace)
    paths["aot"], aot_numbers, aot_cascades = phase_aot()
    paths["aot_executable"], exec_numbers = phase_aot_executable(
        aot_cascades, aot_numbers["aot_cold_start_540p_b8"])
    aot_numbers.update(exec_numbers)
    paths["sharded"], sharded_numbers = phase_sharded()
    paths["strip_dma"], timed, numbers = phase_strip_dma(rng, args.sweep)
    numbers.update(tracker_numbers)
    numbers.update(embed_numbers)
    numbers.update(aot_numbers)
    numbers.update(sharded_numbers)
    more_numbers, more_timed = phase_numbers(rng, args.trace, args.sweep)
    numbers.update(more_numbers)
    timed.update(more_timed)
    paths["bench"], numbers["bench"] = phase_bench(smi)
    # the bf16 paths run the bf16 kernel and never the f32 one
    for counts in (paths["cascade_bf16"], models["bf16"]):
        assert counts["fused_dw_pw_block_f32"] == 0, counts
        assert counts["fused_dw_pw_block_bf16"] > 0, counts
    for name in ("warp_bilinear", "warp_bilinear_strips",
                 "fused_dw_pw_block_f32"):
        assert models["f32"][name] > 0, (name, models["f32"])
        assert paths["tracker"][name] > 0, (name, paths["tracker"])
    # the exported programs and the executables launch the four kernels
    # of the package's path
    for name in ("warp_bilinear", "warp_bilinear_strips",
                 "fused_dw_pw_block_f32", "fused_dw_pw_block_bf16"):
        for key in ("aot", "aot_executable"):
            assert paths[key][name] > 0, (name, key, paths[key])
    # the full-range nets have no fused run; mxu launches no warp kernel
    assert paths["full_detectors"] == only(
        warp_bilinear=paths["full_detectors"]["warp_bilinear"]), paths
    assert paths["mxu"] == only(
        fused_dw_pw_block_f32=paths["mxu"]["fused_dw_pw_block_f32"]), paths
    # identification: the detector's fused kernels only, no warp kernel
    assert paths["embed"] == only(
        fused_dw_pw_block_f32=paths["embed"]["fused_dw_pw_block_f32"],
        fused_dw_pw_block_bf16=paths["embed"]["fused_dw_pw_block_bf16"]), \
        paths
    numbers["path_launches"] = paths
    numbers["models_launches"] = models
    numbers["device"] = smi
    numbers["seconds"] = time.perf_counter() - t_start

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = timed[name]
        n = sum(counts[name] for counts in paths.values())
        assert n > 0, (name, paths)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": max(errs[name], t.get("max_abs_err", 0.0)),
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            **{k: t[k] for k in ("bound_f32_fma_ms", "direct_ms")
               if k in t}})

    print(smi)
    print(json.dumps(numbers))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
